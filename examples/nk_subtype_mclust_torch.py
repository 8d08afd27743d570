"""Figure-8-style evaluation: CITE-seq NK-subtype recovery by mixture
clustering of imputed marker transcripts.

Python port of the EVALUATION LOGIC of the reference paper's Figure 8
(the reference repository's `reproducibility/code/Figure8.R:16-40`): within the NK-cell
subset of the Stoeckius CBMC CITE-seq data, the CD56(bright)/CD16(bright)
NK subtypes are defined by a 2-component Gaussian mixture (R ``Mclust``,
G=2) over the two scaled PROTEIN levels (CITE_CD56/CITE_CD16).  The same
mixture fit on the matching raw transcripts (NCAM1/FCGR3A) fails to
reproduce that split — the markers are mostly dropped out — while the fit
on the DCA-IMPUTED transcripts recovers it; the R script quantifies
agreement with ``fisher.test`` on the 2x2 classification table.

The CBMC data is not shipped, so the metric runs on a self-contained
simulation of the SAME structure:

  1. two NK-like subtypes (CD56bright vs CD16bright) with anti-correlated
     latent abundances of the two markers, plus per-subtype background
     expression programs (the structure the denoiser infers identity from);
  2. protein counts: deep, clean NB readout (antibody capture);
  3. RNA counts: shallow NB readout with severe dropout;
  4. both modalities library-normalized/log1p/z-scaled (the Seurat
     NormalizeData/ScaleData steps, Figure8.R:11-18);
  5. GaussianMixture(n_components=2) on the 2-D scaled marker space of
     each modality (the Mclust analogue); agreement with the protein
     classification scored by accuracy (best label matching) and the
     Fisher exact test of the 2x2 table (Figure8.R:39-40).

Success criterion (the paper's): the imputed-RNA classification agrees
with the protein classification where the raw-RNA one does not —
accuracy(imputed) > accuracy(raw) and Fisher p(imputed) significant.

Usage: python examples/nk_subtype_mclust_torch.py [--cells 600] [--genes 120]
       [--epochs 100]

The PyTorch/CUDA port's version of ``examples/nk_subtype_mclust.py``: the same
evaluation through ``dca_tpu_torch.dca``, on the CUDA device by default
(``--device cpu``, or ``device="cpu"``, on the CPU).
"""

import argparse

import numpy as np


def simulate_nk_cite(n_cells=600, n_genes=120, seed=0):
    """Returns (rna (N, G), protein (N, 2), marker_cols (2,), subtype (N,)).

    Marker 0 = CD56/NCAM1 (high in subtype 0), marker 1 = CD16/FCGR3A
    (high in subtype 1) — the CD56bright/CD16bright NK split of Figure 8.
    """
    rs = np.random.RandomState(seed)
    subtype = (rs.uniform(size=n_cells) < 0.5).astype(int)

    # latent marker abundance: anti-correlated across the two subtypes
    hi = rs.lognormal(2.2, 0.35, (n_cells, 2))
    lo = rs.lognormal(0.3, 0.35, (n_cells, 2))
    lat = np.where(np.stack([subtype == 0, subtype == 1], 1), hi, lo)

    theta_p = 10.0
    prot_mu = lat * 25.0
    protein = rs.negative_binomial(
        theta_p, theta_p / (theta_p + prot_mu)
    ).astype(np.float32)

    # RNA: subtype-specific background programs + shallow dropout-heavy
    # marker transcripts
    base = rs.gamma(2.0, 1.0, size=n_genes) * 2.0
    typefac = rs.lognormal(0.0, 0.7, size=(2, n_genes))
    mu = base * typefac[subtype]
    marker_cols = rs.choice(n_genes, 2, replace=False)
    mu[:, marker_cols] = lat * 0.2
    depth = rs.lognormal(0.0, 0.3, size=(n_cells, 1))
    mu = mu * depth
    theta = 2.0
    rna = rs.negative_binomial(theta, theta / (theta + mu)).astype(np.float32)
    drop = rs.uniform(size=rna.shape) < np.exp(-2.0 * mu)
    rna = np.where(drop, 0.0, rna).astype(np.float32)
    rna[:, rna.sum(0) == 0] += 1.0
    rna[rna.sum(1) == 0, 0] += 1.0
    return rna, protein, marker_cols, subtype


def _normalize_scale(X):
    """Seurat NormalizeData (library-size, log1p) + ScaleData (z-score) —
    Figure8.R:11-18."""
    X = np.asarray(X, np.float64)
    lib = X.sum(axis=1, keepdims=True)
    lib[lib == 0] = 1.0
    X = np.log1p(X / lib * np.median(lib))
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd[sd == 0] = 1.0
    return (X - mu) / sd


def _mclust2(xy, seed=0):
    """Mclust(G=2) analogue: 2-component full-covariance GaussianMixture
    classification over the 2-D scaled marker space (Figure8.R:28-37)."""
    from sklearn.mixture import GaussianMixture

    gm = GaussianMixture(n_components=2, covariance_type="full",
                         n_init=5, random_state=seed)
    return gm.fit_predict(np.asarray(xy))


def _agreement(a, b):
    """Best-matching accuracy between two 2-class labelings, plus the
    Fisher exact p of their 2x2 table (Figure8.R:39-40)."""
    from scipy.stats import fisher_exact

    a = np.asarray(a).astype(bool)
    b = np.asarray(b).astype(bool)
    acc = max(np.mean(a == b), np.mean(a == ~b))
    table = [[np.sum(a & b), np.sum(a & ~b)],
             [np.sum(~a & b), np.sum(~a & ~b)]]
    return acc, fisher_exact(table).pvalue


def run_evaluation(n_cells=600, n_genes=120, epochs=100, seed=0,
                   verbose=True, device=None):
    """Returns (acc_orig, p_orig, acc_dca, p_dca) — agreement of the
    raw-RNA and imputed-RNA mixture classifications with the PROTEIN one."""
    from dca_tpu_torch import dca
    from dca_tpu_torch.data.adata import AnnData

    rna, protein, marker_cols, _ = simulate_nk_cite(n_cells, n_genes, seed)
    ad = dca(AnnData(rna.copy()), mode="denoise", epochs=epochs, copy=True,
             verbose=False, device=device)
    denoised = np.asarray(ad.X)

    cls_prot = _mclust2(_normalize_scale(protein), seed)
    cls_orig = _mclust2(_normalize_scale(rna)[:, marker_cols], seed)
    cls_dca = _mclust2(_normalize_scale(denoised)[:, marker_cols], seed)

    acc_o, p_o = _agreement(cls_prot, cls_orig)
    acc_d, p_d = _agreement(cls_prot, cls_dca)
    if verbose:
        print("NK-subtype mixture classification vs protein (Figure8.R):")
        print(f"  original RNA: accuracy {acc_o:.3f}  fisher p {p_o:.2e}")
        print(f"  imputed RNA:  accuracy {acc_d:.3f}  fisher p {p_d:.2e}")
    return acc_o, p_o, acc_d, p_d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=600)
    ap.add_argument("--genes", type=int, default=120)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    run_evaluation(args.cells, args.genes, args.epochs, device=args.device)


if __name__ == "__main__":
    main()
