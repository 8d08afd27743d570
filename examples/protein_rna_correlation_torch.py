"""Figure-6-style evaluation: paired-modality (CITE-seq) protein/RNA
correlation recovery.

Python port of the EVALUATION LOGIC of the reference paper's Figure 6
(the reference repository's `reproducibility/code/Figure6.R:66-75`): on the Stoeckius
CBMC CITE-seq dataset, each of 8 surface proteins has a matched mRNA; the
per-marker Spearman correlation between scaled RNA and scaled protein
(``diag(cor(t(rna), t(protein), method="spearman"))``) quantifies how well
the transcript tracks its protein — dropout destroys it, denoising should
recover it.  The CBMC dataset is not shipped, so the metric runs on a
self-contained simulation:

  1. each cell carries a latent abundance per marker (log-normal mixture
     over simulated cell types — some types express the marker, some not);
  2. protein counts: deep NB readout of the latent abundance (CITE-seq
     antibody capture is nearly dropout-free);
  3. RNA counts: a near-silent NB readout with severe ZINB dropout,
     embedded in a gene panel whose background genes carry per-type
     expression programs (the structure the denoiser infers identity from);
  4. both modalities are library-normalized, log1p'd and z-scaled (the
     Seurat NormalizeData/ScaleData steps, Figure6.R:20-43);
  5. report the per-marker Spearman correlations for original vs
     DCA-denoised RNA (Figure6.R:67-71 — the panel-D boxplot).

Success criterion (the paper's): median Spearman(denoised) >
median Spearman(original).

Usage: python examples/protein_rna_correlation_torch.py [--cells 600]
       [--genes 120] [--markers 8] [--epochs 100]

The PyTorch/CUDA port's version of ``examples/protein_rna_correlation.py``: the same
evaluation through ``dca_tpu_torch.dca``, on the CUDA device by default
(``--device cpu``, or ``device="cpu"``, on the CPU).
"""

import argparse

import numpy as np


def simulate_cite_seq(n_cells=600, n_genes=120, n_markers=8, seed=0):
    """Returns (rna_counts (N, G), protein_counts (N, M), marker_cols).

    The background genes carry per-TYPE expression programs (as real cell
    types do): that is the structure the autoencoder infers cell identity
    from, letting it impute the near-silent marker transcripts — exactly
    how DCA recovers CD3E etc. on CBMC.  Marker RNA is very shallow with
    severe dropout (~70% marker zeros at the defaults; raw per-marker
    Spearman ~0.44 vs ~0.59 denoised)."""
    rs = np.random.RandomState(seed)
    n_types = 4
    types = rs.randint(0, n_types, size=n_cells)
    # marker latent abundance: per (type, marker) on/off plus cell noise
    on = rs.uniform(size=(n_types, n_markers)) < 0.5
    lat = np.where(on[types], rs.lognormal(2.0, 0.4, (n_cells, n_markers)),
                   rs.lognormal(0.0, 0.4, (n_cells, n_markers)))

    # protein: deep, clean NB readout
    theta_p = 10.0
    prot_mu = lat * 20.0
    protein = rs.negative_binomial(
        theta_p, theta_p / (theta_p + prot_mu)
    ).astype(np.float32)

    # RNA: per-type background programs + near-silent markers, heavy dropout
    base = rs.gamma(2.0, 1.0, size=n_genes) * 2.0
    typefac = rs.lognormal(0.0, 0.8, size=(n_types, n_genes))
    mu = base * typefac[types]
    marker_cols = rs.choice(n_genes, n_markers, replace=False)
    mu[:, marker_cols] = lat * 0.15
    depth = rs.lognormal(0.0, 0.3, size=(n_cells, 1))
    mu = mu * depth
    theta = 2.0
    rna = rs.negative_binomial(theta, theta / (theta + mu)).astype(np.float32)
    drop = rs.uniform(size=rna.shape) < np.exp(-3.0 * mu)
    rna = np.where(drop, 0.0, rna).astype(np.float32)
    rna[:, rna.sum(0) == 0] += 1.0
    rna[rna.sum(1) == 0, 0] += 1.0
    return rna, protein, marker_cols


def _normalize_scale(X):
    """Seurat NormalizeData (library-size to median, log1p) + ScaleData
    (per-feature z-score) — Figure6.R:20-43."""
    X = np.asarray(X, np.float64)
    lib = X.sum(axis=1, keepdims=True)
    lib[lib == 0] = 1.0
    X = np.log1p(X / lib * np.median(lib))
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd[sd == 0] = 1.0
    return (X - mu) / sd


def marker_spearman(rna, protein, marker_cols):
    """diag of the per-marker Spearman correlation matrix
    (Figure6.R:67-71)."""
    from scipy.stats import spearmanr

    rna_s = _normalize_scale(rna)[:, marker_cols]
    prot_s = _normalize_scale(protein)
    return np.array([
        spearmanr(rna_s[:, j], prot_s[:, j]).statistic
        for j in range(prot_s.shape[1])
    ])


def run_evaluation(n_cells=600, n_genes=120, n_markers=8, epochs=100,
                   seed=0, verbose=True, device=None):
    """Returns (spearman_original (M,), spearman_denoised (M,))."""
    from dca_tpu_torch import dca
    from dca_tpu_torch.data.adata import AnnData

    rna, protein, marker_cols = simulate_cite_seq(
        n_cells, n_genes, n_markers, seed
    )
    ad = dca(AnnData(rna.copy()), mode="denoise", epochs=epochs, copy=True,
             verbose=False, device=device)
    denoised = np.asarray(ad.X)

    r_orig = marker_spearman(rna, protein, marker_cols)
    r_dca = marker_spearman(denoised, protein, marker_cols)
    if verbose:
        print("per-marker Spearman(RNA, protein) (Figure6.R:67-71):")
        print(f"  original:  median {np.median(r_orig):.3f}  "
              f"{np.round(r_orig, 3)}")
        print(f"  denoised:  median {np.median(r_dca):.3f}  "
              f"{np.round(r_dca, 3)}")
    return r_orig, r_dca


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=600)
    ap.add_argument("--genes", type=int, default=120)
    ap.add_argument("--markers", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    run_evaluation(args.cells, args.genes, args.markers, args.epochs, device=args.device)


if __name__ == "__main__":
    main()
