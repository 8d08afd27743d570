"""Figure-9-style evaluation: denoising a branching differentiation
trajectory (the Paul15 blood-differentiation workflow).

Python port of the EVALUATION LOGIC of the reference paper's Figure 9
(the reference repository's `reproducibility/code/Figure9.ipynb` cells 3-20): on the
Paul et al. myeloid progenitor data, diffusion pseudotime orders cells
along the MEP (erythroid, Gata1-driven) and GMP (myeloid, Pu.1-driven)
branches; after DCA denoising

  * the Gata1/Pu.1 ANTI-correlation across branch cells — masked by
    dropout in the raw counts — becomes strongly negative (cells 13, 18);
  * within-lineage marker-module correlations sharpen (the Krumsiek gene
    heatmap, cell 15);
  * cells with BOTH Pu.1 and Gata1 at zero in the raw counts get imputed
    values that still carry the anti-correlation (cell 20);
  * the diffusion-pseudotime workflow itself runs on the denoised matrix
    (cells 9-12) — here scored as Spearman agreement of a diffusion-map
    pseudotime with the simulation's true time.

Paul15 is a download (sc.datasets.paul15, no egress here), so the metrics
run on a self-contained two-branch differentiation simulation: a common
progenitor stage splits into two branches whose master regulators (the
Gata1/Pu.1 analogues) rise mutually exclusively, each dragging a
correlated marker module (the Krumsiek groups); NB counts with severe
dropout on top.  The diffusion map is the standard kernel construction
(Gaussian kNN kernel -> row-normalized transition matrix -> leading
non-trivial eigenvectors), pseudotime = diffusion distance from the
youngest cell — sc.tl.dpt's core recipe without the scanpy dependency.

Usage: python examples/pseudotime_branching_torch.py [--cells 600] [--genes 120]
       [--epochs 150]

The PyTorch/CUDA port's version of ``examples/pseudotime_branching.py``: the same
evaluation through ``dca_tpu_torch.dca``, on the CUDA device by default
(``--device cpu``, or ``device="cpu"``, on the CPU).
"""

import argparse

import numpy as np


MODULE = 5  # genes per lineage module (the Krumsiek groups, cell 15)


def simulate_branching(n_cells=600, n_genes=120, seed=0):
    """Two-branch differentiation counts.

    Returns (counts (N, G), true_time (N,), branch (N,), g1, g2, mod1,
    mod2): g1/g2 are the master-regulator columns (Gata1/Pu.1 analogues),
    mod1/mod2 their correlated marker modules."""
    rs = np.random.RandomState(seed)
    t = rs.uniform(0.0, 1.0, n_cells)
    branch = (rs.uniform(size=n_cells) < 0.5).astype(int)
    t_split = 0.25
    post = np.clip(t - t_split, 0.0, None) / (1.0 - t_split)

    # master regulators: rise along their own branch, stay basal otherwise
    act1 = np.where(branch == 0, post, 0.0)
    act2 = np.where(branch == 1, post, 0.0)
    lat1 = 0.4 + 6.0 * act1
    lat2 = 0.4 + 6.0 * act2

    base = rs.gamma(2.0, 1.0, size=n_genes) * 2.0
    mu = np.tile(base, (n_cells, 1))
    cols = rs.choice(n_genes, 2 + 2 * MODULE, replace=False)
    g1, g2 = cols[0], cols[1]
    mod1, mod2 = cols[2:2 + MODULE], cols[2 + MODULE:]
    mu[:, g1] = lat1
    mu[:, g2] = lat2
    # module genes track their regulator with gene-specific gain + noise
    for j, c in enumerate(mod1):
        mu[:, c] = 0.3 + lat1 * rs.uniform(0.5, 1.5) * rs.lognormal(
            0.0, 0.25, n_cells)
    for j, c in enumerate(mod2):
        mu[:, c] = 0.3 + lat2 * rs.uniform(0.5, 1.5) * rs.lognormal(
            0.0, 0.25, n_cells)
    # a maturation program every cell shares (lets pseudotime be inferred)
    prog = rs.choice(np.setdiff1d(np.arange(n_genes), cols), 20,
                     replace=False)
    for c in prog:
        slope = rs.uniform(-1.5, 1.5)
        mu[:, c] = np.maximum(base[c] * (1.0 + slope * (t - 0.5)), 0.05)

    depth = rs.lognormal(0.0, 0.3, size=(n_cells, 1))
    mu = mu * depth
    theta = 2.0
    counts = rs.negative_binomial(
        theta, theta / (theta + mu)).astype(np.float32)
    drop = rs.uniform(size=counts.shape) < np.exp(-1.2 * mu)
    counts = np.where(drop, 0.0, counts).astype(np.float32)
    counts[:, counts.sum(0) == 0] += 1.0
    counts[counts.sum(1) == 0, 0] += 1.0
    return counts, t, branch, g1, g2, mod1, mod2


def _lognorm(X):
    X = np.asarray(X, np.float64)
    lib = X.sum(axis=1, keepdims=True)
    lib[lib == 0] = 1.0
    return np.log1p(X / lib * np.median(lib))


def diffusion_pseudotime(X, root, n_neighbors=20, n_comps=5):
    """Minimal diffusion-map pseudotime (sc.pp.neighbors(method='gauss') +
    sc.tl.dpt's core): Gaussian kNN kernel on log-normalized data,
    symmetrized + row-normalized transition matrix, leading non-trivial
    eigenvectors scaled by lambda/(1-lambda), pseudotime = diffusion-space
    distance from the root cell (Figure9.ipynb cells 3, 10)."""
    from scipy.spatial.distance import cdist

    D = cdist(X, X)
    sigma = np.sort(D, axis=1)[:, n_neighbors][:, None]
    sigma = np.maximum(sigma, 1e-12)
    W = np.exp(-(D ** 2) / (2.0 * sigma * sigma.T))
    np.fill_diagonal(W, 0.0)
    # kNN mask (symmetrized)
    order = np.argsort(D, axis=1)
    mask = np.zeros_like(W, dtype=bool)
    rows = np.arange(D.shape[0])[:, None]
    mask[rows, order[:, 1:n_neighbors + 1]] = True
    mask |= mask.T
    W = np.where(mask, W, 0.0)
    d = W.sum(axis=1)
    d[d == 0] = 1.0
    # density-normalized (alpha=1) symmetric kernel, as diffusion maps do
    K = W / np.outer(d, d)
    dk = K.sum(axis=1)
    dk[dk == 0] = 1.0
    A = K / np.sqrt(np.outer(dk, dk))
    evals, evecs = np.linalg.eigh(A)
    idx = np.argsort(evals)[::-1][1:n_comps + 1]  # drop the trivial one
    lam = np.clip(evals[idx], None, 1.0 - 1e-9)
    psi = (evecs[:, idx] / np.sqrt(dk)[:, None]) * (lam / (1.0 - lam))
    return np.linalg.norm(psi - psi[root], axis=1)


def _corr(a, b):
    return float(np.corrcoef(a, b)[0, 1])


def run_evaluation(n_cells=600, n_genes=120, epochs=150, seed=0,
                   verbose=True, device=None):
    """Returns a dict of the Figure-9 metrics for raw vs denoised."""
    from scipy.stats import spearmanr

    from dca_tpu_torch import dca
    from dca_tpu_torch.data.adata import AnnData

    counts, t, branch, g1, g2, mod1, mod2 = simulate_branching(
        n_cells, n_genes, seed)
    ad = dca(AnnData(counts.copy()), mode="denoise", epochs=epochs,
             copy=True, verbose=False, device=device)
    den = np.asarray(ad.X)

    raw_l = _lognorm(counts)
    den_l = _lognorm(den)

    # (a) master-regulator anti-correlation across branch cells (cell 18)
    on_branch = t > 0.35
    anti_raw = _corr(raw_l[on_branch, g1], raw_l[on_branch, g2])
    anti_dca = _corr(den_l[on_branch, g1], den_l[on_branch, g2])

    # (b) Krumsiek-style module structure (cell 15): mean within-module
    # minus across-module correlation, per matrix
    def module_contrast(Xl):
        cols1 = np.concatenate([[g1], mod1])
        cols2 = np.concatenate([[g2], mod2])
        C = np.corrcoef(Xl[:, np.concatenate([cols1, cols2])], rowvar=False)
        k = len(cols1)
        within = (C[:k, :k].sum() - k) / (k * (k - 1))
        within2 = (C[k:, k:].sum() - k) / (k * (k - 1))
        across = C[:k, k:].mean()
        return 0.5 * (within + within2) - across

    contrast_raw = module_contrast(raw_l)
    contrast_dca = module_contrast(den_l)

    # (c) double-zero imputation (cell 20): raw Gata1 == Pu.1 == 0 cells
    zz = (counts[:, g1] == 0) & (counts[:, g2] == 0) & on_branch
    anti_zz = (_corr(den_l[zz, g1], den_l[zz, g2])
               if zz.sum() >= 10 else float("nan"))

    # (d) diffusion pseudotime on the denoised matrix (cells 9-12)
    root = int(np.argmin(t))
    sub = np.random.RandomState(1).choice(
        n_cells, min(n_cells, 400), replace=False)  # keep the eig small
    if root not in sub:
        sub[0] = root
    r = int(np.where(sub == root)[0][0])
    pt_raw = diffusion_pseudotime(raw_l[sub], r)
    pt_dca = diffusion_pseudotime(den_l[sub], r)
    sp_raw = float(spearmanr(pt_raw, t[sub]).statistic)
    sp_dca = float(spearmanr(pt_dca, t[sub]).statistic)

    res = dict(anti_raw=anti_raw, anti_dca=anti_dca,
               contrast_raw=contrast_raw, contrast_dca=contrast_dca,
               anti_double_zero=anti_zz, n_double_zero=int(zz.sum()),
               dpt_spearman_raw=sp_raw, dpt_spearman_dca=sp_dca)
    if verbose:
        print("Figure-9 metrics (raw -> denoised):")
        print(f"  Gata1/Pu.1 anti-correlation: {anti_raw:+.3f} -> "
              f"{anti_dca:+.3f}   (cells 13/18)")
        print(f"  module contrast (within - across): {contrast_raw:+.3f} "
              f"-> {contrast_dca:+.3f}   (cell 15)")
        print(f"  double-zero cells (n={zz.sum()}): denoised anti-corr "
              f"{anti_zz:+.3f}   (cell 20)")
        print(f"  DPT~truth Spearman: {sp_raw:.3f} -> {sp_dca:.3f}   "
              f"(cells 3-12)")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=600)
    ap.add_argument("--genes", type=int, default=120)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    run_evaluation(args.cells, args.genes, args.epochs, device=args.device)


if __name__ == "__main__":
    main()
