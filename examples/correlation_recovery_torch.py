"""Figure-4-style evaluation: time-course correlation recovery.

Python port of the EVALUATION LOGIC of the reference paper's Figure 4
(the reference repository's `reproducibility/code/Figure4.R`): on a time-course
dataset, genes correlate with time in the dropout-free matrix; dropout
destroys that correlation; a good denoiser recovers it.  The reference
runs this on the Francesconi C. elegans dataset (not shipped); here the
same metric runs on a simulated smooth time-course so the pipeline is
self-contained:

  1. simulate mu_g(t) = base_g * exp(slope_g * t) counts over n cells
     ordered by t, then apply ZINB dropout;
  2. pick the top-N |Pearson r(gene, t)| genes on the CLEAN matrix
     (Figure4.R lines 10-14: smallest p-values by sign);
  3. report the distribution of |r| for those genes in clean / dropout /
     DCA-denoised matrices (Figure4.R boxplot, lines 33-44).

Success criterion (the paper's): median |r|(denoised) approaches
median |r|(clean) and clearly exceeds median |r|(dropout).

Usage: python examples/correlation_recovery_torch.py [--cells 1000]
       [--genes 300] [--epochs 100] [--top 100]

The PyTorch/CUDA port's version of ``examples/correlation_recovery.py``: the same
evaluation through ``dca_tpu_torch.dca``, on the CUDA device by default
(``--device cpu``, or ``device="cpu"``, on the CPU).
"""

import argparse

import numpy as np


def simulate_time_course(n_cells=1000, n_genes=300, seed=0):
    rs = np.random.RandomState(seed)
    t = np.linspace(-1.0, 1.0, n_cells)
    base = rs.gamma(2.0, 1.0, size=n_genes) * 2.0
    slope = rs.normal(0.0, 0.8, size=n_genes)
    slope[rs.uniform(size=n_genes) < 0.5] = 0.0  # half the genes are flat
    mu = base[None, :] * np.exp(slope[None, :] * t[:, None])
    theta = 2.0
    clean = rs.negative_binomial(theta, theta / (theta + mu)).astype(np.float32)
    # ZINB dropout, heavier for low-expression genes (simulate.R style);
    # severe enough (~60-80% zeros) to actually break the time correlation
    pi = np.exp(-0.05 * mu)
    noisy = np.where(rs.uniform(size=clean.shape) < pi, 0.0, clean).astype(
        np.float32
    )
    noisy[:, noisy.sum(0) == 0] += 1.0
    noisy[noisy.sum(1) == 0, 0] += 1.0
    return clean, noisy, t


def gene_time_correlations(X, t):
    Xc = X - X.mean(0)
    tc = t - t.mean()
    denom = np.sqrt((Xc**2).sum(0) * (tc**2).sum()) + 1e-12
    return (Xc * tc[:, None]).sum(0) / denom


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=1000)
    ap.add_argument("--genes", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--top", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = args.device

    from dca_tpu_torch import dca
    from dca_tpu_torch.data.adata import AnnData

    clean, noisy, t = simulate_time_course(args.cells, args.genes)

    r_clean = gene_time_correlations(clean, t)
    # Figure4.R: top genes by time-correlation significance on CLEAN data
    top = np.argsort(-np.abs(r_clean))[: args.top]

    ad = dca(AnnData(noisy.copy()), mode="denoise", epochs=args.epochs,
             copy=True, verbose=False, device=device)
    denoised = np.asarray(ad.X)

    r_noisy = gene_time_correlations(noisy, t)
    r_dca = gene_time_correlations(denoised, t)

    med = lambda r: float(np.median(np.abs(r[top])))
    m_clean, m_noisy, m_dca = med(r_clean), med(r_noisy), med(r_dca)
    print(f"median |r(gene, time)| over top-{args.top} clean-correlated genes:")
    print(f"  clean (no dropout): {m_clean:.3f}")
    print(f"  with dropout:       {m_noisy:.3f}")
    print(f"  DCA denoised:       {m_dca:.3f}")
    recovered = (m_dca - m_noisy) / max(m_clean - m_noisy, 1e-9)
    print(f"  correlation recovery: {100 * min(recovered, 1.5):.0f}% of the "
          f"dropout loss (capped at 150%: smoothing can exceed the clean "
          f"counts' own sampling noise)")
    return m_clean, m_noisy, m_dca


if __name__ == "__main__":
    main()
