"""Denoising evaluation over the reference's simulation grid, on the
PyTorch/CUDA port.

The port's version of ``examples/evaluate_grid.py``: for every
(dropout.mid, n_groups) cell of the splatter-style grid, denoise with
``dca_tpu_torch.dca`` and report silhouette scores of the PCA embedding
against the ground-truth groups for the noisy / denoised / true counts —
the tutorial.ipynb cells 15/26 quality criterion:

    silhouette(denoised) ≈ silhouette(true) >> silhouette(noisy)

Usage:
    python examples/evaluate_grid_torch.py [--cells 2000] [--genes 200]
                                           [--epochs 300] [--mids 0,3]
                                           [--groups 2,6] [--hidden 64,32,64]
                                           [--device cpu]
"""

import argparse

import numpy as np
from sklearn.decomposition import PCA
from sklearn.metrics import silhouette_score

from dca_tpu_torch import dca
from dca_tpu_torch.data.simulate import simulate_counts, to_anndata


def silhouette(X, groups):
    n_comp = min(10, X.shape[1] - 1, X.shape[0] - 1)
    p = PCA(n_components=n_comp, random_state=0).fit_transform(np.log1p(X))
    return silhouette_score(p, groups)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=2000)
    ap.add_argument("--genes", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--mids", default="0,3", help="dropout.mid values")
    ap.add_argument("--groups", default="2,6", help="group counts (>1 for silhouette)")
    ap.add_argument("--hidden", default="64,32,64")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    hidden = tuple(int(h) for h in args.hidden.split(","))
    print(f"{'dataset':<22}{'noisy':>9}{'denoised':>10}{'true':>9}")
    for mid in (float(m) for m in args.mids.split(",")):
        for ng in (int(g) for g in args.groups.split(",")):
            sim = simulate_counts(
                n_cells=args.cells, n_genes=args.genes, n_groups=ng,
                dropout_mid=mid, de_strength=4.0, seed=42,
            )
            ad = to_anndata(sim)
            ret = dca(ad, mode="denoise", ae_type="zinb-conddisp", copy=True,
                      epochs=args.epochs, hidden_size=hidden, verbose=False,
                      device=args.device)
            s_noisy = silhouette(sim.counts, sim.groups)
            s_den = silhouette(np.asarray(ret.X), sim.groups)
            s_true = silhouette(sim.true_counts, sim.groups)
            name = f"drop{int(mid)}-group{ng}"
            print(f"{name:<22}{s_noisy:>+9.3f}{s_den:>+10.3f}{s_true:>+9.3f}",
                  flush=True)


if __name__ == "__main__":
    main()
