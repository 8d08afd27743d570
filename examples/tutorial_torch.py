"""End-to-end denoising tutorial — the reference tutorial.ipynb workflow
(splatter-style simulation -> dca() -> PCA/silhouette evaluation) as a
runnable script, on the PyTorch/CUDA port.

The port's version of ``examples/tutorial.py``: the same simulation and
evaluation through ``dca_tpu_torch.dca``, on the CUDA device by default.
Add ``--devices N`` to train on N cards from this one process (the fit
starts its own ranks, one a card over NCCL, and replays the sharded step
from CUDA graphs).

Usage:  python examples/tutorial_torch.py [outdir] [--device cpu]
        [--devices N] [--cells 2000] [--genes 200] [--epochs 300]
"""

import argparse
import time

import numpy as np
import pandas as pd

from dca_tpu_torch import dca
from dca_tpu_torch.data.adata import AnnData


def simulate(n_cells=2000, n_genes=200, seed=42, dropout_mid=3.0):
    """Two-group splatter-style simulation (dca_tpu_torch.data.simulate
    mirrors the reference scripts/simulate.R generator)."""
    from dca_tpu_torch.data.simulate import simulate_counts

    sim = simulate_counts(
        n_cells=n_cells, n_genes=n_genes, n_groups=2,
        dropout_mid=dropout_mid, de_strength=4.0, seed=seed,
    )
    return sim.counts, sim.true_counts, sim.groups


def silhouette(X, groups):
    from sklearn.decomposition import PCA
    from sklearn.metrics import silhouette_score

    n_comp = min(10, X.shape[1] - 1, X.shape[0] - 1)
    p = PCA(n_components=n_comp, random_state=0).fit_transform(np.log1p(X))
    return silhouette_score(p, groups)


def run_tutorial(n_cells=2000, n_genes=200, epochs=300, device=None, devices=None,
                 outdir=None, verbose=True):
    """Simulate, denoise with ``dca()`` (zinb-conddisp) and, with
    ``outdir``, write the full outputs there; returns {"noisy", "denoised",
    "true", "groups", "history"} (the count matrices, the groups and the
    fit's loss history)."""
    noisy, true_counts, groups = simulate(n_cells, n_genes)
    adata = AnnData(
        noisy.copy(),
        pd.DataFrame({"group": groups},
                     index=pd.Index([f"cell{i}" for i in range(len(groups))])),
        pd.DataFrame(index=pd.Index([f"gene{i}" for i in range(noisy.shape[1])])),
    )
    kw = dict(mode="denoise", ae_type="zinb-conddisp", epochs=epochs, verbose=False,
              device=device, devices=devices)
    t0 = time.time()
    ret = dca(adata, copy=True, return_info=True, **kw)
    history = ret.uns["dca_loss_history"]
    if verbose:
        print(f"dca() wall time: {time.time() - t0:.1f} s ({len(history['loss'])} epochs)")
    if outdir is not None:
        net = dca(adata, return_model=True, **kw)
        net.predict(adata, mode="full", return_info=True)
        net.write(adata, outdir, mode="full")
        if verbose:
            print(f"outputs written to {outdir}")
    return {"noisy": noisy, "denoised": np.asarray(ret.X), "true": true_counts,
            "groups": groups, "history": history}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--devices", type=int, default=None, help="train on N devices")
    ap.add_argument("--cells", type=int, default=2000)
    ap.add_argument("--genes", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=300)
    args = ap.parse_args()
    res = run_tutorial(args.cells, args.genes, args.epochs, args.device, args.devices,
                       args.outdir)
    for name in ("noisy", "denoised", "true"):
        print(f"silhouette  {name + ':':<10}{silhouette(res[name], res['groups']):+.3f}")


if __name__ == "__main__":
    main()
