"""Production-scale recipe: denoise a larger-than-device-memory dataset,
on the PyTorch/CUDA port.

The port's version of ``examples/large_scale.py``, through
``dca_tpu_torch`` on the CUDA device (a second argument ``cpu`` runs it on
the CPU).  It demonstrates the subsystems the reference lacks, composed
the way a real 1M-cell run (the paper's scalability claim) would use
them:

  * sparse ingestion + lazy z-scaling (the matrix is never densified on the
    host: ``normalize(..., lazy_scale=True)`` stores per-gene stats instead
    of scaling in place, data/io.py);
  * the chunked streaming trainer (``max_device_cells``) — one host->device
    pass per epoch, the minibatch steps of a chunk replayed from CUDA graphs;
  * on-device densification (``DCA_TPU_DEVICE_DENSIFY=1``) shipping O(nnz)
    payloads instead of dense chunks — flat/padded encoding auto-picked,
    and under the default pipeline only the raw-count target payload
    crosses the link (the normalized input is derived on the device); when
    the compressed corpus fits the device budget the trainer goes
    device-RESIDENT — the CSR uploads once and shuffled parts rebuild on
    the device with slice-form gathers (PERF.md has the card's epochs);
  * crash-safe checkpointing (``checkpoint_every``/``resume``) of the FULL
    train state;
  * the streaming denoise→write leg — the pipeline's actual PRODUCT
    (reference train.py:190-191): ``write_streaming`` streams blocks from
    the pipelined chunked predict into an incrementally-written
    ``denoised.h5ad`` (or the exact TSV contract with
    ``output_format='tsv'``) so no (N, G) output ever sits in host RAM;
  * several cards: DCA_TPU_EXAMPLE_DEVICES=all (or a count) shards cells
    over a data mesh of one rank a card, which this process starts itself
    (under torchrun every rank runs this script instead); over NCCL each
    rank replays its sharded step from CUDA graphs.

Run:  python examples/large_scale_torch.py [n_cells] [device]
      (default 200k synthetic cells on the CUDA device)
"""

import os
import sys
import time

import numpy as np
import pandas as pd
import scipy.sparse as sp

from dca_tpu_torch.data import normalize, read_dataset
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models import AE_types
from dca_tpu_torch.train import train


def synthetic_sparse_counts(n_cells, n_genes=3451, k=345, seed=0):
    """Sparse NB counts (~10% density) built directly in CSR — no dense
    intermediate, as a real ingest pipeline would stream from disk."""
    rs = np.random.RandomState(seed)
    step = n_genes // k
    idx = (np.arange(k, dtype=np.int32)[None, :] * step
           + (np.arange(n_cells, dtype=np.int32)[:, None] % step))
    data = (rs.poisson(3.0, size=n_cells * k) + 1.0).astype(np.float32)
    indptr = np.arange(n_cells + 1, dtype=np.int64) * k
    return sp.csr_matrix((data, idx.ravel(), indptr), shape=(n_cells, n_genes))


def _devices(value):
    """DCA_TPU_EXAMPLE_DEVICES as ``train``'s ``devices``: None, "all" or a
    count."""
    return int(value) if value and value.isdigit() else value


def main():
    n_cells = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    device = sys.argv[2] if len(sys.argv) > 2 else None
    X = synthetic_sparse_counts(n_cells)
    n_genes = X.shape[1]
    print(f"dataset: {n_cells} cells x {n_genes} genes, "
          f"{X.nnz / n_cells / n_genes:.1%} dense, "
          f"{X.data.nbytes / 1e6:.0f} MB as CSR "
          f"(vs {4 * n_cells * n_genes / 1e9:.1f} GB dense)")

    ad = AnnData(
        X,
        pd.DataFrame(index=pd.Index([f"c{i}" for i in range(n_cells)])),
        pd.DataFrame(index=pd.Index([f"g{i}" for i in range(n_genes)])),
    )
    # lazy_scale: X stays CSR; per-gene mean/std stored in uns and applied
    # chunk-wise at staging time (on the device when DEVICE_DENSIFY is on)
    ad = normalize(read_dataset(ad, check_counts=False), lazy_scale=True,
                   filter_min_counts=False)

    net = AE_types["nb-conddisp"](input_size=n_genes, seed=0, device=device)
    net.build()

    t0 = time.perf_counter()
    hist = train(
        ad, net,
        epochs=3,
        max_device_cells=16384,        # stream in 16k-cell chunks
        checkpoint_every=1,            # crash-resume: rerun with resume=True
        output_dir="large_scale_out",
        devices=_devices(os.environ.get("DCA_TPU_EXAMPLE_DEVICES")),  # e.g. 'all'
        verbose=True,
        seed=0,
    )
    dt = time.perf_counter() - t0
    per_epoch = dt / max(len(hist.history["loss"]), 1)
    print(f"trained {len(hist.history['loss'])} epochs in {dt:.1f}s "
          f"({n_cells / per_epoch:,.0f} cells/s/epoch)")
    print("resume after a crash with: train(..., resume=True)")

    # ---- the deliverable: denoised matrix, streamed to disk ----------
    # h5ad: one chunked binary file (X = denoised, obsm X_dca latent);
    # at this scale the transposed TSV contract would be tens of GB of
    # text — pass output_format='tsv' if you need it anyway.
    t0 = time.perf_counter()
    net.write_streaming(ad, "large_scale_out", mode="full",
                        output_format="h5ad")
    print(f"denoised + wrote large_scale_out/denoised.h5ad in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({os.path.getsize('large_scale_out/denoised.h5ad') / 1e9:.1f} GB)")


if __name__ == "__main__":
    main()
