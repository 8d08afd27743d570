"""nb_csr: ``nb_dense``'s law drawn sparse, for corpora whose dense form
the host cannot hold: NB of size ``nb_size`` around a
Gamma(``gene_gamma_shape``) gene rate times a lognormal(0,
``depth_sigma``) cell depth times ``mean_scale``, the rates and depths
drawn as ``nb_dense`` draws them, the counts as Poisson(Gamma(size,
mean / size)) by blocks of cells of at most ``BLOCK_ELEMENTS`` on the
card (the CPU where there is none), from a generator seeded with
``seed``, each block's nonzeros kept and the block dropped.  Then
``nb_dense``'s repair: an all-zero gene gets 1 in every cell, then an
all-zero cell 1 in its first gene.  A float32 ``scipy.sparse.csr_matrix``,
cells x genes, its column indices sorted in each row; the same seed gives
the same matrix on the same kind of device."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

BLOCK_ELEMENTS = 1 << 27


def _device():
    import torch

    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def make(t, seed):
    import torch

    rs = np.random.RandomState(seed)
    n_cells, n_genes = t["n_cells"], t["n_genes"]
    base = rs.gamma(t["gene_gamma_shape"], 1.0, size=n_genes)
    depth = rs.lognormal(0.0, t["depth_sigma"], size=n_cells)
    size = float(t["nb_size"])
    dev = _device()
    gen = torch.Generator(device=dev).manual_seed(seed)
    # a cell's Gamma scale over its depth: the gene's mean at depth 1 / size
    scale = torch.from_numpy(base * t["mean_scale"] / size).to(dev, torch.float32)
    depth = torch.from_numpy(depth).to(dev, torch.float32)
    rows = max(1, BLOCK_ELEMENTS // n_genes)
    alpha = torch.full((min(rows, n_cells), n_genes), size, device=dev)
    row_nnz = np.zeros(n_cells, np.int64)
    gene_nnz = torch.zeros(n_genes, dtype=torch.int64, device=dev)
    cols, vals = [], []
    for lo in range(0, n_cells, rows):
        hi = min(lo + rows, n_cells)
        lam = torch._standard_gamma(alpha[:hi - lo], generator=gen)
        lam *= depth[lo:hi, None] * scale
        counts = torch.poisson(lam, generator=gen)
        del lam
        hit = counts > 0
        gene_nnz += hit.sum(0)
        row_nnz[lo:hi] = hit.sum(1).cpu().numpy()
        cols.append(hit.nonzero()[:, 1].to(torch.int32).cpu().numpy())
        vals.append(counts[hit].cpu().numpy())
        del counts, hit
    del alpha
    nnz = int(row_nnz.sum())
    itype = np.int32 if nnz < 2**31 else np.int64
    indptr = np.zeros(n_cells + 1, itype)
    np.cumsum(row_nnz, out=indptr[1:])
    x = sp.csr_matrix((np.concatenate(vals), np.concatenate(cols).astype(itype, copy=False),
                       indptr), shape=(n_cells, n_genes))
    del cols, vals
    empty = np.flatnonzero(gene_nnz.cpu().numpy() == 0)
    if len(empty):
        k = len(empty)
        x = (x + sp.csr_matrix((np.ones(n_cells * k, np.float32), np.tile(empty, n_cells),
                                np.arange(0, n_cells * k + 1, k)),
                               shape=(n_cells, n_genes))).tocsr()
    lonely = np.flatnonzero(np.diff(x.indptr) == 0)
    if len(lonely):
        x = (x + sp.csr_matrix((np.ones(len(lonely), np.float32),
                                (lonely, np.zeros(len(lonely), np.int64))),
                               shape=(n_cells, n_genes))).tocsr()
    x.sort_indices()
    return x
