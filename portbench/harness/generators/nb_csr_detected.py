"""nb_csr_detected: ``nb_csr``'s law drawn sparse, then filtered as
``dca()``'s ``filter_min_counts`` filters a corpus: NB of size ``nb_size``
around a Gamma(``gene_gamma_shape``) gene rate times a lognormal(0,
``depth_sigma``) cell depth times ``mean_scale``, the rates and depths
drawn from ``seed`` as ``nb_csr`` draws them, the counts as
Poisson(Gamma(size, mean / size)) by blocks of cells of at most
``BLOCK_ELEMENTS`` on the card (the CPU where there is none), each
block's nonzeros kept and the block dropped.  Then every gene with no
count and every cell with no count is dropped; no value is forced into
any gene or cell.  A float32 ``scipy.sparse.csr_matrix``, cells x kept
genes, its column indices sorted in each row; no dense cells x genes
array is ever built.  The same seed gives the same matrix on the same
kind of device."""

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
    # filter_min_counts: genes, then cells, with at least one count
    kept = gene_nnz.cpu().numpy() > 0
    remap = np.cumsum(kept, dtype=np.int64).astype(np.int32) - 1
    row_nnz = row_nnz[row_nnz > 0]
    nnz = int(row_nnz.sum())
    itype = np.int32 if nnz < 2**31 else np.int64
    indptr = np.zeros(len(row_nnz) + 1, itype)
    np.cumsum(row_nnz, out=indptr[1:])
    indices = np.concatenate(cols)
    del cols
    np.take(remap, indices, out=indices)  # kept genes keep their order
    x = sp.csr_matrix((np.concatenate(vals), indices.astype(itype, copy=False), indptr),
                      shape=(len(row_nnz), int(kept.sum())))
    del vals, indices
    x.sort_indices()
    return x
