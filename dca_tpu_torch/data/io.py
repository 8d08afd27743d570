"""Dataset ingestion, preprocessing and TSV output.

A copy of the JAX package's ``dca_tpu/data/io.py`` (which the port may not
import).  Text input and output go through the native C++ tier
(``dca_tpu_torch/native``) first, with pandas as the fallback that gives the
same arrays and the same bytes.  The held-out test fold of
``test_split`` is drawn as ``sklearn.model_selection.train_test_split(...,
test_size=0.1, random_state=42)`` draws it, with numpy alone.

The scanpy preprocessing calls are re-implemented with identical semantics:
  * ``sc.pp.filter_genes/filter_cells(min_counts=1)``
  * ``sc.pp.normalize_per_cell()``: scales every cell to the median total
    count, records pre-normalization totals in ``obs['n_counts']`` and drops
    zero-count cells
  * size factors ``n_counts / median(n_counts)``
  * ``sc.pp.log1p``
  * ``sc.pp.scale``: per-gene z-score with ddof=1, zero-variance genes keep
    std=1, densifies sparse input; or, with ``normalize(lazy_scale=True)``,
    the deferred form: the statistics go to ``uns['dca_scale_mean']`` and
    ``uns['dca_scale_std']``, ``X`` stays as it is (sparse stays sparse),
    and the fit and every pre-denoise forward apply ``(x - mean) / std``
    block by block.  ``auto_lazy_scale`` chooses it for sparse inputs above
    DCA_TPU_HOST_DENSE_BYTES, as the JAX package's entry points do.
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np
import pandas as pd
import scipy.sparse as sp

from .. import native
from .adata import AnnData, is_anndata_like, read_h5ad


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------


def read_text(path, first_column_names=True) -> AnnData:
    """Read a delimited text matrix (rows x cols as given in the file),
    through the native parser where it can, else through pandas, with the
    same result."""
    p = str(path)
    sep = "," if p.endswith((".csv", ".csv.gz")) else "\t"
    parsed = native.parse_text_matrix(path, sep=sep, first_column_names=first_column_names)
    if parsed is not None:
        X, rownames, colnames = parsed
        obs = pd.DataFrame(
            index=pd.Index(rownames if rownames is not None else range(X.shape[0])).astype(str))
        var = pd.DataFrame(index=pd.Index(colnames).astype(str))
        return AnnData(X, obs, var)
    df = pd.read_csv(path, sep=sep, index_col=0 if first_column_names else None)
    X = df.to_numpy(dtype=np.float32)
    obs = pd.DataFrame(index=pd.Index(df.index.astype(str)))
    var = pd.DataFrame(index=pd.Index(df.columns.astype(str)))
    return AnnData(X, obs, var)


def read_any(path, first_column_names=True) -> AnnData:
    p = str(path)
    if p.endswith(".h5ad"):
        return read_h5ad(p)
    if p.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread

        return AnnData(sp.csr_matrix(mmread(p)))
    return read_text(p, first_column_names=first_column_names)


def _test_fold(n_obs, test_size=0.1, random_state=42):
    """Indices of sklearn's ``train_test_split(np.arange(n_obs),
    test_size=test_size, random_state=random_state)`` test fold: the first
    ceil(test_size * n) entries of one RandomState permutation."""
    n_test = math.ceil(test_size * n_obs)
    return np.random.RandomState(random_state).permutation(n_obs)[:n_test]


def read_dataset(adata, transpose=False, test_split=False, copy=False, check_counts=True):
    if is_anndata_like(adata):
        if copy:
            adata = adata.copy()
    elif isinstance(adata, (str, os.PathLike)):
        adata = read_any(adata, first_column_names=True)
    else:
        raise NotImplementedError(f"Cannot interpret {type(adata)} as a dataset")

    if check_counts:
        # the reference checks integer-ness of the first 10 rows
        X_subset = adata.X[:10]
        norm_error = (
            "Make sure that the dataset (adata.X) contains unnormalized count data."
        )
        if sp.issparse(X_subset):
            assert (X_subset.astype(int) != X_subset).nnz == 0, norm_error
        else:
            assert np.all(X_subset.astype(int) == X_subset), norm_error

    if transpose:
        adata = adata.transpose()

    if test_split:
        spl = pd.Series(["train"] * adata.n_obs)
        spl.iloc[_test_fold(adata.n_obs)] = "test"
        adata.obs["dca_split"] = spl.values
    else:
        adata.obs["dca_split"] = "train"
    adata.obs["dca_split"] = adata.obs["dca_split"].astype("category")

    print(
        "dca_tpu_torch: Successfully preprocessed {} genes and {} cells.".format(
            adata.n_vars, adata.n_obs
        )
    )
    return adata


# ---------------------------------------------------------------------------
# preprocessing (scanpy-parity primitives)
# ---------------------------------------------------------------------------


def _row_sums(X):
    return np.asarray(X.sum(axis=1)).ravel()


def _col_sums(X):
    return np.asarray(X.sum(axis=0)).ravel()


def filter_genes(adata, min_counts=1):
    """Keep genes with total count >= min_counts; totals in var['n_counts']."""
    counts = _col_sums(adata.X)
    keep = counts >= min_counts
    _subset_inplace(adata, keep, axis=1)
    adata.var["n_counts"] = counts[keep]
    return adata


def filter_cells(adata, min_counts=1):
    counts = _row_sums(adata.X)
    keep = counts >= min_counts
    _subset_inplace(adata, keep, axis=0)
    adata.obs["n_counts"] = counts[keep]
    return adata


def _subset_inplace(adata, keep, axis):
    """Row/col in-place subset keeping every aligned attribute consistent,
    ``raw`` included (dropping rows from X but not from raw would shift the
    loss target of every later positional slice)."""
    if hasattr(adata, "_inplace_subset_obs"):  # real anndata
        if axis == 0:
            adata._inplace_subset_obs(np.asarray(keep))
        else:
            adata._inplace_subset_var(np.asarray(keep))
        return adata
    sub = adata[keep] if axis == 0 else adata[:, keep]
    adata.X = sub.X
    adata.obs = sub.obs
    adata.var = sub.var
    adata.obsm = sub.obsm
    if getattr(sub, "_raw", None) is not None:
        adata._raw = sub._raw
    return adata


def normalize_per_cell(adata, counts_per_cell_after=None):
    """Record obs['n_counts'], drop zero-count cells, scale each cell to the
    median (or given) total."""
    counts = _row_sums(adata.X)
    keep = counts > 0
    if not np.all(keep):
        _subset_inplace(adata, keep, axis=0)
        counts = counts[keep]
    adata.obs["n_counts"] = counts
    after = (
        np.median(counts) if counts_per_cell_after is None else counts_per_cell_after
    )
    scale = after / counts
    if sp.issparse(adata.X):
        d = sp.diags(scale.astype(adata.X.dtype))
        adata.X = (d @ adata.X).tocsr()
    else:
        adata.X = adata.X * scale[:, None].astype(adata.X.dtype)
    return adata


def log1p(adata):
    if sp.issparse(adata.X):
        adata.X = adata.X.copy()
        adata.X.data = np.log1p(adata.X.data)
    else:
        adata.X = np.log1p(adata.X)
    return adata


def scale(adata):
    """Per-gene z-score (ddof=1); zero-variance genes get std=1; the output
    is dense float32."""
    X = adata.X
    if sp.issparse(X):
        X = np.asarray(X.todense())
    X = np.asarray(X, dtype=np.float64)
    mean = X.mean(axis=0)
    n = X.shape[0]
    if n > 1:
        var = X.var(axis=0, ddof=1)
    else:
        var = np.zeros(X.shape[1])
    std = np.sqrt(var)
    std[std == 0] = 1.0
    adata.X = ((X - mean) / std).astype(np.float32)
    return adata


def lazy_scale_stats(X):
    """Per-gene (mean, std) with sc.pp.scale semantics (ddof=1, std 0 -> 1)
    computed without densifying a sparse X (the JAX package's
    ``data/loader.py::lazy_scale_stats``)."""
    n = X.shape[0]
    if sp.issparse(X):
        mean = np.asarray(X.mean(axis=0)).ravel()
        sq = np.asarray(X.multiply(X).mean(axis=0)).ravel()
        var = (sq - mean**2) * (n / max(n - 1, 1))
    else:
        X = np.asarray(X)
        mean = X.mean(axis=0)
        var = X.var(axis=0, ddof=1) if n > 1 else np.zeros(X.shape[1])
    std = np.sqrt(np.maximum(var, 0.0))
    std[std == 0] = 1.0
    return mean.astype(np.float32), std.astype(np.float32)


def auto_lazy_scale(adata) -> bool:
    """Should the entry points defer z-scaling (``normalize(...,
    lazy_scale=True)``) for this input?  True for sparse matrices whose
    dense form would exceed DCA_TPU_HOST_DENSE_BYTES (default 2 GB):
    ``scale`` would densify them on the host in float64.  Small or dense
    inputs keep the eager path."""
    if not sp.issparse(adata.X):
        return False
    limit = int(os.environ.get("DCA_TPU_HOST_DENSE_BYTES", 2_000_000_000))
    return adata.X.shape[0] * adata.X.shape[1] * 4 > limit


def normalize(
    adata,
    filter_min_counts=True,
    size_factors=True,
    normalize_input=True,
    logtrans_input=True,
    lazy_scale=False,
):
    """Model input = scaled log counts in ``adata.X``; loss target = raw
    counts in ``adata.raw.X``; size factors in ``adata.obs.size_factors``.
    ``lazy_scale=True`` computes the scale statistics into ``uns`` and
    leaves ``X`` unscaled (see the module docstring)."""
    if filter_min_counts:
        filter_genes(adata, min_counts=1)
        filter_cells(adata, min_counts=1)

    if size_factors or normalize_input or logtrans_input:
        adata.raw = adata.copy()
    else:
        adata.raw = adata

    if size_factors:
        normalize_per_cell(adata)
        adata.obs["size_factors"] = adata.obs.n_counts / np.median(adata.obs.n_counts)
    else:
        adata.obs["size_factors"] = 1.0

    if logtrans_input:
        log1p(adata)

    if normalize_input:
        if lazy_scale:
            mean, std = lazy_scale_stats(adata.X)
            adata.uns["dca_scale_mean"] = mean
            adata.uns["dca_scale_std"] = std
        else:
            scale(adata)

    return adata


# ---------------------------------------------------------------------------
# misc I/O
# ---------------------------------------------------------------------------


def read_genelist(filename):
    with open(filename, "rt") as f:
        genelist = list(set(f.read().strip().split("\n")))
    assert len(genelist) > 0, "No genes detected in genelist file"
    print("dca_tpu_torch: Subset of {} genes will be denoised.".format(len(genelist)))
    return genelist


def write_text_matrix(matrix, filename, rownames=None, colnames=None, transpose=False):
    """Tab-separated, %.6f, optional transpose that swaps row/col names;
    through the native writer where it can, else through pandas, with the
    same bytes."""
    matrix = np.asarray(matrix)
    if transpose:
        matrix = matrix.T
        rownames, colnames = colnames, rownames
    if rownames is not None and len(rownames) > matrix.shape[0]:
        # the *-shared heads' (N, 1) dispersion and dropout are written
        # against the gene names: the JAX package's writer names the one
        # row by the first of them (pandas would refuse the mismatch)
        rownames = rownames[:matrix.shape[0]]
    if matrix.ndim == 2 and native.write_matrix(matrix, filename, rownames, colnames,
                                                sep="\t"):
        return
    pd.DataFrame(matrix, index=rownames, columns=colnames).to_csv(
        filename,
        sep="\t",
        index=(rownames is not None),
        header=(colnames is not None),
        float_format="%.6f",
    )


def densify(X):
    """A dense float32 numpy array of a dense or scipy sparse matrix."""
    if sp.issparse(X):
        return np.asarray(X.todense(), dtype=np.float32)
    return np.asarray(X, dtype=np.float32)


def scale_stats(adata):
    """(mean, std) of a deferred z-scale, ``normalize(lazy_scale=True)``,
    or (None, None) when ``X`` is already scaled."""
    if "dca_scale_mean" in adata.uns:
        return (np.asarray(adata.uns["dca_scale_mean"], np.float32),
                np.asarray(adata.uns["dca_scale_std"], np.float32))
    return None, None


def size_factors(adata):
    """``obs['size_factors']`` as float32, or ones when ``normalize`` did
    not set them."""
    if "size_factors" in adata.obs:
        return np.asarray(adata.obs["size_factors"], np.float32)
    return np.ones((adata.n_obs,), np.float32)


def read_pickle(inputfile):
    with open(inputfile, "rb") as f:
        return pickle.load(f)
