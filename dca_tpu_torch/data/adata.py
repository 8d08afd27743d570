"""Lightweight AnnData-compatible container.

A copy of the JAX package's ``dca_tpu/data/adata.py``: the port may not
import that package, whose ``__init__`` imports JAX.  The reference depends
on the `anndata`/`scanpy` stack (io.py:26, api.py:2-4); where neither is
installed this minimal duck-typed AnnData carries the exact attribute
surface the DCA pipeline touches:

    X, obs, var, obs_names, var_names, obsm, uns, raw, n_obs, n_vars,
    copy(), transpose(), boolean/row slicing, obs_keys()/var_keys()/
    obsm_keys()/uns_keys(), and .raw.X / .raw.var_names

If the real `anndata` package is importable it is used transparently — all
pipeline functions are duck-typed, and ``as_anndata``/``is_anndata_like``
accept either implementation.  H5AD read/write supports the common encodings
(dense X, CSR/CSC sparse groups, string/categorical obs/var columns).
"""

from __future__ import annotations

import copy as _copy
from typing import Optional

import numpy as np
import pandas as pd
import scipy.sparse as sp

try:  # pragma: no cover - exercised only when anndata is installed
    import anndata as _anndata
except ImportError:
    _anndata = None


class Raw:
    """Frozen snapshot of (X, var) like ``anndata.Raw``."""

    def __init__(self, X, var: pd.DataFrame, obs_names: pd.Index):
        self._X = X
        self._var = var
        self._obs_names = obs_names

    @property
    def X(self):
        return self._X

    @property
    def var(self):
        return self._var

    @property
    def var_names(self):
        return self._var.index

    @property
    def obs_names(self):
        return self._obs_names

    @property
    def n_vars(self):
        return self._X.shape[1]

    def copy(self):
        X = self._X.copy() if hasattr(self._X, "copy") else _copy.deepcopy(self._X)
        return Raw(X, self._var.copy(), self._obs_names.copy())


class AnnData:
    """Minimal AnnData look-alike (rows = cells/obs, cols = genes/vars)."""

    def __init__(
        self,
        X,
        obs: Optional[pd.DataFrame] = None,
        var: Optional[pd.DataFrame] = None,
        obsm: Optional[dict] = None,
        uns: Optional[dict] = None,
        raw: Optional[Raw] = None,
    ):
        if not sp.issparse(X):
            X = np.asarray(X)
        n_obs, n_vars = X.shape
        if obs is None:
            obs = pd.DataFrame(index=pd.Index([str(i) for i in range(n_obs)]))
        if var is None:
            var = pd.DataFrame(index=pd.Index([str(i) for i in range(n_vars)]))
        assert obs.shape[0] == n_obs, (obs.shape, X.shape)
        assert var.shape[0] == n_vars, (var.shape, X.shape)
        self.X = X
        self.obs = obs
        self.var = var
        self.obsm = dict(obsm or {})
        self.uns = dict(uns or {})
        self._raw = raw

    # -- basic geometry ----------------------------------------------------
    @property
    def n_obs(self):
        return self.X.shape[0]

    @property
    def n_vars(self):
        return self.X.shape[1]

    @property
    def shape(self):
        return self.X.shape

    @property
    def obs_names(self) -> pd.Index:
        return self.obs.index

    @obs_names.setter
    def obs_names(self, names):
        self.obs.index = pd.Index(names)

    @property
    def var_names(self) -> pd.Index:
        return self.var.index

    @var_names.setter
    def var_names(self, names):
        self.var.index = pd.Index(names)

    # -- raw ---------------------------------------------------------------
    @property
    def raw(self):
        return self._raw

    @raw.setter
    def raw(self, value):
        if value is None:
            self._raw = None
        elif isinstance(value, Raw):
            self._raw = value
        else:  # an AnnData: snapshot its X/var (anndata semantics)
            X = value.X.copy() if hasattr(value.X, "copy") else value.X
            self._raw = Raw(X, value.var.copy(), value.obs.index.copy())

    # -- dict-ish key helpers (anndata API) --------------------------------
    def obs_keys(self):
        return list(self.obs.columns)

    def var_keys(self):
        return list(self.var.columns)

    def obsm_keys(self):
        return list(self.obsm.keys())

    def uns_keys(self):
        return list(self.uns.keys())

    # -- structural ops ----------------------------------------------------
    def copy(self) -> "AnnData":
        X = self.X.copy()
        return AnnData(
            X,
            self.obs.copy(),
            self.var.copy(),
            {k: np.array(v, copy=True) for k, v in self.obsm.items()},
            _copy.deepcopy(self.uns),
            self._raw.copy() if self._raw is not None else None,
        )

    def transpose(self) -> "AnnData":
        X = self.X.T
        if sp.issparse(X):
            X = X.tocsr()
        return AnnData(X.copy(), self.var.copy(), self.obs.copy(), uns=_copy.deepcopy(self.uns))

    @property
    def T(self):
        return self.transpose()

    def __getitem__(self, idx) -> "AnnData":
        """Row (obs) subsetting by bool mask, int array, or slice."""
        if isinstance(idx, tuple):
            rows, cols = idx
        else:
            rows, cols = idx, slice(None)
        rows = self._norm_index(rows, self.n_obs, self.obs.index)
        cols = self._norm_index(cols, self.n_vars, self.var.index)
        X = self.X[rows][:, cols] if sp.issparse(self.X) else self.X[np.ix_(rows, cols)]
        sub = AnnData(
            X.copy(),
            self.obs.iloc[rows].copy(),
            self.var.iloc[cols].copy(),
            {k: np.array(v)[rows] for k, v in self.obsm.items()},
            _copy.deepcopy(self.uns),
        )
        if self._raw is not None:
            rX = self._raw.X[rows]
            sub._raw = Raw(rX.copy() if hasattr(rX, "copy") else rX, self._raw.var.copy(),
                           self.obs.index[rows].copy())
        return sub

    @staticmethod
    def _norm_index(idx, n, labels):
        if isinstance(idx, slice):
            return np.arange(n)[idx]
        idx = np.asarray(idx)
        if idx.dtype == bool:
            assert idx.shape[0] == n
            return np.where(idx)[0]
        if idx.dtype.kind in "iu":
            return idx
        # label-based
        lookup = pd.Index(labels)
        return np.asarray([lookup.get_loc(x) for x in idx])

    def __repr__(self):
        return (
            f"AnnData(lite) n_obs × n_vars = {self.n_obs} × {self.n_vars}\n"
            f"    obs: {list(self.obs.columns)}\n    var: {list(self.var.columns)}\n"
            f"    obsm: {list(self.obsm)}\n    uns: {list(self.uns)}"
        )

    # -- h5ad --------------------------------------------------------------
    def write_h5ad(self, path):
        write_h5ad(self, path)

    write = write_h5ad


def is_anndata_like(obj) -> bool:
    if isinstance(obj, AnnData):
        return True
    if _anndata is not None and isinstance(obj, _anndata.AnnData):
        return True
    return all(hasattr(obj, a) for a in ("X", "obs", "var", "obsm", "uns"))


# ---------------------------------------------------------------------------
# H5AD interop (h5py only)
# ---------------------------------------------------------------------------


def _decode(arr):
    arr = np.asarray(arr)
    if arr.dtype.kind in ("S", "O"):
        return np.asarray([x.decode() if isinstance(x, bytes) else str(x) for x in arr])
    return arr


def _read_matrix(node):
    import h5py

    if isinstance(node, h5py.Dataset):
        return np.asarray(node)
    enc = node.attrs.get("encoding-type", b"")
    enc = enc.decode() if isinstance(enc, bytes) else str(enc)
    data = np.asarray(node["data"])
    indices = np.asarray(node["indices"])
    indptr = np.asarray(node["indptr"])
    shape = tuple(node.attrs.get("shape", node.attrs.get("h5sparse_shape")))
    if "csc" in enc:
        return sp.csc_matrix((data, indices, indptr), shape=shape).tocsr()
    return sp.csr_matrix((data, indices, indptr), shape=shape)


def _read_df(grp) -> pd.DataFrame:
    index_col = grp.attrs.get("_index", b"_index")
    index_col = index_col.decode() if isinstance(index_col, bytes) else str(index_col)
    import h5py

    cols = {}
    index = None
    order = grp.attrs.get("column-order", list(grp.keys()))
    order = [c.decode() if isinstance(c, bytes) else str(c) for c in order]
    for name in list(grp.keys()):
        node = grp[name]
        if isinstance(node, h5py.Group):  # categorical encoding
            cats = _decode(node["categories"])
            codes = np.asarray(node["codes"])
            vals = pd.Categorical.from_codes(codes, categories=list(cats))
        else:
            vals = _decode(node)
        if name == index_col:
            index = pd.Index(np.asarray(vals))
        else:
            cols[name] = vals
    ordered = {c: cols[c] for c in order if c in cols}
    for c in cols:
        if c not in ordered:
            ordered[c] = cols[c]
    df = pd.DataFrame(ordered)
    if index is not None:
        df.index = index
    return df


def read_h5ad(path) -> AnnData:
    import h5py

    with h5py.File(path, "r") as f:
        X = _read_matrix(f["X"])
        obs = _read_df(f["obs"]) if "obs" in f else None
        var = _read_df(f["var"]) if "var" in f else None
        obsm = {}
        if "obsm" in f:
            for k in f["obsm"]:
                obsm[k] = np.asarray(f["obsm"][k])
        raw = None
        if "raw" in f and "X" in f["raw"]:
            rX = _read_matrix(f["raw"]["X"])
            rvar = _read_df(f["raw"]["var"]) if "var" in f["raw"] else None
            if rvar is None:
                rvar = pd.DataFrame(index=pd.Index([str(i) for i in range(rX.shape[1])]))
            raw = Raw(rX, rvar, obs.index if obs is not None else pd.Index([]))
        uns = _read_uns(f["uns"]) if "uns" in f else {}
    ad = AnnData(X, obs, var, obsm=obsm, uns=uns, raw=raw)
    return ad


def _write_df(f, name, df: pd.DataFrame):
    grp = f.create_group(name)
    grp.attrs["_index"] = "_index"
    grp.attrs["encoding-type"] = "dataframe"
    grp.attrs["column-order"] = np.asarray(list(df.columns), dtype="S")
    grp.create_dataset("_index", data=np.asarray(df.index.astype(str), dtype="S"))
    for c in df.columns:
        vals = df[c]
        if isinstance(vals.dtype, pd.CategoricalDtype):
            sub = grp.create_group(c)
            sub.attrs["encoding-type"] = "categorical"
            sub.create_dataset(
                "categories", data=np.asarray(vals.cat.categories.astype(str), dtype="S")
            )
            sub.create_dataset("codes", data=np.asarray(vals.cat.codes, dtype=np.int32))
        elif vals.dtype.kind in ("O", "U"):
            grp.create_dataset(c, data=np.asarray(vals.astype(str), dtype="S"))
        else:
            grp.create_dataset(c, data=np.asarray(vals))


def _write_matrix(f, name, X):
    if sp.issparse(X):
        X = X.tocsr()
        grp = f.create_group(name)
        grp.attrs["encoding-type"] = "csr_matrix"
        grp.attrs["shape"] = np.asarray(X.shape, dtype=np.int64)
        grp.create_dataset("data", data=X.data)
        grp.create_dataset("indices", data=X.indices)
        grp.create_dataset("indptr", data=X.indptr)
    else:
        f.create_dataset(name, data=np.asarray(X))


def write_h5ad(adata: AnnData, path):
    import h5py

    with h5py.File(path, "w") as f:
        _write_matrix(f, "X", adata.X)
        _write_df(f, "obs", adata.obs)
        _write_df(f, "var", adata.var)
        if adata.obsm:
            g = f.create_group("obsm")
            for k, v in adata.obsm.items():
                g.create_dataset(k, data=np.asarray(v))
        if adata.raw is not None:
            g = f.create_group("raw")
            _write_matrix(g, "X", adata.raw.X)
            _write_df(g, "var", adata.raw.var)
        if adata.uns:
            _write_uns(f.create_group("uns"), adata.uns)


def _write_uns(grp, mapping):
    """Serialize uns recursively: dicts -> groups, arrays/lists -> datasets,
    scalars -> attrs.  Keys like dca_loss_history / dca_scale_mean are part
    of the pipeline contract and must survive a round trip."""
    for k, v in mapping.items():
        if isinstance(v, dict):
            _write_uns(grp.create_group(str(k)), v)
        elif isinstance(v, (str, bytes, bool, int, float, np.generic)):
            grp.attrs[str(k)] = v
        else:
            arr = np.asarray(v)
            if arr.dtype.kind in ("O", "U"):
                arr = np.asarray([str(x) for x in arr.ravel()], dtype="S").reshape(arr.shape)
            grp.create_dataset(str(k), data=arr)


def _read_uns(grp):
    import h5py

    out = {}
    for k, v in grp.attrs.items():
        out[k] = v.decode() if isinstance(v, bytes) else v
    for k in grp.keys():
        node = grp[k]
        if isinstance(node, h5py.Group):
            out[k] = _read_uns(node)
        else:
            out[k] = _decode(node) if np.asarray(node).dtype.kind in ("S", "O") \
                else np.asarray(node)
    return out
