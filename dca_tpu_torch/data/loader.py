"""Chunked input pipeline of the streaming trainer, for inputs larger than
the device.

A copy of the JAX package's ``dca_tpu/data/loader.py`` (numpy and scipy
only; the port may not import it).  The count matrix stays sparse (CSR) on
the host and one shuffled part of cells is materialized at a time, either
dense on the host (the C++ tier's row densify, the deferred z-scale applied
there) or as a compact payload that the device scatters dense
(``ops/densify.py``):

  * padded (``SparseChunk``): (B, K) column-id/value slabs, K the matrix's
    widest row, 8 bytes a slot;
  * flat (``FlatChunk``): per-row counts and a flat (col, val) stream,
    ~6-8 bytes a nonzero, the better encoding when the row-nnz tail makes
    K much larger than the mean;
  * flat8 (``Flat8Chunk``, opt-in): uint8 column gaps and values with
    exception side streams, ~2 bytes a nonzero, lossless.

``auto`` picks padded or flat by their bytes; DCA_TPU_PAYLOAD forces one.
Column ids go as int16 and integer counts as uint16 where they fit, both
lossless.  Input and target usually share their sparsity pattern (normalize
only rescales values); then the target payload reuses the input's index
arrays by identity and the trainer ships them once.  With ``derive_input``
only the target payload is built: the trainer derives the input from it on
the device (``train/loop.py::_derivable_row_scale``).

The per-shard flat payload of the JAX package's mesh path
(``FlatShardedChunk``) is not ported: it serves one process driving several
devices, which the port refuses (``parallel/mesh.py``).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from .. import native


def canonicalize_csr(M):
    """Sort and deduplicate a CSR matrix's indices in place, once (the
    ``_dca_canonical`` marker makes repeated calls free)."""
    if sp.isspmatrix_csr(M) and not getattr(M, "_dca_canonical", False):
        M.sum_duplicates()
        M.sort_indices()
        try:
            M._dca_canonical = True
        except AttributeError:
            pass
    return M


class SparseChunk:
    """Padded CSR payload of a part, densified on the device
    (``ops.densify.device_densify``): (B, K) column ids and values."""

    __slots__ = ("idx", "dat", "n_cols")

    def __init__(self, idx, dat, n_cols):
        self.idx, self.dat, self.n_cols = idx, dat, int(n_cols)

    @property
    def shape(self):
        return (self.idx.shape[0], self.n_cols)


class Flat8Chunk:
    """Flat8 payload (``ops.densify.flat8_payload_from_csr``): uint8
    column-gap deltas and uint8 values with int32/f32 exception side
    streams, ~2 bytes a nonzero, lossless for any values (those outside
    uint8 ride the exception stream).  Columns and row ids are rebuilt on
    the device (``ops.densify.device_densify_flat8``).  Opt-in through
    DCA_TPU_PAYLOAD=flat8: its delta decode and its numpy encode cost more
    than the bytes it saves over the flat payload unless the host link is
    slow."""

    __slots__ = ("counts", "firstcol", "gaps", "vals", "gpos", "gval",
                 "vpos", "vval", "n_rows", "n_cols")

    def __init__(self, counts, firstcol, gaps, vals, gpos, gval, vpos, vval,
                 n_rows, n_cols):
        self.counts, self.firstcol, self.gaps, self.vals = (
            counts, firstcol, gaps, vals)
        self.gpos, self.gval, self.vpos, self.vval = gpos, gval, vpos, vval
        self.n_rows, self.n_cols = int(n_rows), int(n_cols)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


class FlatChunk:
    """Flat padded COO payload of a part (``ops.densify.flat_payload_from_csr``),
    densified on the device by ``ops.densify.device_densify_flat``: per-row
    ``counts`` (B+1 int32, the row ids rebuilt on the device from them),
    ``col`` ids (int16 when the panel fits) and ``val`` (f32, or uint16 for
    integer counts)."""

    __slots__ = ("counts", "col", "val", "n_rows", "n_cols")

    def __init__(self, counts, col, val, n_rows, n_cols):
        self.counts, self.col, self.val = counts, col, val
        self.n_rows, self.n_cols = int(n_rows), int(n_cols)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)


def _gather_dense(X, idx) -> np.ndarray:
    if sp.issparse(X) and sp.isspmatrix_csr(X) and native.available():
        return native.densify_rows(X.indptr, X.indices, X.data, idx, X.shape[1])
    if (
        isinstance(X, np.ndarray)
        and X.dtype == np.float32
        and X.flags.c_contiguous
        and native.available()
    ):
        return native.gather_rows(X, idx)
    rows = X[idx]
    if sp.issparse(rows):
        rows = np.asarray(rows.todense())
    return np.asarray(rows, dtype=np.float32)


class StreamingData:
    """Host-side shuffled part iterator over (input, target, size_factors).

    ``scale_mean``/``scale_std`` (from ``data/io.py::lazy_scale_stats``)
    apply to the INPUT only (the target stays raw counts, as the loss
    needs): on the host for dense parts, in the device scatter's epilogue
    for payloads.
    """

    def __init__(
        self,
        X,
        target,
        size_factors,
        chunk_cells: int,
        scale_mean: Optional[np.ndarray] = None,
        scale_std: Optional[np.ndarray] = None,
        device_densify: bool = False,
        payload_mode: str = "auto",
        derive_input: bool = False,
    ):
        assert X.shape[0] == target.shape[0] == len(size_factors)
        self.X = X
        self.target = target
        self.sf = np.asarray(size_factors, np.float32)
        self.n = X.shape[0]
        self.chunk_cells = int(chunk_cells)
        self.scale_mean = scale_mean
        self.scale_std = scale_std
        self.device_densify = bool(device_densify)
        # an explicit payload_mode wins over the env knob; the env only
        # steers 'auto'
        mode = (payload_mode if payload_mode not in (None, "auto")
                else os.environ.get("DCA_TPU_PAYLOAD", "auto"))
        self._K_x = self._payload_width(X) if device_densify else None
        self._K_t = self._payload_width(target) if device_densify else None
        self._mode_x = self._pick_mode(X, self._K_x, mode)
        self._mode_t = self._pick_mode(target, self._K_t, mode)
        # input and target share the sparsity PATTERN when normalize only
        # rescaled values; then each part's index stream is built and
        # shipped once (materialize aliases it by identity)
        self._shared_pattern = bool(
            device_densify and self._pattern_shared(X, target)
        )
        # the trainer verified that the input is a per-row function of the
        # raw target: only the target payload is built and shipped
        self.derive_input = bool(derive_input and device_densify)
        # lossless uint16 value stream for integer count matrices
        self._int_vals = {}

    @staticmethod
    def _pattern_shared(A, B):
        if A is B:
            return True
        if not (sp.isspmatrix_csr(A) and sp.isspmatrix_csr(B)):
            return False
        if A.shape != B.shape or A.nnz != B.nnz:
            return False
        # normalize's `diags @ X` leaves the within-row index order
        # unspecified: canonicalize before comparing (the payload builders
        # need it too)
        canonicalize_csr(A)
        canonicalize_csr(B)
        return np.array_equal(A.indptr, B.indptr) and np.array_equal(
            A.indices, B.indices
        )

    @staticmethod
    def _payload_width(M):
        if not sp.isspmatrix_csr(M):
            return None
        nnz = np.diff(M.indptr)
        return max(int(nnz.max()) if nnz.size else 0, 1)

    def _pick_mode(self, M, K, mode):
        if K is None:
            return None  # dense host tier
        if mode in ("padded", "flat", "flat8"):
            return mode
        mean_nnz = max(M.nnz / max(M.shape[0], 1), 1.0)
        # bytes a row: padded 8 K against flat 12 mean (x1.15 for the slot
        # bucket's margin); flat8 stays opt-in (the Flat8Chunk docstring)
        return "flat" if 8.0 * K > 12.0 * mean_nnz * 1.15 else "padded"

    def _val_exc_rate(self, M):
        """Fraction of values a flat8 payload carries as exceptions
        (outside integer [0, 255]), one cached O(nnz) pass a matrix."""
        if not hasattr(self, "_vexc_rates"):
            self._vexc_rates = {}
        if id(M) not in self._vexc_rates:
            d = M.data
            if d.size == 0:
                self._vexc_rates[id(M)] = 0.0
            else:
                bad = (d < 0) | (d > 255) | (d != np.floor(d))
                self._vexc_rates[id(M)] = float(np.count_nonzero(bad)) / d.size
        return self._vexc_rates[id(M)]

    def _gap_exc_rate(self, M):
        """Fraction of within-row column gaps > 255, cached a matrix."""
        if not hasattr(self, "_gexc_rates"):
            self._gexc_rates = {}
        if id(M) not in self._gexc_rates:
            canonicalize_csr(M)
            ind = M.indices
            if ind.size < 2:
                self._gexc_rates[id(M)] = 0.0
            else:
                d = ind[1:].astype(np.int64) - ind[:-1]
                is_start = np.zeros(ind.size - 1, bool)
                bnd = M.indptr[1:-1] - 1  # gap positions that cross rows
                is_start[bnd[(bnd >= 0) & (bnd < ind.size - 1)]] = True
                self._gexc_rates[id(M)] = float(
                    np.count_nonzero((d > 255) & ~is_start)) / ind.size
        return self._gexc_rates[id(M)]

    def _flat_bucket(self, M, idx):
        """Padded slot count for a part of ``len(idx)`` rows: a function of
        the part's size (``ops.densify.flat_slots_for``), so parts of one
        size share one payload shape from epoch to epoch."""
        from ..ops.densify import flat_slots_for

        moments, nnz = self._nnz_cache(M)
        return flat_slots_for(M, idx, moments, nnz=nnz)

    def _integral_vals(self, M):
        """True when M's values are exact uint16 integers (raw counts),
        checked once a matrix: the lossless half-width value stream."""
        if id(M) not in self._int_vals:
            d = M.data
            self._int_vals[id(M)] = bool(
                d.size == 0
                or (
                    d.min() >= 0
                    and d.max() < np.iinfo(np.uint16).max
                    and np.all(d == np.floor(d))
                )
            )
        return self._int_vals[id(M)]

    def _exc_bucket(self, M, L, kind):
        """Exception-bucket size for a part with ``L`` flat slots: a
        function of the part's size and the matrix's exception rate, laddered
        x1.25 on overflow and remembered per (matrix, L), so same-size parts
        share one payload shape."""
        if not hasattr(self, "_exc_buckets"):
            self._exc_buckets = {}
        key = (id(M), L, kind)
        if key not in self._exc_buckets:
            rate = (self._gap_exc_rate(M) if kind == "g"
                    else self._val_exc_rate(M))
            self._exc_buckets[key] = int(
                2.0 * L * rate + 8.0 * np.sqrt(L * rate)) + 64
        return self._exc_buckets[key]

    def _nnz_cache(self, M):
        """(moments, nnz vector) of M, computed once (see _flat_bucket)."""
        if not hasattr(self, "_nnz_moments"):
            self._nnz_moments = {}
            self._nnz_vec = {}
        if id(M) not in self._nnz_moments:
            nnz = np.diff(M.indptr)
            self._nnz_vec[id(M)] = nnz
            self._nnz_moments[id(M)] = (float(nnz.mean()), float(nnz.std()))
        return self._nnz_moments[id(M)], self._nnz_vec[id(M)]

    def _component(self, M, idx, K, is_input):
        mode = self._mode_x if is_input else self._mode_t
        if mode == "flat8":
            from ..ops.densify import Flat8Overflow, flat8_payload_from_csr

            L = self._flat_bucket(M, idx)
            while True:
                Lg = self._exc_bucket(M, L, "g")
                Lv = self._exc_bucket(M, L, "v")
                try:
                    payload = flat8_payload_from_csr(M, idx, L, Lg, Lv)
                    break
                except Flat8Overflow as e:
                    # ladder the overflowing bucket(s) and remember
                    if e.need_g > Lg:
                        self._exc_buckets[(id(M), L, "g")] = int(
                            max(Lg, e.need_g) * 1.25) + 64
                    if e.need_v > Lv:
                        self._exc_buckets[(id(M), L, "v")] = int(
                            max(Lv, e.need_v) * 1.25) + 64
            return Flat8Chunk(*payload, len(idx), M.shape[1])
        if mode == "flat":
            from ..ops.densify import flat_payload_from_csr

            L = self._flat_bucket(M, idx)
            counts, c, v = flat_payload_from_csr(
                M, idx, L, int_vals=self._integral_vals(M)
            )
            return FlatChunk(counts, c, v, len(idx), M.shape[1])
        if mode == "padded":
            from ..ops.densify import payload_from_csr

            pi, pd = payload_from_csr(M, idx, K,
                                      int_vals=self._integral_vals(M))
            return SparseChunk(pi, pd, M.shape[1])
        x = _gather_dense(M, idx)
        if is_input and self.scale_mean is not None:
            x = (x - self.scale_mean) / self.scale_std
        return x

    def materialize(self, idx) -> Tuple[object, object, np.ndarray]:
        """(x, t, sf) of the rows ``idx``: dense float32 arrays or payloads.
        With ``derive_input`` x IS t (one payload; the trainer keys on the
        identity)."""
        if self.derive_input:
            t = self._component(self.target, idx, self._K_t, False)
            return t, t, self.sf[idx]
        x = self._component(self.X, idx, self._K_x, True)
        t = self._component(self.target, idx, self._K_t, False)
        if self._shared_pattern:
            # equal by construction: alias by IDENTITY so the trainer ships
            # the index stream once a part
            if (isinstance(x, FlatChunk) and isinstance(t, FlatChunk)
                    and x.col.shape == t.col.shape
                    and x.col.dtype == t.col.dtype):
                t.counts, t.col = x.counts, x.col
            elif isinstance(x, Flat8Chunk) and isinstance(t, Flat8Chunk) and (
                x.gaps.shape == t.gaps.shape
                and x.gpos.shape == t.gpos.shape
            ):
                t.counts, t.firstcol, t.gaps = x.counts, x.firstcol, x.gaps
                t.gpos, t.gval = x.gpos, x.gval
            elif isinstance(x, SparseChunk) and isinstance(t, SparseChunk) and (
                x.idx.shape == t.idx.shape
            ):
                t.idx = x.idx
        return x, t, self.sf[idx]

    def index_chunks(self, perm: np.ndarray) -> Iterator[np.ndarray]:
        """Yield fixed-size index slices of ``perm`` (the last may be short);
        the caller materializes each part."""
        c = self.chunk_cells
        for start in range(0, len(perm), c):
            yield perm[start : start + c]
