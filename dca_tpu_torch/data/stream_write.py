"""Streaming output writers for the corpus-scale denoise (TSV and H5AD).

A copy of the JAX package's ``dca_tpu/data/stream_write.py`` (which the port
may not import).  The in-memory path predicts the whole matrix, then writes
it, ``mean.tsv`` transposed to gene x cell: at 1.3M cells that is an ~18 GB
resident (N, G) array and a ~40 GB transposed text file.  These writers take
(block_rows, G) blocks as the block forward produces them and keep memory at
O(block + strip):

  * :class:`RowStreamTSV` appends cell-major rows (latent.tsv /
    reduced.tsv) block by block;
  * :class:`TransposedSpillTSV` spills each block TRANSPOSED ((G, C)
    row-major) to a scratch file, then writes the gene x cell TSV in gene
    strips whose per-block spill segments are contiguous reads: one
    sequential extra pass over ~4 bytes/value of scratch disk instead of an
    (N, G) resident array;
  * :class:`H5ADStreamWriter` fills an ``.h5ad`` with chunked dense
    datasets incrementally, readable by ``data.adata.read_h5ad`` and the
    anndata ecosystem.

Byte parity: both TSV writers give output byte-identical to
``io.write_text_matrix`` on the same matrix: both format ``%.6f`` through
the native C++ tier (``dca_tpu_torch/native``), or, without it, through
pandas, which gives the same bytes.
"""

from __future__ import annotations

import io as _pyio
import os
import tempfile

import numpy as np
import pandas as pd

from .. import native


def _format_rows(matrix, rownames, sep="\t"):
    """A row block as %.6f TSV bytes (no header), as pandas to_csv writes
    it: the native formatter, else pandas."""
    out = native.format_matrix(matrix, rownames=rownames, colnames=None, sep=sep)
    if out is not None:
        return out
    buf = _pyio.StringIO()
    pd.DataFrame(np.asarray(matrix), index=rownames).to_csv(
        buf, sep=sep, header=False, index=rownames is not None,
        float_format="%.6f",
    )
    return buf.getvalue().encode()


class RowStreamTSV:
    """Append-only cell-major TSV writer (latent.tsv contract:
    ``write_text_matrix(..., transpose=False)``) — O(block) memory."""

    def __init__(self, filename, rownames=None, colnames=None, sep="\t"):
        self.filename = filename
        self.sep = sep
        self.rownames = rownames  # full index, sliced per append
        self._written = 0
        d = os.path.dirname(os.path.abspath(filename)) or "."
        os.makedirs(d, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        self._f = os.fdopen(fd, "wb")
        self._f.write(native.header_bytes(rownames, colnames, sep))

    def append(self, block):
        block = np.asarray(block, np.float32)
        names = None
        if self.rownames is not None:
            names = self.rownames[self._written:self._written + block.shape[0]]
        self._f.write(_format_rows(block, names, self.sep))
        self._written += block.shape[0]

    def close(self):
        self._f.close()
        os.replace(self._tmp, self.filename)

    def abort(self):
        self._f.close()
        try:
            os.unlink(self._tmp)
        except OSError:
            pass


class TransposedSpillTSV:
    """Gene-major (transposed) TSV writer fed cell-major blocks.

    ``append`` receives (C, G) blocks in cell order; each is spilled
    transposed — (G, C) C-contiguous f32 — to a scratch file, so gene strip
    [g0:g1) of block k is ONE contiguous segment at
    ``block_offset_k + g0*C_k*4``.  ``close`` streams the gene x cell TSV
    strip by strip: per strip, read each block's segment, hstack to
    (strip, N), format, append.  Peak memory = one block transpose + one
    (strip_rows, N) strip; scratch disk = 4 bytes/value, deleted on close.
    """

    def __init__(self, filename, rownames=None, colnames=None, sep="\t",
                 strip_rows=None, tmp_dir=None):
        # rownames/colnames follow write_text_matrix AFTER its transpose
        # swap: rownames label output rows (genes), colnames the cells
        self.filename = filename
        self.rownames = rownames
        self.colnames = colnames
        self.sep = sep
        self.strip_rows = strip_rows
        self.n_cols_out = 0  # total cells appended
        self.G = None
        self._blocks = []  # (offset_bytes, n_cells_of_block)
        d = tmp_dir or os.path.dirname(os.path.abspath(filename)) or "."
        os.makedirs(d, exist_ok=True)
        fd, self._spill_path = tempfile.mkstemp(dir=d, suffix=".spill")
        self._spill = os.fdopen(fd, "w+b")

    def append(self, block):
        block = np.asarray(block, np.float32)
        C, G = block.shape
        if self.G is None:
            self.G = G
        assert G == self.G, (G, self.G)
        self._blocks.append((self._spill.tell(), C))
        np.ascontiguousarray(block.T).tofile(self._spill)
        self.n_cols_out += C

    def _auto_strip(self):
        if self.strip_rows is not None:
            return self.strip_rows
        # the budget covers the strip's text, up to ~49 bytes a value, not
        # just its float32 payload
        budget = int(os.environ.get("DCA_TPU_WRITE_STRIP_BYTES", 512_000_000))
        return max(1, min(self.G or 1,
                          budget // (49 * max(self.n_cols_out, 1))))

    def close(self):
        # anything that can raise before the output fd exists runs first,
        # so a failure here cannot leak the mkstemp descriptor
        try:
            self._spill.flush()
            strip = self._auto_strip()
        except BaseException:
            self.abort_spill()
            raise
        d = os.path.dirname(os.path.abspath(self.filename)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                out.write(native.header_bytes(self.rownames, self.colnames, self.sep))
                for g0 in range(0, self.G or 0, strip):
                    g1 = min(g0 + strip, self.G)
                    parts = []
                    for off, C in self._blocks:
                        self._spill.seek(off + g0 * C * 4)
                        seg = np.fromfile(self._spill, np.float32,
                                          count=(g1 - g0) * C)
                        parts.append(seg.reshape(g1 - g0, C))
                    rows = (np.hstack(parts) if len(parts) > 1 else parts[0]
                            if parts else np.zeros((g1 - g0, 0), np.float32))
                    names = (self.rownames[g0:g1]
                             if self.rownames is not None else None)
                    out.write(_format_rows(rows, names, self.sep))
            os.replace(tmp, self.filename)
            tmp = None
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            self.abort_spill()

    def abort_spill(self):
        try:
            self._spill.close()
        finally:
            try:
                os.unlink(self._spill_path)
            except OSError:
                pass


class H5ADStreamWriter:
    """Incrementally-written ``.h5ad``: dense chunked ``X`` plus obsm/var
    layers filled block by block — the corpus-scale alternative to the
    transposed text matrices (an 18 GB f32 dataset instead of a ~40 GB
    mean.tsv at 1.3M x 3451).  Layout matches ``data.adata.write_h5ad``
    (obs/var dataframe groups with ``_index``), so
    ``data.adata.read_h5ad`` and anndata both load it."""

    def __init__(self, path, n_obs, n_vars, obs_index=None, var_index=None,
                 compression=None):
        import h5py

        from .adata import _write_df

        self.n_obs, self.n_vars = int(n_obs), int(n_vars)
        self.path = path
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(dir=d, suffix=".h5ad.tmp")
        os.close(fd)
        self._f = h5py.File(self._tmp, "w")
        self._compression = compression
        rows_chunk = max(1, min(4096, self.n_obs))
        cols_chunk = max(1, min(self.n_vars, 8192))
        self._f.create_dataset(
            "X", shape=(self.n_obs, self.n_vars), dtype=np.float32,
            chunks=(rows_chunk, cols_chunk), compression=compression,
        )
        obs = pd.DataFrame(index=pd.Index(
            [str(i) for i in range(self.n_obs)] if obs_index is None
            else np.asarray(obs_index).astype(str)))
        var = pd.DataFrame(index=pd.Index(
            [str(i) for i in range(self.n_vars)] if var_index is None
            else np.asarray(var_index).astype(str)))
        _write_df(self._f, "obs", obs)
        _write_df(self._f, "var", var)
        self._obsm = self._f.create_group("obsm")
        self._varm = None
        self._row = {"X": 0}

    def append(self, key, block):
        """Append rows to ``X`` (key='X') or an obsm layer (created on
        first append)."""
        block = np.asarray(block, np.float32)
        if key == "X":
            ds = self._f["X"]
        else:
            if key not in self._obsm:
                rows_chunk = max(1, min(16384, self.n_obs))
                self._obsm.create_dataset(
                    key, shape=(self.n_obs, block.shape[1]),
                    dtype=np.float32,
                    chunks=(rows_chunk, block.shape[1]),
                    compression=self._compression,
                )
                self._row[key] = 0
            ds = self._obsm[key]
        lo = self._row[key]
        ds[lo:lo + block.shape[0]] = block
        self._row[key] = lo + block.shape[0]

    def set_var_vector(self, key, vec):
        """Per-gene vector (e.g. constant dispersion) into var/<key>."""
        self._f["var"].create_dataset(key, data=np.asarray(vec))
        order = list(self._f["var"].attrs.get("column-order", []))
        order.append(key)
        self._f["var"].attrs["column-order"] = np.asarray(order, dtype="S")

    def close(self):
        self._f.close()
        os.replace(self._tmp, self.path)

    def abort(self):
        self._f.close()
        try:
            os.unlink(self._tmp)
        except OSError:
            pass
