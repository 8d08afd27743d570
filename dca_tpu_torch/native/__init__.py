"""Native (C++) IO tier: ctypes bindings over ``io_native.cpp``.

The port's copy of the JAX package's ``dca_tpu/native`` (which the port may
not import), OpenMP-parallel host loops for the text and batch paths:

  * :func:`parse_text_matrix`: TSV/CSV count-matrix reader, semantics-equal
    to ``pd.read_csv(sep, index_col=0)``;
  * :func:`format_matrix` and :func:`write_matrix`: ``%.6f`` row formatting,
    byte-identical to ``DataFrame.to_csv(float_format='%.6f')``;
  * :func:`densify_rows`, :func:`csr_to_padded`, :func:`csr_to_flat` and
    :func:`gather_rows`: CSR scatter and dense gather for batch assembly.

The shared library is built at first use, never at import, with ``g++ -O3
-march=native -fopenmp -shared -fPIC`` (again without ``-march=native`` if
that fails), in ``dca_tpu_torch/_build/native-<hash>/``: the hash covers
the source, the flags and the host CPU, so a changed source, or a checkout
shared with another kind of machine, builds anew.  Each build runs in a
temporary directory and is renamed into place, so processes that build at
once each load a whole library.  Plain C ABI, no Python headers.

Every entry point has a numpy/pandas fallback with the same results:
``available()`` reports whether the native path is active, a failed build
leaves the fallbacks, and DCA_TPU_NO_NATIVE=1 forces them.  The functions
that return text or parse it return None (``write_matrix``: False) where
the caller must take its pandas path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "io_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_NAME = "libdca_io_native.so"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_c_char_p = ctypes.c_char_p
_i64 = ctypes.c_int64
_p_i64 = ctypes.POINTER(ctypes.c_int64)
_p_i32 = ctypes.POINTER(ctypes.c_int32)
_p_f32 = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "dca_count_lines": ([_c_char_p, _i64], _i64),
    "dca_index_lines": ([_c_char_p, _i64, _p_i64, _i64], _i64),
    "dca_count_fields": ([_c_char_p, _i64, _i64, ctypes.c_char], _i64),
    "dca_parse_rows": ([_c_char_p, _i64, _p_i64, _i64, _i64, ctypes.c_int, ctypes.c_char,
                        _p_f32, _p_i64, _p_i64], _i64),
    "dca_csr_densify": ([_p_i64, _p_i32, _p_f32, _p_i64, _i64, _i64, _p_f32], None),
    "dca_csr_to_padded": ([_p_i64, _p_i32, _p_f32, _p_i64, _i64, _i64, ctypes.c_int32,
                           _p_i32, _p_f32], None),
    "dca_csr_to_flat": ([_p_i64, _p_i32, _p_f32, _p_i64, _i64, _i64, ctypes.c_int32,
                         _p_i32, _p_i32, _p_f32], _i64),
    "dca_gather_rows": ([_p_f32, _p_i64, _i64, _i64, _p_f32], None),
    "dca_format_rows": ([_p_f32, _i64, _i64, _c_char_p, _p_i64, _p_i64, ctypes.c_char,
                         _c_char_p, _i64], _i64),
    "dca_write_file": ([_c_char_p, _c_char_p, _i64, _p_f32, _i64, _i64, _c_char_p,
                        _p_i64, _p_i64, ctypes.c_char], _i64),
    "dca_native_threads": ([], ctypes.c_int),
    "dca_native_set_threads": ([ctypes.c_int], None),
}


def _host_tag() -> bytes:
    """The host CPU's model and feature flags: a library built with
    ``-march=native`` runs only where they are the same."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().split(b"\n")
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(sorted(set(lines)))
    except OSError:
        return platform.machine().encode()


def lib_path() -> str:
    """Where this source, these flags and this host's library lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + _host_tag() + b"\0")
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"native-{h.hexdigest()[:16]}", LIB_NAME)


def _build(path) -> bool:
    """Compile into a temporary directory beside ``path`` and rename the
    library into place; again without ``-march=native`` if g++ refuses it.
    True when ``path`` holds a library afterwards; False, never an
    exception, when it cannot be built there (no g++, a failed compile, a
    build directory that cannot be written)."""
    work = None
    try:
        out_dir = os.path.dirname(path)
        os.makedirs(out_dir, exist_ok=True)
        work = tempfile.mkdtemp(dir=out_dir)
        tmp = os.path.join(work, LIB_NAME)
        for flags in (GXX_FLAGS, tuple(f for f in GXX_FLAGS if f != "-march=native")):
            r = subprocess.run(["g++", *flags, "-o", tmp, _SRC], capture_output=True,
                               timeout=120)
            if r.returncode == 0:
                os.replace(tmp, path)
                return True
        return False
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)


@functools.cache
def _library():
    """The loaded library with its signatures declared, built on the first
    call; None when it cannot be built or loaded."""
    path = lib_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
    except (OSError, AttributeError):
        return None
    return lib


def _load():
    if os.environ.get("DCA_TPU_NO_NATIVE"):
        return None
    return _library()


def available() -> bool:
    return _load() is not None


def n_threads() -> int:
    lib = _load()
    return lib.dca_native_threads() if lib else 1


def set_threads(n) -> None:
    """Cap the native tier's OpenMP pool (the ``threads`` option of the CLI
    and the API; the reference caps TF's thread pools the same way,
    train.py:41-48).  No-op when the library is unavailable or n is falsy."""
    lib = _load()
    if lib is not None and n:
        lib.dca_native_set_threads(int(n))


def _as_i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def _in_range(rows, n):
    """Whether every row index lies in [0, n): the C loops read no other;
    numpy's indexing, the fallback, wraps negative ones or raises."""
    return len(rows) == 0 or (rows.min() >= 0 and rows.max() < n)


def _out_buffer(out, shape):
    if out is None:
        return np.empty(shape, np.float32)
    if out.shape != shape or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 array of shape {shape}")
    return out


# ---------------------------------------------------------------------------
# text matrix parse
# ---------------------------------------------------------------------------


def _read_bytes(path_or_bytes):
    if isinstance(path_or_bytes, bytes):
        return path_or_bytes
    p = str(path_or_bytes)
    if p.endswith(".gz"):
        import gzip

        with gzip.open(p, "rb") as f:
            return f.read()
    with open(p, "rb") as f:
        return f.read()


def parse_text_matrix(path_or_bytes, sep="\t", first_column_names=True):
    """Parse a delimited numeric matrix with a header line.

    Returns ``(X float32 (rows, cols), rownames list[str] | None,
    colnames list[str])`` with the semantics of ``pd.read_csv(sep=sep,
    index_col=0 if first_column_names else None)``, or None where the
    caller must take the pandas path: no library, an empty or one-line
    input, a ragged header or a malformed row (pandas then gives its own
    result or error).
    """
    lib = _load()
    if lib is None:
        return None
    buf = _read_bytes(path_or_bytes)
    blen = len(buf)
    if blen == 0:
        return None

    n_lines = lib.dca_count_lines(buf, blen)
    if n_lines < 2:
        return None
    starts = np.empty(n_lines, np.int64)
    if lib.dca_index_lines(buf, blen, _ptr(starts, _p_i64), n_lines) != n_lines:
        return None

    sep_b = sep.encode()
    header_fields = lib.dca_count_fields(buf, blen, starts[0], sep_b)
    data_fields = lib.dca_count_fields(buf, blen, starts[1], sep_b)

    n_rows = n_lines - 1
    skip_first = 1 if first_column_names else 0
    cols = data_fields - skip_first
    if cols <= 0:
        return None
    # the header may or may not carry the corner cell; pandas keeps the
    # last `cols` header fields as column names either way
    header_end = int(starts[1]) - 1
    while header_end > 0 and buf[header_end - 1:header_end] in (b"\n", b"\r"):
        header_end -= 1
    hfields = buf[int(starts[0]):header_end].decode("utf-8", "replace").split(sep)
    if header_fields not in (cols, cols + skip_first):
        return None
    colnames = hfields[-cols:]

    X = np.empty((n_rows, cols), np.float32)
    name_off = name_len = None
    if skip_first:
        name_off = np.empty(n_rows, np.int64)
        name_len = np.empty(n_rows, np.int64)
    data_starts = np.ascontiguousarray(starts[1:])
    bad = lib.dca_parse_rows(
        buf, blen, _ptr(data_starts, _p_i64), n_rows, cols, skip_first, sep_b,
        _ptr(X, _p_f32),
        None if name_off is None else _ptr(name_off, _p_i64),
        None if name_len is None else _ptr(name_len, _p_i64),
    )
    if bad != 0:
        return None

    rownames = None
    if skip_first:
        rownames = [buf[int(o):int(o + n)].decode("utf-8", "replace")
                    for o, n in zip(name_off, name_len)]
    return X, rownames, colnames


# ---------------------------------------------------------------------------
# text matrix format/write
# ---------------------------------------------------------------------------


def _name_spans(rownames):
    """The row names as one byte blob and each name's (offset, length)."""
    encoded = [str(r).encode() for r in rownames]
    blob = b"".join(encoded)
    name_len = np.array([len(e) for e in encoded], np.int64)
    name_off = np.concatenate([[0], np.cumsum(name_len[:-1])]).astype(np.int64)
    return blob, name_off, name_len


def header_bytes(rownames, colnames, sep="\t"):
    """The header line exactly as pandas ``to_csv(header=...)`` writes it:
    an empty index field when there are row names, then the column names.
    Pure Python: the text writers of ``data/`` use it with or without the
    library."""
    if colnames is None:
        return b""
    head = (sep if rownames is not None else "") + sep.join(
        str(c) for c in colnames
    ) + "\n"
    return head.encode()


def _names_args(rownames):
    if rownames is None:
        return b"", None, None, 0
    blob, name_off, name_len = _name_spans(rownames)
    return blob, name_off, name_len, int(name_len.sum())


def format_matrix(matrix, rownames=None, colnames=None, sep="\t"):
    """Format a matrix as delimited text bytes, byte-identical to
    ``pd.DataFrame(...).to_csv(sep=sep, float_format='%.6f',
    index=rownames is not None, header=colnames is not None)``.
    Returns None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    X = np.ascontiguousarray(matrix, dtype=np.float32)
    n_rows, n_cols = X.shape
    blob, name_off, name_len, name_bytes = _names_args(rownames)

    cap = n_rows * (n_cols * 49 + 2) + name_bytes + n_rows * 2 + 64
    # a numpy buffer, not a ctypes array: glibc returns numpy's large
    # allocations to the system on free, while multi-GB ctypes arrays
    # interleaved with other allocations were seen to stay resident
    out = np.empty(cap, np.uint8)
    written = lib.dca_format_rows(
        _ptr(X, _p_f32), n_rows, n_cols, blob,
        None if name_off is None else _ptr(name_off, _p_i64),
        None if name_len is None else _ptr(name_len, _p_i64),
        sep.encode(), out.ctypes.data_as(ctypes.c_char_p), cap,
    )
    if written < 0:
        return None
    return header_bytes(rownames, colnames, sep) + out[:written].tobytes()


def write_matrix(matrix, filename, rownames=None, colnames=None, sep="\t"):
    """Format and write ``matrix`` to ``filename`` from C, in bounded row
    blocks, through a temporary file renamed into place: the bytes of
    ``format_matrix``.  Returns False where the caller must take the pandas
    path (no library, or the write failed)."""
    lib = _load()
    if lib is None:
        return False
    X = np.ascontiguousarray(matrix, dtype=np.float32)
    n_rows, n_cols = X.shape
    blob, name_off, name_len, _ = _names_args(rownames)
    header = header_bytes(rownames, colnames, sep)

    d = os.path.dirname(os.path.abspath(filename))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    written = lib.dca_write_file(
        tmp.encode(), header, len(header), _ptr(X, _p_f32), n_rows, n_cols, blob,
        None if name_off is None else _ptr(name_off, _p_i64),
        None if name_len is None else _ptr(name_len, _p_i64),
        sep.encode(),
    )
    if written < 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, filename)
    return True


# ---------------------------------------------------------------------------
# batch assembly
# ---------------------------------------------------------------------------


def _csr_arrays(indptr, indices, data):
    return (_as_i64(indptr), np.ascontiguousarray(indices, dtype=np.int32),
            np.ascontiguousarray(data, dtype=np.float32))


def densify_rows(indptr, indices, data, rows, n_cols, out=None):
    """Scatter CSR rows into a dense (len(rows), n_cols) f32 array."""
    lib = _load()
    rows = _as_i64(rows)
    n_rows = len(rows)
    out = _out_buffer(out, (n_rows, n_cols))
    if lib is None or not _in_range(rows, len(indptr) - 1):
        out[:] = 0.0
        for r, src in enumerate(rows):
            sl = slice(indptr[src], indptr[src + 1])
            out[r, indices[sl]] = data[sl]
        return out
    indptr, indices, data = _csr_arrays(indptr, indices, data)
    lib.dca_csr_densify(_ptr(indptr, _p_i64), _ptr(indices, _p_i32), _ptr(data, _p_f32),
                        _ptr(rows, _p_i64), n_rows, n_cols, _ptr(out, _p_f32))
    return out


def csr_to_padded(indptr, indices, data, rows, K, pad_index):
    """Copy CSR rows into padded (len(rows), K) int32/f32 payload buffers for
    densifying on the device: index slots past a row's nnz carry ascending
    out-of-range ids ``pad_index + k``, value slots carry 0."""
    rows = _as_i64(rows)
    n_rows = len(rows)
    out_idx = np.empty((n_rows, K), np.int32)
    out_dat = np.empty((n_rows, K), np.float32)
    lib = _load()
    if lib is None or not _in_range(rows, len(indptr) - 1):
        indptr = _as_i64(indptr)
        out_dat[:] = 0.0
        starts = indptr[rows]
        lens = np.minimum(indptr[rows + 1] - starts, K)
        # padding slot k of a row with L entries carries pad_index + (k - L)
        pad_shift = np.arange(K, dtype=np.int32)[None, :] - lens[:, None]
        out_idx[:] = pad_index + np.maximum(pad_shift, 0).astype(np.int32)
        total = int(lens.sum())
        if total:
            rr = np.repeat(np.arange(n_rows), lens)
            jj = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
            src = np.repeat(starts, lens) + jj
            out_idx[rr, jj] = indices[src]
            out_dat[rr, jj] = data[src]
        return out_idx, out_dat
    indptr, indices, data = _csr_arrays(indptr, indices, data)
    lib.dca_csr_to_padded(_ptr(indptr, _p_i64), _ptr(indices, _p_i32), _ptr(data, _p_f32),
                          _ptr(rows, _p_i64), n_rows, K, np.int32(pad_index),
                          _ptr(out_idx, _p_i32), _ptr(out_dat, _p_f32))
    return out_idx, out_dat


def csr_to_flat(indptr, indices, data, rows, L, pad_row):
    """Copy CSR rows into a flat padded COO payload (row, col, val) of
    length ``L`` for a flat scatter on the device: 12 bytes a nonzero
    against the padded scheme's 8 bytes a max-width slot.  Padding slots
    carry row id ``pad_row`` (out of bounds, dropped by the scatter).

    Returns (row_ids, col_ids, values, total_nnz); total_nnz > L means the
    payload did not fit (the caller picks a bigger bucket)."""
    rows = _as_i64(rows)
    n_rows = len(rows)
    out_row = np.empty(L, np.int32)
    out_col = np.empty(L, np.int32)
    out_val = np.empty(L, np.float32)
    lib = _load()
    if lib is None or not _in_range(rows, len(indptr) - 1):
        indptr = _as_i64(indptr)
        starts = indptr[rows]
        lens = indptr[rows + 1] - starts
        total = int(lens.sum())
        if total > L:
            return out_row, out_col, out_val, total
        rr = np.repeat(np.arange(n_rows, dtype=np.int32), lens)
        jj = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        src = np.repeat(starts, lens) + jj
        out_row[:total] = rr
        out_col[:total] = np.asarray(indices)[src]
        out_val[:total] = np.asarray(data)[src]
        out_row[total:] = pad_row
        out_col[total:] = 0
        out_val[total:] = 0.0
        return out_row, out_col, out_val, total
    indptr, indices, data = _csr_arrays(indptr, indices, data)
    total = lib.dca_csr_to_flat(_ptr(indptr, _p_i64), _ptr(indices, _p_i32),
                                _ptr(data, _p_f32), _ptr(rows, _p_i64), n_rows, L,
                                np.int32(pad_row), _ptr(out_row, _p_i32),
                                _ptr(out_col, _p_i32), _ptr(out_val, _p_f32))
    return out_row, out_col, out_val, int(total)


def gather_rows(src, rows, out=None):
    """Dense fancy-index row gather: out = src[rows] (f32, parallel)."""
    lib = _load()
    rows = _as_i64(rows)
    if lib is None or not (
        isinstance(src, np.ndarray) and src.ndim == 2 and src.dtype == np.float32
        and src.flags.c_contiguous and _in_range(rows, src.shape[0])
    ):
        return np.ascontiguousarray(np.asarray(src)[rows], dtype=np.float32)
    n_rows = len(rows)
    out = _out_buffer(out, (n_rows, src.shape[1]))
    lib.dca_gather_rows(_ptr(src, _p_f32), _ptr(rows, _p_i64), n_rows, src.shape[1],
                        _ptr(out, _p_f32))
    return out
