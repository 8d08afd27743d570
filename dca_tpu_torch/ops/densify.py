"""Sparse-to-dense on the device, for the streaming trainer and the block
forward.

The port of the JAX package's ``dca_tpu/ops/densify.py``.  Two tiers:

  * the HOST tier: the C++ tier's ``native.densify_rows`` builds the dense
    (B, G) float32 part, which is copied to the device whole;
  * the DEVICE tier (this module, DCA_TPU_DEVICE_DENSIFY): the part crosses
    as a compact CSR payload and is scattered dense on the device, with the
    optional z-scale epilogue (``(x - mean) / std``, sc.pp.scale semantics)
    applied there, so the unscaled input never crosses.

Host builders (the C++ tier, with its numpy fallback): ``payload_from_csr``
(padded (B, K) slabs), ``flat_slots_for`` and ``flat_payload_from_csr`` (a
flat (col, val) stream and per-row counts), ``flat8_payload_from_csr``
(uint8 gaps and values with exception streams; ``Flat8Overflow`` when a
stream outgrows its bucket).  Device scatters: ``device_densify``,
``device_densify_flat`` and ``device_densify_flat8``.

The JAX package's scatters are XLA scatters with ``mode="drop"``, not Pallas
kernels.  Here they are PyTorch ``index_put_`` over a flat output: element
(r, c) of a (B, G) part is slot r * G + c, and every padding slot of a
payload (column ids >= G, or the flat form's row id B) goes to the output's
LAST slot instead, a slot no part reads, so it is never clamped onto a real
column.  ``out`` lets the caller scatter into a buffer it keeps (the
trainer's part buffers, ``train/loop.py``): a 1-D float32 tensor of at least
B * G + 1 elements, whose first B * G elements become the part.  The
payload's (row, col) pairs are unique (canonical CSR), so the scatter needs
no accumulation and its result does not depend on the order of the writes.

The wire dtypes stay compact: int16 column ids where the panel allows, and
the uint16 value stream of raw counts carried as int16 bytes and widened on
the device (``& 0xFFFF``), since ``torch.uint16`` has few kernels.
``repeat_interleave`` gets its ``output_size``, so rebuilding the flat
form's row ids never synchronizes with the host.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import native
from ..data.loader import canonicalize_csr


# ---------------------------------------------------------------------------
# wire <-> device
# ---------------------------------------------------------------------------


def to_wire(a):
    """A host payload array as a CPU tensor of its wire bytes: uint16 goes
    as int16 (the same bytes), the rest as they are."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()  # torch warns on a tensor over a read-only array
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def upload(a, device):
    """Copy a host payload array (numpy or CPU tensor) to ``device``;
    returns the device tensor of its wire bytes.  Already on the device:
    returned as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(device, non_blocking=True)
    return to_wire(a).to(device, non_blocking=True)


def _values(v, uint16):
    """A value stream as float32: the int16 bytes of a uint16 stream are
    widened through int32 and masked, anything else is cast."""
    if uint16:
        return v.to(torch.int32).bitwise_and_(0xFFFF).to(torch.float32)
    return v.to(torch.float32)


def _part(out, n_rows, n_cols, device):
    """The flat output buffer (zeroed over the part) and the index of its
    last slot, where padding goes."""
    n = n_rows * n_cols
    if out is None:
        out = torch.zeros(n + 1, dtype=torch.float32, device=device)
    else:
        if out.dim() != 1 or out.dtype != torch.float32 or out.numel() < n + 1:
            raise ValueError(f"out must be a 1-D float32 tensor of at least {n + 1} "
                             f"elements; got {tuple(out.shape)} {out.dtype}")
        out[:n].zero_()
    return out, out.numel() - 1


def _finish(out, n_rows, n_cols, scale_mean, scale_std):
    x = out[:n_rows * n_cols].view(n_rows, n_cols)
    if scale_mean is not None:
        # the z-scale epilogue on the scattered part: the same two rounded
        # operations as the host tier's (x - mean) / std
        x.sub_(torch.as_tensor(scale_mean, dtype=torch.float32, device=x.device))
        x.div_(torch.as_tensor(scale_std, dtype=torch.float32, device=x.device))
    return x


def device_densify(idx, dat, n_cols, scale_mean=None, scale_std=None, out=None,
                   device=None):
    """Densify a padded CSR payload on the device; optionally with the
    z-scale epilogue.

    idx: (B, K) column ids (int16 or int32 tensor), strictly ascending per
    row, padded with ascending ids >= ``n_cols`` (``native.csr_to_padded``);
    dat: (B, K) values, padded with 0, float32 or uint16 (raw counts,
    widened on the device).  Host arrays are uploaded to ``device``, else to ``out``'s
    device, else to ``scale_mean``'s or the payload's, else kept on the
    CPU.  Returns the dense (B, n_cols) float32 part (a view of ``out`` when
    given)."""
    device = _device_of(device, out, scale_mean, idx)
    uint16 = _is_uint16(dat)
    idx, dat = upload(idx, device), upload(dat, device)
    B, K = idx.shape
    out, trash = _part(out, B, n_cols, device)
    col = idx.to(torch.int64)
    flat = torch.arange(B, device=device, dtype=torch.int64).mul_(n_cols).view(B, 1) + col
    flat.masked_fill_(col >= n_cols, trash)
    out.index_put_((flat.view(-1),), _values(dat, uint16).view(-1))
    return _finish(out, B, n_cols, scale_mean, scale_std)


def _flat_row_ids(counts, n_rows, L, device):
    """Row id of every slot of a flat payload, rebuilt from the per-row
    counts without a read-back: ``counts[n_rows]`` slots of padding get row
    id ``n_rows``."""
    return torch.repeat_interleave(
        torch.arange(n_rows + 1, device=device, dtype=torch.int64),
        counts.to(torch.int64), output_size=L)


def device_densify_flat(counts, col_ids, vals, n_rows, n_cols, scale_mean=None,
                        scale_std=None, out=None, device=None):
    """Densify a flat padded COO payload (``flat_payload_from_csr``) on the
    device; optionally with the z-scale epilogue.

    ``counts`` (B+1 int32: per-row nnz plus one padding entry), ``col_ids``
    (L, int16 when the gene panel < 32768, else int32), ``vals`` (L,
    float32 or a uint16 stream).  The row ids are rebuilt on the device from
    ``counts``; padding slots (row id B) go to the output's last slot.
    ``device`` as for ``device_densify``."""
    device = _device_of(device, out, scale_mean, col_ids)
    uint16 = _is_uint16(vals)
    counts, col_ids, vals = (upload(a, device) for a in (counts, col_ids, vals))
    n_rows, n_cols = int(n_rows), int(n_cols)
    L = col_ids.shape[0]
    out, trash = _part(out, n_rows, n_cols, device)
    rows = _flat_row_ids(counts, n_rows, L, device)
    flat = rows * n_cols + col_ids.to(torch.int64)
    flat.masked_fill_(rows >= n_rows, trash)
    out.index_put_((flat,), _values(vals, uint16))
    return _finish(out, n_rows, n_cols, scale_mean, scale_std)


def flat_slots_for(M, rows, moments=None, nnz=None):
    """Flat-payload slot count for ``rows`` of CSR ``M``.

    A function of the ROW COUNT and the matrix's row-nnz moments (not the
    sampled rows), so repeated same-size parts share one payload shape; a
    draw above 8 standard deviations climbs a x1.25 ladder.  Pass
    ``moments=(mean, std)`` and the per-row ``nnz`` vector to skip the
    O(n_cells) ``np.diff`` (the loader caches both)."""
    if nnz is None:
        nnz = np.diff(M.indptr)
    if moments is None:
        moments = (float(nnz.mean()), float(nnz.std()))
    mean, std = moments
    b = len(rows)
    L = int(b * mean + 8.0 * np.sqrt(b) * std) + 64
    total = int(nnz[np.asarray(rows, np.int64)].sum())
    while total > L:
        L = int(L * 1.25) + 64
    return L


def flat_payload_from_csr(X, rows, L, int_vals=False):
    """Build the flat (counts, cols, vals) payload of CSR rows through the
    C++ tier (numpy fallback inside ``native.csr_to_flat``).  ``L`` is the
    padded slot count; raises if the rows' nnz exceed it.  Column ids go as
    int16 where the panel allows; ``int_vals=True`` (the caller asserts
    integer values in [0, 65535): raw counts) sends values as uint16.  Both
    halve their stream's bytes, losslessly."""
    canonicalize_csr(X)
    rows = np.asarray(rows, np.int64)
    _, c, v, total = native.csr_to_flat(
        X.indptr, X.indices, X.data, rows, int(L), len(rows)
    )
    if total > L:
        raise ValueError(f"flat payload overflow: nnz {total} > L {L}")
    lens = np.diff(X.indptr)[rows].astype(np.int64)
    counts = np.empty(len(rows) + 1, np.int32)
    counts[:-1] = lens
    counts[-1] = L - total
    if X.shape[1] < np.iinfo(np.int16).max:
        c = c.astype(np.int16)
    if int_vals:
        v = v.astype(np.uint16)
    return counts, c, v


def device_densify_flat8(c, scale_mean=None, scale_std=None, out=None, device=None):
    """Densify a ``Flat8Chunk`` (``data/loader.py``) on the device;
    optionally with the z-scale epilogue.

    Wire format (``flat8_payload_from_csr``), ~2 bytes a nonzero:
      counts   (B+1,) int32  per-row nnz and one padding entry
      firstcol (B,)  int16   column of each row's first nonzero
      gaps     (L,)  uint8   within-row column deltas (0 at row starts)
      vals     (L,)  uint8   values (0 where an exception carries it)
      gpos/gval (Lg,) int32  positions and true values of gaps >= 256
      vpos/vval (Lv,) int32/f32  positions and true values outside uint8
    The exception streams are padded with position L, which lands in a
    spare last slot of the decoded stream.  The columns are rebuilt with one
    cumulative sum over the gap stream minus each row's base, the row ids
    from the counts as in the flat form.  ``device`` as for
    ``device_densify``."""
    device = _device_of(device, out, scale_mean, c.counts)
    counts, firstcol, gaps, vals, gpos, gval, vpos, vval = (
        upload(a, device) for a in (c.counts, c.firstcol, c.gaps, c.vals,
                                    c.gpos, c.gval, c.vpos, c.vval))
    n_rows, n_cols = c.n_rows, c.n_cols
    L = gaps.shape[0]
    counts = counts.to(torch.int64)
    rows = _flat_row_ids(counts, n_rows, L, device)
    g = torch.zeros(L + 1, dtype=torch.int64, device=device)
    g[:L] = gaps.to(torch.int64)
    g.index_put_((gpos.to(torch.int64),), gval.to(torch.int64))
    g = g[:L]
    P = torch.cumsum(g, 0)
    P_excl = P - g
    starts = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts[:-1], 0, out=starts[1:])
    base = torch.repeat_interleave(P_excl[starts.clamp(max=L - 1)], counts, output_size=L)
    fc = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    fc[:n_rows] = firstcol.to(torch.int64)
    cols = torch.repeat_interleave(fc, counts, output_size=L) + (P - base)
    v = torch.zeros(L + 1, dtype=torch.float32, device=device)
    v[:L] = vals.to(torch.float32)
    v.index_put_((vpos.to(torch.int64),), vval.to(torch.float32))
    out, trash = _part(out, n_rows, n_cols, device)
    flat = rows * n_cols + cols
    flat.masked_fill_((rows >= n_rows) | (cols < 0) | (cols >= n_cols), trash)
    out.index_put_((flat,), v[:L])
    return _finish(out, n_rows, n_cols, scale_mean, scale_std)


class Flat8Overflow(ValueError):
    """An exception stream outgrew its bucket; carries the sizes needed so
    the loader can ladder up and retry."""

    def __init__(self, need_g, need_v):
        super().__init__(f"flat8 exception overflow g={need_g} v={need_v}")
        self.need_g, self.need_v = need_g, need_v


def flat8_payload_from_csr(X, rows, L, Lg, Lv):
    """Build the flat8 payload of CSR ``rows`` (see
    ``device_densify_flat8``).

    ``L`` is the flat slot bucket (``flat_slots_for``), ``Lg``/``Lv`` the
    gap and value exception buckets.  Raises ``Flat8Overflow`` when an
    exception stream does not fit (the loader ladders the bucket and
    retries) and ValueError when the slots overflow.  Lossless for any
    float32 values (those outside uint8, non-integers included, ride the
    exception stream), though it only saves bytes when most values are
    small integers (raw counts)."""
    canonicalize_csr(X)
    rows = np.asarray(rows, np.int64)
    _, c, v, total = native.csr_to_flat(
        X.indptr, X.indices, X.data, rows, int(L), len(rows)
    )
    if total > L:
        raise ValueError(f"flat payload overflow: nnz {total} > L {L}")
    lens = np.diff(X.indptr)[rows].astype(np.int64)
    B = len(rows)
    counts = np.empty(B + 1, np.int32)
    counts[:-1] = lens
    counts[-1] = L - total

    starts = np.zeros(B, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    cc = c[:total].astype(np.int64)
    d = np.zeros(total, np.int64)
    if total > 1:
        d[1:] = cc[1:] - cc[:-1]
    nz = lens > 0
    d[starts[nz]] = 0  # row starts carry the gap placeholder

    gexc = np.nonzero(d > 255)[0]
    vv = v[:total]
    vmask = (vv < 0) | (vv > 255) | (vv != np.floor(vv))
    vexc = np.nonzero(vmask)[0]
    if len(gexc) > Lg or len(vexc) > Lv:
        raise Flat8Overflow(len(gexc), len(vexc))

    gaps = np.zeros(L, np.uint8)
    gaps[:total] = np.where(d > 255, 0, d).astype(np.uint8)
    gpos = np.full(Lg, L, np.int32)
    gpos[: len(gexc)] = gexc
    gval = np.zeros(Lg, np.int32)
    gval[: len(gexc)] = d[gexc]

    vals = np.zeros(L, np.uint8)
    vals[:total] = np.where(vmask, 0, vv).astype(np.uint8)
    vpos = np.full(Lv, L, np.int32)
    vpos[: len(vexc)] = vexc
    vval = np.zeros(Lv, np.float32)
    vval[: len(vexc)] = vv[vexc]

    fc_dtype = np.int16 if X.shape[1] < np.iinfo(np.int16).max else np.int32
    firstcol = np.zeros(B, fc_dtype)
    firstcol[nz] = cc[starts[nz]].astype(fc_dtype)
    return counts, firstcol, gaps, vals, gpos, gval, vpos, vval


def payload_from_csr(X, rows, K=None, int_vals=False):
    """Build the padded (idx, dat) payload of CSR rows through the C++
    tier.

    ``K`` (the slot width) defaults to the widest selected row; pass the
    matrix-wide maximum so every part of a stream has one shape.
    Canonicalizes the matrix once (sorted, deduplicated indices)."""
    canonicalize_csr(X)
    rows = np.asarray(rows, np.int64)
    if K is None:
        nnz = np.diff(X.indptr)[rows] if len(rows) else np.zeros(1, np.int64)
        K = max(int(nnz.max()) if nnz.size else 0, 1)
    idx, dat = native.csr_to_padded(
        X.indptr, X.indices, X.data, rows, int(K), X.shape[1]
    )
    # halve the wire bytes losslessly where the ranges allow (padding ids
    # ascend up to n_cols + K, so the id bound includes K)
    if X.shape[1] + int(K) < np.iinfo(np.int16).max:
        idx = idx.astype(np.int16)
    if int_vals:
        dat = dat.astype(np.uint16)
    return idx, dat


def densify_csr(indptr, indices, data, n_cols, *, rows=None, device="cpu"):
    """Densify a scipy-style CSR triplet on ``device`` through
    ``payload_from_csr`` and ``device_densify``; returns (B, n_cols)
    float32."""
    indptr = np.asarray(indptr, np.int64)
    B = len(indptr) - 1
    m = sp.csr_matrix(
        (np.asarray(data, np.float32), np.asarray(indices), indptr),
        shape=(B, n_cols),
    )
    if rows is None:
        rows = np.arange(B, dtype=np.int64)
    idx, dat = payload_from_csr(m, rows)
    out = torch.empty(len(rows) * n_cols + 1, dtype=torch.float32, device=device)
    return device_densify(idx, dat, n_cols, out=out)


def _device_of(device, out, scale_mean, payload):
    if device is not None:
        return torch.device(device)
    for t in (out, scale_mean, payload):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def _is_uint16(a):
    """A host uint16 value stream, which crosses as its int16 bytes."""
    return isinstance(a, np.ndarray) and a.dtype == np.uint16
