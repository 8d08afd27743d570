"""Device-resident corpus for the streaming trainer.

The port of the JAX package's ``dca_tpu/ops/resident.py``.  When the
compressed corpus fits on the device, the raw-count CSR goes up ONCE (int16
columns and uint16 values, ~4 bytes a nonzero) and every shuffled part's
dense (B, G) target and input are rebuilt on the device: a gather of the
part's rows into the padded (B, K) payload layout, the scatter of
``ops/densify.py``, and the derived input x = (log1p(t * m_r) - mu) / sd
(``train/loop.py::_derivable_row_scale``), so that an epoch moves only the
shuffled row ids from the host.

A CSR row is contiguous, so the gather reads each part row's K slots as
one slice: row s of the unfolded view ``col.unfold(0, K, 1)`` (an
overlapping, stride-1 view, no copy) is ``col[s:s + K]``, and indexing it
with the rows' starts gathers B slices, masked to k < lens[rows[r]].  On
an H100 that slice form rebuilds a part's target faster than the
element-wise gather of ``col[starts[rows, None] + arange(K)]``, which
first writes the B x K int64 offsets (PERF.md, ``chip_smoke.py`` phase 10).
``col``/``val`` carry K trailing pad elements so the last rows' slices
stay in bounds.  Padding slots go to the output's last slot, as the
scatter's do.  A part is gathered in blocks of rows whose padded slots'
transient stays within a byte budget (``part_bytes``), so one wide row
(K in the thousands on a corpus at full gene width) does not size a
whole part's transient.  The same canonical columns and raw values as
the wire path's payloads, the same scatter and the same derive give the
streamed derive tier's trajectory bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import canonicalize_csr
from .densify import _part, to_wire

# Transient device bytes of ``part`` per padded slot (B x K), at its peak,
# counted from ``target``: the int64 flat scatter indices (8) live
# throughout; beside them first the gathered int16 columns (2) and the bool
# mask and its negation (1 + 1), then the gathered int16 values (2), their
# int32 widening (4) and their float32 values (4): 18, rounded up to 24 for
# the caching allocator's block rounding.  ``ResidentCSR`` sizes its row
# blocks from it and the trainer's auto gate a row's transient
# (``train/loop.py``); ``chip_smoke.py`` phase 10 measures it.
PART_BYTES_PER_SLOT = 24


class ResidentCSR:
    """Upload a raw-count CSR corpus to ``device`` once; stage shuffled
    dense parts from it with no per-part host work or payload transfer.

    Only the TARGET's values are stored: the normalized input is derived on
    the device from the trainer's verified per-row multiplier ``m``.  The
    trainer engages it inside the DCA_TPU_RESIDENT_MIN_BYTES ..
    DCA_TPU_RESIDENT_BYTES budget; DCA_TPU_RESIDENT=1/0 forces it.
    ``part_bytes``: the transient a block of a part's rows may take
    (``PART_BYTES_PER_SLOT`` a padded slot, at least one row a block);
    None gathers a part in one block.
    """

    def __init__(self, T, m, sf, scale_mean, scale_std, device, part_bytes=None):
        canonicalize_csr(T)
        device = torch.device(device)
        self.device = device
        self.n, self.G = T.shape
        assert T.nnz < np.iinfo(np.int32).max, "resident CSR needs nnz < 2^31"
        lens = np.diff(T.indptr).astype(np.int64)
        self.K = max(int(lens.max()) if lens.size else 0, 1)
        self.block_rows = (None if part_bytes is None
                           else max(int(part_bytes) // (self.K * PART_BYTES_PER_SLOT), 1))
        col = T.indices
        col = col.astype(np.int16) if self.G < np.iinfo(np.int16).max else col.astype(np.int32)
        d = T.data
        self.uint16 = bool(d.size and np.all(d >= 0) and d.max() < np.iinfo(np.uint16).max
                           and np.all(np.floor(d) == d))
        val = d.astype(np.uint16) if self.uint16 else d.astype(np.float32)
        # K trailing pad elements keep the last rows' reads in bounds;
        # masked, never read as data
        col = np.concatenate([col, np.zeros(self.K, col.dtype)])
        val = np.concatenate([val, np.zeros(self.K, val.dtype)])

        def put(a):
            return to_wire(a).to(device)

        self.starts_d = put(T.indptr[:-1].astype(np.int64))
        self.lens_d = put(lens)
        self.col_d, self.val_d = put(col), put(val)
        self.m_d = put(np.asarray(m, np.float32))
        self.sf_d = put(np.asarray(sf, np.float32))
        self.mu_d = put(np.asarray(scale_mean, np.float32))
        self.sd_d = put(np.asarray(scale_std, np.float32))
        self._k = torch.arange(self.K, device=device, dtype=torch.int64)
        # row s of these views is the K-slot slice starting at element s
        self.col_rows = self.col_d.unfold(0, self.K, 1)
        self.val_rows = self.val_d.unfold(0, self.K, 1)

    @staticmethod
    def payload_bytes(T):
        """Resident device footprint for the gate: columns and values, and
        the per-row vectors (int64 starts and lens, float32 m and sf: 24
        bytes a row), with the dtypes ``__init__`` picks.  The K trailing
        pad elements are left out (negligible unless one row holds most of
        the nonzeros)."""
        col_b = 2 if T.shape[1] < np.iinfo(np.int16).max else 4
        # value integrality is checked for real in __init__; assume the
        # compact stream here (a float32 fallback doubles one term only)
        return int(T.nnz) * (col_b + 2) + int(T.shape[0]) * 24

    def _rows(self, rows):
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
        return rows.to(self.device, non_blocking=True)

    def target(self, rows, t_out=None):
        """The dense raw-count target (B, G) of ``rows`` (a device int64
        tensor), built in ``t_out`` when given (a 1-D float32 buffer of at
        least B * G + 1 elements, the last taking the padding), a block of
        ``block_rows`` rows at a time."""
        dev = self.device
        B, G = rows.shape[0], self.G
        t_out, trash = _part(t_out, B, G, dev)
        step = max(self.block_rows or B, 1)
        for lo in range(0, B, step):
            r = rows[lo:lo + step]
            b = r.shape[0]
            starts = self.starts_d[r]
            mask = self._k < self.lens_d[r].view(b, 1)
            flat = self.col_rows[starts].to(torch.int64)
            flat += torch.arange(lo, lo + b, device=dev, dtype=torch.int64).mul_(G).view(b, 1)
            flat.masked_fill_(~mask, trash)
            del mask
            vals = self.val_rows[starts]
            vals = (vals.to(torch.int32).bitwise_and_(0xFFFF).to(torch.float32) if self.uint16
                    else vals.to(torch.float32))
            t_out.index_put_((flat.view(-1),), vals.view(-1))
            del flat, vals
        return t_out[:B * G].view(B, G)

    def part(self, rows, x_out=None, t_out=None, sf_out=None):
        """Stage one part: device (x, t, sf) for ``rows`` (host int array
        or device int64 tensor).  ``x_out``/``t_out``: 1-D float32 buffers
        of at least B * G + 1 elements to build x and t in (the trainer's
        part buffers; the last element takes the padding), ``sf_out`` one of
        at least B elements."""
        rows = self._rows(rows)
        B, G = rows.shape[0], self.G
        t = self.target(rows, t_out)
        if x_out is None:
            x_out = torch.empty(B * G + 1, dtype=torch.float32, device=self.device)
        x = derive_input(t, self.m_d[rows], self.mu_d, self.sd_d, x_out[:B * G].view(B, G))
        if sf_out is None:
            sf = self.sf_d[rows]
        else:
            sf = sf_out[:B]
            torch.index_select(self.sf_d, 0, rows, out=sf)
        return x, t, sf


def derive_input(t, m, mu, sd, out=None):
    """The normalized input of a raw-count part: (log1p(t * m_r) - mu) / sd,
    each a rounded float32 operation, into ``out`` when given."""
    x = torch.mul(t, m.view(-1, 1), out=out)
    return x.log1p_().sub_(mu).div_(sd)
