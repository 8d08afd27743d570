"""TensorBoard event files without TensorFlow: the port's copy of the JAX
package's ``dca_tpu/tbevents.py``, byte for byte in what it writes.

``train(tensorboard=True)`` logs per-epoch scalars (loss, val_loss, lr)
and weight and gradient histograms, the counterpart of the reference's
Keras ``TensorBoard(histogram_freq=1, write_grads=True)`` callback, as
standard ``events.out.tfevents.*`` files that a stock TensorBoard plots.
The two protobuf messages involved (Event, Summary / HistogramProto) are
serialized by hand and framed as TFRecords with masked CRC32C checksums.

Wire formats:
  * protobuf: varint / length-delimited / fixed32 / fixed64 fields of
    tensorflow/core/util/event.proto and framework/summary.proto;
  * TFRecord: <uint64 len LE><masked crc32c(len)><payload><masked
    crc32c(payload)>, mask(crc) = ((crc>>15 | crc<<17) + 0xa282ead8) & 2^32-1.

``read_events`` parses a file back into scalars (histograms as markers);
``read_histograms`` gives each histogram's statistics (min, max, num, sum,
sum of squares), which the tests compare across packages.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — table-driven, reflected, poly 0x82f63b78
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f64(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _packed_doubles(field: int, vals) -> bytes:
    return _bytes_field(field, b"".join(struct.pack("<d", float(v)) for v in vals))


# ---------------------------------------------------------------------------
# message builders (event.proto / summary.proto field numbers)
# ---------------------------------------------------------------------------


def _event(wall_time: float, *, step: int | None = None,
           file_version: str | None = None, summary: bytes | None = None) -> bytes:
    msg = _f64(1, wall_time)                       # Event.wall_time
    if step is not None:
        msg += _key(2, 0) + _varint(step)          # Event.step
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())  # Event.file_version
    if summary is not None:
        msg += _bytes_field(5, summary)            # Event.summary
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _bytes_field(1, tag.encode()) + _f32(2, float(value))
    return _bytes_field(1, val)                    # Summary.value (repeated)


def _histogram_proto(values: np.ndarray) -> bytes:
    """HistogramProto with TensorBoard's standard exponential buckets."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros(1)
    # TF's default bucket edges: +-1e-12 * 1.1^k geometric series, grown
    # from max(|v|) so all-negative tensors (a bias drifting negative) get
    # real negative buckets instead of one catch-all
    vmax = np.abs(v).max(initial=0.0)
    limits = [1e-12]
    while limits[-1] < vmax * 1.1 + 1e-12 and len(limits) < 776:
        limits.append(limits[-1] * 1.1)
    neg = [-l for l in reversed(limits)]
    edges = np.asarray(neg + limits + [np.finfo(np.float64).max])
    counts, _ = np.histogram(v, bins=np.concatenate(([-np.finfo(np.float64).max], edges)))
    # drop empty leading/trailing buckets (TB does the same; keeps files small)
    nz = np.nonzero(counts)[0]
    lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 1)
    msg = _f64(1, float(v.min())) + _f64(2, float(v.max()))
    msg += _f64(3, float(v.size)) + _f64(4, float(v.sum()))
    msg += _f64(5, float(np.square(v).sum()))
    msg += _packed_doubles(6, edges[lo:hi])
    msg += _packed_doubles(7, counts[lo:hi])
    return msg


def _histo_summary(tag: str, values: np.ndarray) -> bytes:
    val = _bytes_field(1, tag.encode()) + _bytes_field(5, _histogram_proto(values))
    return _bytes_field(1, val)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class EventWriter:
    """Append-only TensorBoard event file under ``logdir``.

    Usage::

        w = EventWriter(outdir)
        w.scalar("loss", 1.23, step=0)
        w.histogram("enc0/kernel", np.asarray(k), step=0)
        w.close()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int):
        self._record(_event(time.time(), step=step,
                            summary=_scalar_summary(tag, value)))

    def histogram(self, tag: str, values, step: int):
        self._record(_event(time.time(), step=step,
                            summary=_histo_summary(tag, np.asarray(values))))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str):
    """Parse an event file back into [(step, {tag: value})] — used by the
    tests to assert the written scalars round-trip; also handy for quick
    inspection without a TensorBoard install.  Histograms are returned as
    tag -> 'histogram' markers."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12 : pos + 12 + length]
        pos += 12 + length + 4
        step, scalars = 0, {}
        # walk Event fields
        p = 0
        summary = None
        while p < len(payload):
            key = payload[p]
            field, wire = key >> 3, key & 7
            p += 1
            if wire == 0:
                v = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    v |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 2:
                    step = v
            elif wire == 1:
                p += 8
            elif wire == 5:
                p += 4
            elif wire == 2:
                ln = 0
                shift = 0
                while True:
                    b = payload[p]
                    p += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                if field == 5:
                    summary = payload[p : p + ln]
                p += ln
        if summary:
            q = 0
            while q < len(summary):
                # Summary.value entries
                assert summary[q] == 0x0A
                q += 1
                ln = 0
                shift = 0
                while True:
                    b = summary[q]
                    q += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                val = summary[q : q + ln]
                q += ln
                r = 0
                tag, value = None, None
                while r < len(val):
                    key = val[r]
                    field, wire = key >> 3, key & 7
                    r += 1
                    if wire == 2:
                        ln2 = 0
                        shift = 0
                        while True:
                            b = val[r]
                            r += 1
                            ln2 |= (b & 0x7F) << shift
                            shift += 7
                            if not b & 0x80:
                                break
                        if field == 1:
                            tag = val[r : r + ln2].decode()
                        elif field == 5:
                            value = "histogram"
                        r += ln2
                    elif wire == 5:
                        if field == 2:
                            (value,) = struct.unpack_from("<f", val, r)
                        r += 4
                    elif wire == 1:
                        r += 8
                    elif wire == 0:
                        while val[r] & 0x80:
                            r += 1
                        r += 1
                if tag is not None:
                    scalars[tag] = value
            out.append((step, scalars))
    return out


def _fields(msg: bytes):
    """Yield (field, wire, value) of a protobuf message: an int for varints,
    the raw bytes of fixed and length-delimited fields."""
    p = 0
    while p < len(msg):
        key, p = _read_varint(msg, p)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, p = _read_varint(msg, p)
        elif wire == 1:
            value, p = msg[p:p + 8], p + 8
        elif wire == 5:
            value, p = msg[p:p + 4], p + 4
        else:
            ln, p = _read_varint(msg, p)
            value, p = msg[p:p + ln], p + ln
        yield field, wire, value


def _read_varint(buf: bytes, p: int):
    v = shift = 0
    while True:
        b = buf[p]
        p += 1
        v |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return v, p


def read_histograms(path: str):
    """{(step, tag): {"min", "max", "num", "sum", "sum_squares"}} of every
    histogram in an event file."""
    out = {}
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12: pos + 12 + length]
        pos += 12 + length + 4
        step, summary = 0, b""
        for field, _, value in _fields(payload):
            if field == 2:
                step = value
            elif field == 5:
                summary = value
        for _, _, val in _fields(summary):
            tag = histo = None
            for field, _, value in _fields(val):
                if field == 1:
                    tag = value.decode()
                elif field == 5:
                    histo = value
            if tag is None or histo is None:
                continue
            stats = {}
            for field, wire, value in _fields(histo):
                if wire == 1 and 1 <= field <= 5:
                    stats[("min", "max", "num", "sum", "sum_squares")[field - 1]] = \
                        struct.unpack("<d", value)[0]
            out[(step, tag)] = stats
    return out
