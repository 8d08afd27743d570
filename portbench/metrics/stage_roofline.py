"""stage_roofline: the staging of a streamed part against its bound, in %:
over the traced fit's epochs that ended before the profiler's start was
called (``fit["unprofiled_epochs"]``; all of them where none did), the
sum of the bounds of the ``dca.stream.stage`` spans over the sum of their
device times, from the program's record of the timed fit
(``ctx.timeline``).  A stage span is the side stream's time over the
part's staging, from CUDA events (``timeline.device_span``); its bound is
the host bytes the program copied for the part (its ``stream.bytes``
count, by epoch and part) over the host link's peak, plus the dense bytes
the stage must move at least over the HBM rate: the part's input and
target written once and the target read once (the input derived from
it), ``rows`` x genes x 4 bytes x 3.  The staging is PyTorch's copies and
scatters, no kernel of the port's own: the reading says how far they are
from the copy and the dense write they stand for.  None without a record,
without stage spans (the CPU, which records none) or without their
``rows`` and ``stream.bytes`` (a program that records neither)."""

from harness.arith import HBM_BYTES_PER_S
from harness.record import main_fit, unprofiled

# the H100 SXM's host link, PCIe Gen5 x16: 64 GB/s each way (NVIDIA's data
# sheet: 128 GB/s both ways), of which 128b/130b coding leaves ~63 GB/s
# for data
LINK_BYTES_PER_S = 64e9
DENSE_PASSES = 3  # x and t written once, t read once


def read(ctx):
    rec = getattr(ctx, "timeline", None)
    fit = main_fit(rec)
    if fit is None:
        return None
    keep = unprofiled(ctx.fit)
    sent = {(c.epoch, c.attrs.get("part")): c.n for c in rec.counts
            if c.fit == fit and c.name == "stream.bytes" and keep(c.epoch)}
    bound = spent = 0.0
    for s in rec.spans:
        if s.fit != fit or s.name != "dca.stream.stage" or not keep(s.epoch):
            continue
        n = sent.get((s.epoch, s.attrs.get("part")))
        rows = s.attrs.get("rows")
        if n is None or rows is None:
            continue
        bound += n / LINK_BYTES_PER_S + rows * ctx.genes * 4 * DENSE_PASSES / HBM_BYTES_PER_S
        spent += s.dur
    if spent <= 0:
        return None
    return 100.0 * bound / spent
