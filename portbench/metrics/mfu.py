"""mfu: the whole step's share of the float32 peak, in %: the model's
matrix-product FLOPs of an epoch (every training row's step and every
validation row's forward, counted from the widths, ``harness/arith.py``)
over the epoch's wall (``History.epoch_s``) and 67 TFLOP/s, over the
traced fit's epochs that ended before the profiler first started (the
whole fit where none did).  Not the slice's own time: a profiler session
slows the process's graph launches for the rest of its life (PERF.md).
Taken from the host clock, so it stays when a kernel leaves the path."""

from harness.arith import F32_OPS_PER_S


def read(ctx):
    fit = ctx.fit
    if not fit:
        return None
    k = fit["clean_epochs"]
    if k >= 1:
        flops, seconds = k * fit["epoch_flops"], sum(fit["epoch_s"][:k])
    else:
        flops, seconds = fit["flops"], fit["wall_s"]
    if seconds <= 0:
        return None
    return 100.0 * flops / (seconds * F32_OPS_PER_S)
