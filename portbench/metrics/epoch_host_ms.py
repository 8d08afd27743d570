"""epoch_host_ms: the host's own time an epoch, in ms: the median, over the
traced fit's epochs that ended before the profiler's start was called
(``fit["unprofiled_epochs"]``; all of them where none did), of each
epoch's ``dca.fit.epoch`` span less its ``dca.fit.fetch`` (the read-back,
where the host waits for the device), from the program's record of the
timed fit (``ctx.timeline``, ``dca_tpu_torch/timeline.py``).  None
without a record or without those spans."""

import statistics

from harness.record import main_fit, unprofiled


def read(ctx):
    rec = getattr(ctx, "timeline", None)
    fit = main_fit(rec)
    if fit is None:
        return None
    keep = unprofiled(ctx.fit)
    epoch, fetch = {}, {}
    for s in rec.spans:
        if s.fit == fit and keep(s.epoch):
            if s.name == "dca.fit.epoch":
                epoch[s.epoch] = s.dur
            elif s.name == "dca.fit.fetch":
                fetch[s.epoch] = fetch.get(s.epoch, 0.0) + s.dur
    host = [epoch[e] - fetch[e] for e in epoch if e in fetch]
    return 1e3 * statistics.median(host) if host else None
