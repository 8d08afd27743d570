"""replay_host_us: the host's time to enqueue one step's graph replay, in
us: the median, over the traced fit's epochs that ended before the
profiler's start was called (``fit["unprofiled_epochs"]``; all of them
where none did), of each epoch's ``dca.fit.steps`` span over the
``graphs.replays`` counts in it, from the program's record of the timed
fit (``ctx.timeline``).  None without a record, without the span, or
where no step was replayed from a graph (the CPU)."""

import statistics

from harness.record import main_fit, unprofiled


def read(ctx):
    rec = getattr(ctx, "timeline", None)
    fit = main_fit(rec)
    if fit is None:
        return None
    keep = unprofiled(ctx.fit)
    steps, replays = {}, {}
    for s in rec.spans:
        if s.fit == fit and s.name == "dca.fit.steps" and keep(s.epoch):
            steps[s.epoch] = steps.get(s.epoch, 0.0) + s.dur
    for c in rec.counts:
        if c.fit == fit and c.name == "graphs.replays" and keep(c.epoch):
            replays[c.epoch] = replays.get(c.epoch, 0) + c.n
    per = [steps[e] / replays[e] for e in steps if replays.get(e)]
    return 1e6 * statistics.median(per) if per else None
