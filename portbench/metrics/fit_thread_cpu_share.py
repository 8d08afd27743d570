"""fit_thread_cpu_share: the share of the wall in which the fit's thread
ran on a CPU: its CPU seconds (the program's ``cpu.fit`` counter,
``time.thread_time`` after each epoch) between the first and the last
reading of the traced fit's epochs that ended before the profiler's start
was called (``fit["unprofiled_epochs"]``; all of them where none did),
over the wall between those readings, from the program's record of the
timed fit (``ctx.timeline``).  None where that stretch is shorter than
``MIN_STRETCH_S``: the card host's thread clock steps by 10 ms, so a
shorter stretch reads coarsely."""

from harness.record import main_fit, unprofiled

MIN_STRETCH_S = 1.0


def read(ctx):
    rec = getattr(ctx, "timeline", None)
    fit = main_fit(rec)
    if fit is None:
        return None
    keep = unprofiled(ctx.fit)
    marks = sorted((c.t, c.n) for c in rec.counts
                   if c.fit == fit and c.name == "cpu.fit" and keep(c.epoch))
    if len(marks) < 2 or marks[-1][0] - marks[0][0] < MIN_STRETCH_S:
        return None
    (t0, c0), (t1, c1) = marks[0], marks[-1]
    return (c1 - c0) / (t1 - t0)
