"""stream_wait_share: the share of a streamed epoch in which the step
waits for the staging: over the traced fit's epochs that ended before the
profiler's start was called (``fit["unprofiled_epochs"]``; all of them
where none did), the sum of the ``dca.stream.wait`` spans on the fit's
thread (the thread of its ``dca.fit.epoch`` spans) over the sum of those
epochs' ``dca.fit.epoch`` spans, from the program's record of the timed
fit (``ctx.timeline``, ``dca_tpu_torch/timeline.py``).  None without a
record or on an in-memory fit (no ``dca.stream.*`` span).

``span_share`` is the reading of any such span, on the fit's thread or
off it; ``prep_busy_share`` reads the prefetch thread's preps with it."""

from harness.record import main_fit, unprofiled


def span_share(ctx, name, on_fit_thread):
    """Σ ``name`` spans on the fit's thread (``on_fit_thread``) or on any
    other, over Σ ``dca.fit.epoch``, both over the unprofiled epochs of the
    traced fit; 0 where a streamed fit records no such span, None without
    a record, without those epochs or on an in-memory fit."""
    rec = getattr(ctx, "timeline", None)
    fit = main_fit(rec)
    if fit is None:
        return None
    spans = [s for s in rec.spans if s.fit == fit]
    if not any(s.name.startswith("dca.stream.") for s in spans):
        return None
    keep = unprofiled(ctx.fit)
    epochs = [s for s in spans if s.name == "dca.fit.epoch" and keep(s.epoch)]
    threads = {s.tid for s in epochs}
    total = sum(s.dur for s in epochs)
    if total <= 0:
        return None
    return sum(s.dur for s in spans if s.name == name and keep(s.epoch)
               and (s.tid in threads) == on_fit_thread) / total


def read(ctx):
    return span_share(ctx, "dca.stream.wait", True)
