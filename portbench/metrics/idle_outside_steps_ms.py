"""idle_outside_steps_ms: the device's idle time an epoch outside the
host's enqueue of the steps, in ms, in the traced slice: the gaps in the
union of the slice's kernels, copies and memsets that lie outside every
``dca.fit.steps`` annotation (the program's span of an epoch's step
replays, ``dca_tpu_torch/timeline.py``), between the ends of the slice's
first and last ``dca.fit.fetch`` annotation (an epoch ends with its
read-back), over the epochs between them: the turnaround of the
validation, the read-back, the callbacks and the next row order.  None
where the slice holds fewer than two read-backs or no steps span (a
program without the spans)."""


def _uncovered(spans, lo, hi):
    """[(a, b)] of [lo, hi] outside the sorted, disjoint ``spans``."""
    out, at = [], lo
    for a, b in spans:
        if b <= at:
            continue
        if a >= hi:
            break
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return out


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    notes = [(name, ts, ts + dur) for name, ts, dur, cat in tr.host if cat == "user_annotation"]
    ends = sorted(t1 for name, _, t1 in notes if name == "dca.fit.fetch" and tr.t0 <= t1 <= tr.t1)
    steps = _union((t0, t1) for name, t0, t1 in notes if name == "dca.fit.steps")
    if len(ends) < 2 or not steps:
        return None
    lo, hi = ends[0], ends[-1]
    idle_s = 0.0
    for a, b in _uncovered(_union(map(tuple, tr.busy_intervals())), lo, hi):
        idle_s += sum(y - x for x, y in _uncovered(steps, a, b))
    return 1e3 * idle_s / (len(ends) - 1)
