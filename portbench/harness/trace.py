"""The traced run's device trace: ``torch.profiler`` over a short steady
slice of the timed fit, and what the metric readers read from it.

The fit is one ``train()`` call, so the slice is cut at the fit's own
points of progress: the program calls the function that
``dca_tpu_torch.parallel.launch.posting`` installs for the thread at each
epoch's end and at each streamed part it dispatches (its progress rule
for process groups).  ``SliceTracer`` is such a function: at the first
point ``lead_s`` after the call started it calls ``before_start`` (where
set), starts the profiler and opens a ``portbench.slice`` span, and at
the first point ``slice_s`` later it closes both, all on the fit's own
thread.  The device's kernels, copies
and memsets and the host's CUDA runtime calls and operations go through
the profiler's Chrome-trace file, written under TMPDIR after the fit,
read and removed (torch 2.11's kineto events carry no category).
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op", "user_annotation")
SLICE_SPAN = "portbench.slice"


class SliceTracer:
    """The slice's profiler, driven by the fit's points of progress
    (module docstring).  ``arm()`` at the timed call's start; ``finish()``
    after it returns the parsed ``Trace``, or None where no slice was
    taken."""

    failed = None  # the progress rule's check, which a benchmark has none of
    before_start = None  # called just before the profiler starts

    def __init__(self, lead_s, slice_s):
        self.lead_s, self.slice_s = lead_s, slice_s
        self.prof = self.span = None
        self.t_arm = self.t_begin = self.t_start = None
        self.done = False
        self.overhead_s = 0.0  # the fit's time spent starting and stopping the profiler

    def arm(self):
        self.t_arm = time.perf_counter()

    def __call__(self):
        if self.done or self.t_arm is None:
            return
        now = time.perf_counter()
        if self.prof is None and now >= self.t_arm + self.lead_s:
            from torch.profiler import ProfilerActivity, profile, record_function

            self.t_begin = now  # before the profiler's own start, which takes seconds
            if self.before_start is not None:
                self.before_start()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.span = record_function(SLICE_SPAN)
            self.span.__enter__()
            self.t_start = time.perf_counter()  # after the profiler's own start
        elif self.prof is not None and now >= self.t_start + self.slice_s:
            self._stop()
        self.overhead_s += time.perf_counter() - now

    def _stop(self):
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    @property
    def lead_taken_s(self):
        """Seconds from the call's start to the slice's, None before."""
        return None if self.t_start is None else self.t_start - self.t_arm

    @property
    def lead_begun_s(self):
        """Seconds from the call's start to the profiler's start call, None
        before: the fit's own time until then, without the profiler's
        start-up (seconds on the card), which ``lead_taken_s`` holds."""
        return None if self.t_begin is None else self.t_begin - self.t_arm

    def finish(self):
        if self.prof is None:
            return None
        if not self.done:
            self._stop()
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return parse_chrome_trace(path)
        finally:
            os.remove(path)
            self.prof = None


class Trace:
    """The slice: its window [t0, t1] (seconds), the device's events
    (name, start, duration, category) inside it, sorted by start, and the
    host's events."""

    def __init__(self, t0, t1, device, host):
        self.t0, self.t1 = t0, t1
        self.device = device
        self.host = host

    @property
    def window_s(self):
        return self.t1 - self.t0

    def kernels(self, name_part=None):
        return [e for e in self.device
                if e[3] == "kernel" and (name_part is None or name_part in e[0])]

    def busy_intervals(self):
        """The union of the device events' intervals, clipped to the
        window."""
        out = []
        for _, ts, dur, _ in self.device:
            lo, hi = max(ts, self.t0), min(ts + dur, self.t1)
            if hi <= lo:
                continue
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return out

    def busy_s(self):
        return sum(hi - lo for lo, hi in self.busy_intervals())

    def top_device_ops(self, n=10):
        """[[name, seconds]] of the device operations that took the most
        time in the window."""
        sums = {}
        for name, ts, dur, _ in self.device:
            sums[name] = sums.get(name, 0.0) + dur
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]

    def idle_gaps(self, n=10):
        """[[what the host was doing, seconds]] of the longest gaps in the
        device's work: the host event that overlaps the gap most."""
        gaps, prev = [], self.t0
        for lo, hi in self.busy_intervals() + [[self.t1, self.t1]]:
            if lo > prev:
                gaps.append((prev, lo))
            prev = max(prev, hi)
        gaps = sorted(gaps, key=lambda g: -(g[1] - g[0]))[:n]
        out = []
        for lo, hi in gaps:
            best, best_overlap = "no host call recorded", 0.0
            for name, ts, dur, cat in self.host:
                if name == SLICE_SPAN:
                    continue
                overlap = min(hi, ts + dur) - max(lo, ts)
                if overlap > best_overlap:
                    best, best_overlap = f"{cat}:{name}"[:160], overlap
            out.append([best, hi - lo])
        return out


def _trace(records):
    """The ``Trace`` of (name, start s, duration s, category) records, its
    window the host span ``portbench.slice``; None without one."""
    device, host, window = [], [], None
    for name, ts, dur, cat in records:
        if name == SLICE_SPAN and cat == "user_annotation":
            window = (ts, ts + dur)
        elif cat in DEVICE_CATS:
            device.append((name, ts, dur, cat))
        elif cat in HOST_CATS:
            host.append((name, ts, dur, cat))
    if window is None:
        return None
    t0, t1 = window
    device = sorted((d for d in device if d[1] < t1 and d[1] + d[2] > t0),
                    key=lambda d: d[1])
    host = [h for h in host if h[1] < t1 and h[1] + h[2] > t0]
    return Trace(t0, t1, device, host)


def parse_chrome_trace(path):
    """The ``Trace`` of a ``torch.profiler`` Chrome-trace file."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return _trace((e.get("name", ""), float(e["ts"]) * 1e-6, float(e.get("dur", 0.0)) * 1e-6,
                   e.get("cat", "")) for e in events if e.get("ph") == "X")


def label_loss_launches(trace, schedule):
    """[(kernel, rows, duration)] of the slice's loss kernel launches whose
    shape the schedule fixes: each K1 (``nll_fwd_kernel``) followed by a K2
    (``nll_bwd_kernel``) is a training step's, the one before a validation
    run is the trailing step's (when the epoch has one), and each run of
    K1s with no K2 between is the epoch's validation chunks, in order.
    Launches the window cuts off are left out.  ``schedule``: dict with
    ``batch``, ``rem`` (trailing rows, 0 for none) and ``val_chunks``
    (rows of each validation chunk; None: the validation left unlabelled)."""
    nll = [(("K1" if "nll_fwd_kernel" in name else "K2"), dur)
           for name, _, dur, cat in trace.device
           if cat == "kernel" and ("nll_fwd_kernel" in name or "nll_bwd_kernel" in name)]
    out = []
    i = 0
    steps = []  # indices into out of the last training step's K1 and K2
    while i < len(nll):
        kind, dur = nll[i]
        if kind == "K1" and i + 1 < len(nll) and nll[i + 1][0] == "K2":
            if i + 2 == len(nll):
                break  # the last step of the window: full or trailing is not known
            out.append(["K1", schedule["batch"], dur])
            out.append(["K2", schedule["batch"], nll[i + 1][1]])
            steps = [len(out) - 2, len(out) - 1]
            i += 2
            continue
        if kind == "K1":
            j = i
            # up to the next step's K1, the one a K2 follows
            while j < len(nll) and nll[j][0] == "K1" and not (
                    j + 1 < len(nll) and nll[j + 1][0] == "K2"):
                j += 1
            run = nll[i:j]
            if steps and schedule["rem"]:
                for k in steps:  # the step before the validation: the trailing one
                    out[k][1] = schedule["rem"]
            chunks = schedule["val_chunks"]
            if i > 0 and j < len(nll) and chunks is not None and len(run) == len(chunks):
                out += [["K1", rows, d] for rows, (_, d) in zip(schedule["val_chunks"], run)]
            steps = []
            i = j
            continue
        i += 1  # a K2 whose K1 the window cut off
    return [tuple(x) for x in out]
