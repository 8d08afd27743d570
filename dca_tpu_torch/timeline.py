"""The port's recorder: named spans and counters of the fit loops, the step
graphs and the denoise tier, on the host's clock and, under a
``torch.profiler`` session, on the device trace's too.

Off by default.  ``DCA_TPU_TIMELINE=<path>`` turns it on for each fit
(``fit``, which ``train()`` enters) and each denoise pass (``session``),
whose records are appended to that JSONL file at their end (the streaming
trainer's after every epoch too); ``recording()`` turns it on in-process
and yields the ``Record``, which it keeps in memory.

* ``span(name, **attrs)``, a context manager: off, one flag test and a
  shared null context or, while a ``torch.profiler`` session runs, the
  profiler's ``record_function(name)``, which the Chrome trace holds as a
  ``user_annotation`` event on the device trace's own clock; on, it adds
  a ``Span`` (name, attributes, thread, ``perf_counter`` stamps) to the
  record besides.  A span that holds others (``leaf=False``: an epoch)
  never goes to the profiler, so the leaves alone tile the trace.
* ``timed(name, **attrs)``: a span whose duration fills a field of
  ``History`` or ``FitResult``: on or off it takes its two
  ``perf_counter`` stamps, and ``.dur`` is the field's value, the
  recorded span's ``t1 - t0`` to the bit.
* ``device_span(name, cuda, **attrs)``: on, on a CUDA device, the current
  stream's time over the block from CUDA events, recorded as a span of
  that length from the block's start once ``flush`` finds it run.
* ``count(name, n, **attrs)``: a counter's reading; off, one flag test.
* ``tiled(name, first, **attrs)``: a ``timed`` span tiled by leaf phases
  that share their boundaries' clock readings (``.phase(name)``), so the
  phases cover the span whole: the in-memory epoch.
* ``fit()``, ``begin_epoch(epoch)`` and ``end_epoch()``: the trainers'
  marks, kept for the thread that runs the fit (fits in several threads
  at once, as the hyperparameter search runs them, each tag their own
  records; ``carry(fn)`` lends a fit's marks to a helper thread's call).
  On, a fit samples every thread's CPU seconds
  (``/proc/self/task/<tid>/stat``, utime + stime, and the thread's name)
  at its start and end, and ``end_epoch`` the fit thread's
  (``time.thread_time``, one clock call) after every epoch and every
  thread's at most once a second.

The JSONL has one line a record, with the fields of the streaming
trainer's timeline, which ``scripts/timeline_report.py`` reads: ``epoch``,
``part``, ``kind``, ``stage`` (a span's last name component:
``dca.stream.wait`` is ``wait``), ``t0`` and ``t1`` (``perf_counter``
seconds) and ``dur``, and beside them ``name``, ``fit`` (the process's fit
number), ``tid`` and the span's other attributes.  A counter's line has
the stage ``count`` and ``n``; a CPU sample's the stage ``cpu``, the
thread's name as ``kind`` (``fit`` for the fit thread's own clock), its id
as ``part``, its CPU seconds as ``cpu_s`` and ``fit_thread``.  The first
leaf span of each stretch under a profiler writes an ``anchor`` line: its
``t0`` was taken with the zero-length annotation ``dca.anchor``, which
lays the file over the profiler's trace (whose ``ts`` is wall-clock
microseconds past its ``baseTimeNanoseconds``, PERF.md); ``t_in`` is the
stamp taken inside the annotation, which brackets its start with ``t0``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

_profiling = torch.autograd._profiler_enabled
_now = time.perf_counter
_local = threading.local()

_on = False  # a record is open
_rec = None
_lock = threading.Lock()
_fits = itertools.count(1)
_env_users = 0  # fits and denoise passes in the session the environment opened
_NULL = contextlib.nullcontext()
# seconds between two samples of every thread's CPU time within a fit
THREADS_EVERY_S = 1.0


def _tid():
    """This thread's id as ``/proc/self/task`` names it, read once."""
    try:
        return _local.tid
    except AttributeError:
        _local.tid = threading.get_native_id()
        return _local.tid


class _Marks:
    """A fit's number, its current epoch, the id of the thread that runs
    it, and when it last sampled every thread's CPU time."""

    __slots__ = ("fit", "epoch", "tid", "t_threads")

    def __init__(self, fit, tid):
        self.fit, self.epoch, self.tid = fit, 0, tid
        self.t_threads = -float("inf")


_NO_FIT = _Marks(0, None)  # records outside a fit: a denoise pass


def _marks():
    """The marks of the fit this thread runs (or was lent by ``carry``)."""
    return getattr(_local, "marks", None) or _NO_FIT


class Span(NamedTuple):
    name: str
    epoch: int
    fit: int
    attrs: dict
    tid: int
    t0: float
    t1: float

    @property
    def dur(self):
        return self.t1 - self.t0


class Count(NamedTuple):
    name: str
    n: float
    epoch: int
    fit: int
    attrs: dict
    tid: int
    t: float


class Record:
    """What the recorder took while it was on: ``spans`` and ``counts`` in
    the order they ended, and the device spans not yet resolved.  With a
    ``path`` (``DCA_TPU_TIMELINE``'s session), ``flush`` appends the
    records to that JSONL file and drops them; without one
    (``recording``), they are kept."""

    def __init__(self, path=None):
        self.path = path
        self.spans, self.counts, self.pending = [], [], []
        self.anchored = False

    def named(self, name, fit=None):
        """The spans called ``name`` (of fit number ``fit`` if given)."""
        return [s for s in self.spans if s.name == name and (fit is None or s.fit == fit)]

    def counted(self, name, fit=None):
        """The counter readings called ``name`` (of fit ``fit`` if given)."""
        return [c for c in self.counts if c.name == name and (fit is None or c.fit == fit)]

    def resolve(self, wait=False):
        """Turn the device spans whose end the device has reached into
        spans; ``wait`` for every one first."""
        pending, self.pending = self.pending, []
        for name, epoch, fit, attrs, tid, t0, start, end in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                self.pending.append((name, epoch, fit, attrs, tid, t0, start, end))
                continue
            dur = start.elapsed_time(end) / 1e3
            self.spans.append(Span(name, epoch, fit, attrs, tid, t0, t0 + dur))

    def flush(self, wait=False):
        """Resolve the device spans and, with a ``path``, append the records
        taken since the last flush to it."""
        self.resolve(wait)
        if self.path is None:
            return
        # swapped first: other threads may append meanwhile
        (spans, self.spans), (counts, self.counts) = (self.spans, []), (self.counts, [])
        lines = [json.dumps(_span_row(s)) for s in spans]
        lines += [json.dumps(_count_row(c)) for c in counts]
        if lines:
            with open(self.path, "a") as f:
                f.write("\n".join(lines) + "\n")


def _span_row(s):
    attrs = dict(s.attrs)
    row = {"epoch": s.epoch, "part": attrs.pop("part", -1), "kind": attrs.pop("kind", ""),
           "stage": s.name.rsplit(".", 1)[-1], "t0": round(s.t0, 6), "t1": round(s.t1, 6),
           "dur": round(s.t1 - s.t0, 9), "name": s.name, "fit": s.fit, "tid": s.tid}
    row.update(attrs)
    return row


def _count_row(c):
    attrs = dict(c.attrs)
    row = {"epoch": c.epoch, "part": attrs.pop("part", -1), "kind": attrs.pop("kind", ""),
           "stage": "count", "t0": round(c.t, 6), "t1": round(c.t, 6), "dur": 0.0,
           "name": c.name, "fit": c.fit, "tid": c.tid}
    if c.name == "anchor":
        row["stage"] = "anchor"
    elif c.name.startswith("cpu."):
        row.update(stage="cpu", kind=attrs.pop("comm", "fit"), part=c.tid, cpu_s=c.n,
                   fit_thread=attrs.pop("fit_thread", True))
    else:
        row["n"] = c.n
    row.update(attrs)
    return row


class _Span:
    __slots__ = ("name", "leaf", "attrs", "rec", "rf", "t0", "t1")

    def __init__(self, name, leaf, attrs):
        self.name, self.leaf, self.attrs = name, leaf, attrs
        self.rec = self.rf = None

    def __enter__(self):
        rec = self.rec = _rec
        if self.leaf:
            if _profiling():
                if rec is not None and not rec.anchored:
                    _anchor(rec)
                self.rf = record_function(self.name)
                self.rf.__enter__()
            elif rec is not None:
                rec.anchored = False
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        self.t1 = _now()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        if rec is not None:
            m = _marks()
            rec.spans.append(Span(self.name, m.epoch, m.fit, self.attrs, _tid(), self.t0,
                                  self.t1))
        return False

    @property
    def dur(self):
        return self.t1 - self.t0


class _Tiled:
    """A span tiled by leaf phases (``tiled``): each phase starts at the
    clock reading that ends the one before, the first at the span's start,
    and the last ends with it."""

    __slots__ = ("name", "attrs", "rec", "rf", "t0", "t1", "leaf", "leaf_t0")

    def __init__(self, name, first, attrs):
        self.name, self.attrs, self.leaf = name, attrs, first
        self.rec = self.rf = None

    def __enter__(self):
        self.rec = _rec
        self.t0 = self.leaf_t0 = _now()
        self._open()
        return self

    def _open(self):
        rec = self.rec
        if _profiling():
            if rec is not None and not rec.anchored:
                _anchor(rec)
            self.rf = record_function(self.leaf)
            self.rf.__enter__()
        elif rec is not None:
            rec.anchored = False

    def _close(self, t):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        rec = self.rec
        if rec is not None:
            m = _marks()
            rec.spans.append(Span(self.leaf, m.epoch, m.fit, {}, _tid(), self.leaf_t0, t))

    def phase(self, name):
        """End the open phase and start ``name``."""
        if self.rec is None and self.rf is None and not _profiling():
            self.leaf = name  # off: nothing to stamp
            return
        t = _now()
        self._close(t)
        self.leaf, self.leaf_t0 = name, t
        self._open()

    def __exit__(self, *exc):
        t = self.t1 = _now()
        self._close(t)
        rec = self.rec
        if rec is not None:
            m = _marks()
            rec.spans.append(Span(self.name, m.epoch, m.fit, self.attrs, _tid(), self.t0, t))
        return False

    @property
    def dur(self):
        return self.t1 - self.t0


class _DeviceSpan:
    __slots__ = ("name", "attrs", "rec", "t0", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rec = _rec
        self.t0 = _now()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        rec = self.rec
        if rec is not None:
            m = _marks()
            rec.pending.append((self.name, m.epoch, m.fit, self.attrs, _tid(), self.t0,
                                self.start, end))
        return False


def span(name, **attrs):
    """A leaf span of the block (module docstring)."""
    if _on:
        return _Span(name, True, attrs)
    if _profiling():
        return record_function(name)
    return _NULL


def timed(name, leaf=True, **attrs):
    """A span of the block whose ``.dur`` fills a field: stamped on or
    off."""
    return _Span(name, leaf, attrs)


def tiled(name, first, **attrs):
    """A span of the block, which fills a field like ``timed``, tiled by
    leaf phases: ``first`` from its start, then each ``.phase(name)`` from
    the clock reading that ends the one before; the last ends with it.
    The span itself is no leaf: under a profiler its phases alone are
    annotations, back to back."""
    return _Tiled(name, first, attrs)


def device_span(name, cuda, **attrs):
    """The current stream's time over the block, on a CUDA device (``cuda``)
    while the recorder is on."""
    if _on and cuda:
        return _DeviceSpan(name, attrs)
    return _NULL


def count(name, n, **attrs):
    """Record counter ``name``'s reading ``n``."""
    if _on:
        rec = _rec
        if rec is not None:
            m = _marks()
            rec.counts.append(Count(name, n, m.epoch, m.fit, attrs, _tid(), _now()))


def _anchor(rec):
    t = _now()
    with record_function("dca.anchor"):
        t_in = _now()
    rec.anchored = True
    m = _marks()
    rec.counts.append(Count("anchor", t, m.epoch, m.fit, {"t_in": t_in}, _tid(), t))


def begin_epoch(epoch):
    """This thread's fit's records from here on belong to ``epoch``."""
    if _on:
        _marks().epoch = epoch


def end_epoch(flush=False):
    """After an epoch: the fit thread's CPU seconds, every thread's at most
    once a second, and with ``flush`` the records written out."""
    if _on:
        rec = _rec
        if rec is None:
            return
        m, t = _marks(), _now()
        rec.counts.append(Count("cpu.fit", time.thread_time(), m.epoch, m.fit, {}, _tid(), t))
        if t - m.t_threads >= THREADS_EVERY_S:
            _sample_threads(rec, m)
        if flush:
            rec.flush()


def thread_cpu():
    """[(thread id, name, CPU seconds)] of every thread of this process
    (``/proc/self/task``; empty where there is none)."""
    out = []
    try:
        tids = os.listdir("/proc/self/task")
    except OSError:
        return out
    tick = os.sysconf("SC_CLK_TCK")
    for tid in tids:
        try:
            with open(f"/proc/self/task/{tid}/stat", "rb") as f:
                stat = f.read()
        except OSError:
            continue  # the thread ended
        lo, hi = stat.index(b"("), stat.rindex(b")")
        fields = stat[hi + 2:].split()
        # fields 14 and 15 of stat(5), utime and stime, after the state (3)
        out.append((int(tid), stat[lo + 1:hi].decode(errors="replace"),
                    (int(fields[11]) + int(fields[12])) / tick))
    return out


def _sample_threads(rec, m):
    t = _now()
    for tid, comm, cpu_s in thread_cpu():
        rec.counts.append(Count("cpu.thread", cpu_s, m.epoch, m.fit,
                                {"comm": comm, "fit_thread": tid == m.tid}, tid, t))
    m.t_threads = t


def _open(rec):
    global _rec, _on
    _rec, _on = rec, True


def _close():
    global _rec, _on
    rec, _rec, _on = _rec, None, False
    return rec


@contextlib.contextmanager
def recording():
    """Record in this process over the block; yields the ``Record``.
    Raises if a record is already open."""
    rec = Record()
    with _lock:
        if _rec is not None:
            raise RuntimeError("the timeline is already recording")
        _open(rec)
    try:
        yield rec
    finally:
        with _lock:
            if _rec is rec:
                _close()
        rec.flush(wait=True)


@contextlib.contextmanager
def session():
    """Over the block, the session of ``DCA_TPU_TIMELINE`` when it is set
    and no ``recording`` is open: the first block to enter opens it, the
    last to leave writes it out and closes it."""
    global _env_users
    path = os.environ.get("DCA_TPU_TIMELINE")
    joined = False
    if path:
        with _lock:
            if _rec is None:
                _open(Record(path))
            if _rec.path is not None:
                _env_users += 1
                joined = True
    try:
        yield
    finally:
        if joined:
            rec = None
            with _lock:
                _env_users -= 1
                if _env_users == 0:
                    rec = _close()
            if rec is not None:
                rec.flush(wait=True)  # the last out


@contextlib.contextmanager
def fit():
    """A fit (``train()``) in this thread: its session, its marks (a new
    fit number), and on, every thread's CPU time at its start and end."""
    with session():
        rec = _rec
        if rec is None:
            yield
            return
        prev = getattr(_local, "marks", None)
        m = _local.marks = _Marks(next(_fits), _tid())
        _sample_threads(rec, m)
        try:
            yield
        finally:
            if rec is _rec:
                _sample_threads(rec, m)
            _local.marks = prev


def carry(fn):
    """``fn``, run under the marks of the fit of the thread that calls
    ``carry`` (so its records in a helper thread are that fit's and its
    epoch's); ``fn`` itself when the thread runs no recorded fit."""
    m = getattr(_local, "marks", None)
    if m is None:
        return fn

    def run(*args, **kwargs):
        prev = getattr(_local, "marks", None)
        _local.marks = m
        try:
            return fn(*args, **kwargs)
        finally:
            _local.marks = prev

    return run
