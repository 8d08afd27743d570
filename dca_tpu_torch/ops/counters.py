"""The kernel wrappers' launch counters, exact when fits run at once in
several threads.

Each wrapper counts its launches in its module's dict (``fused_loss.launches``,
``fused_dense.launches``) through ``record``, where it launches its kernel.
A wrapper called while its stream captures a CUDA graph enqueues its kernel
into the graph and launches nothing; ``record`` then adds to that capture's
tally (``capturing``), and ``add`` credits the tally to the counters at each
replay of the graph (``train/graphs.py``).  Captures are told apart by their
stream, not by their thread: the autograd engine runs a captured backward,
and so K2's wrapper, on its own device thread, with the forward's stream
current.  One lock guards the counters and the tallies, so the increments
of concurrent fits are neither lost nor taken by another fit's capture.
"""

from __future__ import annotations

import contextlib
import threading

_lock = threading.Lock()
# capture stream handle -> {id(counter): (counter, {name: launches})}
_tallies = {}


def record(counter, names, stream):
    """Count one launch of each of ``names`` in ``counter``, or, while
    ``stream`` (a CUDA stream handle, ``Stream.cuda_stream``) captures under
    ``capturing``, in that capture's tally."""
    with _lock:
        tally = _tallies.get(stream)
        if tally is not None:
            counter = tally.setdefault(id(counter), (counter, dict.fromkeys(counter, 0)))[1]
        for name in names:
            counter[name] += 1


def reset(counter):
    """Set every count of ``counter`` to 0."""
    with _lock:
        for name in counter:
            counter[name] = 0


@contextlib.contextmanager
def capturing(stream):
    """Tally the launches recorded on ``stream`` (a handle) inside the
    block, away from the counters; yields the tally, which ``add`` takes."""
    tally = {}
    with _lock:
        if stream in _tallies:
            raise RuntimeError("a capture on this stream is already being tallied")
        _tallies[stream] = tally
    try:
        yield tally
    finally:
        with _lock:
            del _tallies[stream]


def add(tally, times=1):
    """Credit ``times`` replays of a captured graph's ``tally`` to the
    counters."""
    with _lock:
        for counter, counts in tally.values():
            for name, n in counts.items():
                counter[name] += n * times
