"""The readers of the program's recorder (``dca_tpu_torch/timeline.py``):
``idle_outside_steps_ms`` on a hand-built trace with known gaps and
annotations, ``step_graph_nodes`` on a hand-set count; each gives None
where its input is missing (an untraced run, a program without the spans,
no captured graph)."""

import types

from harness.manifest import reader
from harness.trace import Trace


def _ctx(trace):
    return types.SimpleNamespace(trace=trace, fit={}, schedule={}, config={}, traffic={},
                                 genes=0)


def _kernel(t0, t1):
    return ("k", t0, t1 - t0, "kernel")


def _note(name, t0, t1):
    return (name, t0, t1 - t0, "user_annotation")


def _trace(notes):
    device = [_kernel(0, 1), ("memcpy", 1.5, 2.5, "gpu_memcpy"), _kernel(6, 7), _kernel(8, 10)]
    host = notes + [("cudaGraphLaunch", 5.2, 0.1, "cuda_runtime")]
    return Trace(0.0, 10.0, device, host)


NOTES = [_note("dca.fit.steps", 0, 3.8), _note("dca.fit.fetch", 4, 4.5),
         _note("dca.fit.steps", 5, 7.5), _note("dca.fit.fetch", 8.8, 9),
         _note("dca.fit.fetch", 9.5, 11)]  # ends after the slice: not counted


def test_idle_outside_steps_ms_reads_the_gaps_outside_the_steps():
    # between the read-backs' ends 4.5 and 9 the device idles over
    # [4.5, 6] and [7, 8]; the steps span [5, 7.5] covers [5, 6] and
    # [7, 7.5] of it: 0.5 + 0.5 s in one epoch
    read = reader("idle_outside_steps_ms")
    assert abs(read(_ctx(_trace(NOTES))) - 1000.0) < 1e-9
    # a second steps span over the first gap leaves [7.5, 8] alone
    more = NOTES + [_note("dca.fit.steps", 4.4, 5.1)]
    assert abs(read(_ctx(_trace(more))) - 500.0) < 1e-9


def test_idle_outside_steps_ms_without_its_input_is_none():
    read = reader("idle_outside_steps_ms")
    assert read(_ctx(None)) is None
    assert read(_ctx(_trace([]))) is None  # a program without the spans
    assert read(_ctx(_trace(NOTES[:3]))) is None  # one read-back
    assert read(_ctx(_trace([n for n in NOTES if n[0] != "dca.fit.steps"]))) is None


def test_step_graph_nodes_reads_the_captures_count(monkeypatch):
    from dca_tpu_torch.train import graphs

    read = reader("step_graph_nodes")
    monkeypatch.setattr(graphs, "last_nodes", {"full": 331, "trailing": 330})
    assert read(_ctx(None)) == 331
    monkeypatch.setattr(graphs, "last_nodes", {"epoch": 2000})  # no step graph
    assert read(_ctx(None)) is None
    monkeypatch.setattr(graphs, "last_nodes", {})  # the CPU: nothing captured
    assert read(_ctx(None)) is None
    monkeypatch.delattr(graphs, "last_nodes")  # a program without the count
    assert read(_ctx(None)) is None
