"""The program's record of the timed fit reaches the readers in a traced
run and is not taken in an untraced one; the readers of it
(``epoch_host_ms``, ``replay_host_us``, ``fit_thread_cpu_share``) on a
recorded in-memory CPU fit, and None without their input."""

import statistics
import types

import pytest
import torch

import run
from harness import cell as C
from harness.manifest import reader

CPU = torch.device("cpu")


def test_a_traced_run_hands_the_readers_the_fits_record(tiny_cell, monkeypatch):
    from harness import manifest

    seen = []
    real = manifest.reader

    def spy(name, *a, **k):
        read = real(name, *a, **k)
        return lambda ctx: seen.append(ctx) or read(ctx)

    monkeypatch.setattr(manifest, "reader", spy)
    cell = tiny_cell("nb-conddisp.paul15")
    result = run.run_cell(cell, 31, 0.5, 1, CPU)
    rec = seen[0].timeline
    assert all(ctx.timeline is rec for ctx in seen)
    epochs = rec.named("dca.fit.epoch")
    assert len(epochs) == result["attempted"] and {s.fit for s in epochs} == {epochs[0].fit}
    assert rec.named("dca.fit.steps") and rec.counted("cpu.fit")
    assert result["fit"]["trainer"] == "in_memory" and "tier" not in result["fit"]


class _Starter:
    """A stand-in for ``trace.SliceTracer``: at the fit's ``at``-th point of
    progress it calls ``before_start``, where the profiler would start."""

    before_start = None

    def __init__(self, at):
        self.at, self.points = at, 0

    def arm(self):
        pass

    def __call__(self):
        self.points += 1
        if self.points == self.at and self.before_start is not None:
            self.before_start()


def test_the_record_ends_where_the_profiler_starts(tiny_cell):
    """With a slice to trace, the recorder is off before the profiler
    starts: the record holds the epochs before, and the slice runs as
    without it."""
    from dca_tpu_torch import timeline

    cell = tiny_cell("nb-conddisp.paul15")
    cell.traffic.update(state_fits=0)
    s = C.setup(cell, 33, CPU)
    s.epoch_s = [0.1]
    starter = _Starter(at=3)
    hist, _, epochs = C.timed_fit(s, cell, 0.6, starter, record=True)
    assert epochs == 6 and len(hist.epoch_s) == 6 and starter.points >= 6
    kept = sorted(sp.epoch for sp in s.timeline.named("dca.fit.epoch"))
    assert 1 <= len(kept) < epochs and kept == list(range(len(kept)))
    assert all(c.epoch < len(kept) for c in s.timeline.counts)
    with timeline.recording():  # the program's recorder was let go
        pass


def test_an_untraced_run_records_nothing(tiny_cell, monkeypatch):
    from dca_tpu_torch import timeline

    def refuse():
        raise AssertionError("an untraced run opened a record")

    monkeypatch.setattr(timeline, "recording", refuse)
    cell = tiny_cell("nb-conddisp.paul15")
    result = run.run_cell(cell, 32, 0.5, 0, CPU)
    assert result["correct"] and "trainer" not in result["fit"]  # no record shows it


@pytest.fixture(scope="module")
def recorded():
    """A recorded in-memory fit of 60 epochs on the CPU, some seconds:
    (its record, its History)."""
    from harness.manifest import load_manifest, resolve

    cell = resolve(load_manifest(), "zinb-conddisp.paul15")
    cell.traffic.update(cell.traffic["cpu_test"], state_fits=0)
    s = C.setup(cell, 41, CPU)
    s.epoch_s = [1.0 / 60]  # the window's epochs, whatever the CPU's speed
    hist, _, epochs = C.timed_fit(s, cell, 1.0, record=True)
    assert epochs == 60
    return s.timeline, hist


def _ctx(record, clean=0):
    return types.SimpleNamespace(timeline=record, trace=None, fit={"unprofiled_epochs": clean},
                                 schedule={}, config={}, traffic={}, genes=0)


def test_epoch_host_ms_is_the_epoch_less_its_read_back(recorded):
    rec, hist = recorded
    read = reader("epoch_host_ms")
    fetch = {s.epoch: s.dur for s in rec.named("dca.fit.fetch")}
    want = [(e - fetch[i]) * 1e3 for i, e in enumerate(hist.epoch_s)]
    assert read(_ctx(rec)) == pytest.approx(statistics.median(want), rel=1e-12)
    assert read(_ctx(rec, clean=2)) == pytest.approx(statistics.median(want[:2]), rel=1e-12)
    assert 0 < read(_ctx(rec)) < 1e3 * max(hist.epoch_s)
    assert read(_ctx(None)) is None


def test_replay_host_us_is_the_steps_over_the_replays(recorded):
    from dca_tpu_torch.timeline import Count, Record

    rec, hist = recorded
    read = reader("replay_host_us")
    assert read(_ctx(rec)) is None  # the CPU replays no graph
    steps = {s.epoch: s.dur for s in rec.named("dca.fit.steps")}
    fit = rec.named("dca.fit.epoch")[0].fit
    with_replays = Record()
    with_replays.spans = list(rec.spans)
    with_replays.counts = [Count("graphs.replays", n, e, fit, {}, 0, 0.0)
                           for e in steps for n in (9, 1)]
    want = [steps[e] / 10 * 1e6 for e in sorted(steps)]
    assert read(_ctx(with_replays)) == pytest.approx(statistics.median(want), rel=1e-12)
    assert read(_ctx(with_replays, clean=1)) == pytest.approx(want[0], rel=1e-12)
    assert read(_ctx(None)) is None


def test_fit_thread_cpu_share_pools_the_clean_stretch(recorded):
    rec, hist = recorded
    read = reader("fit_thread_cpu_share")
    marks = sorted((c.t, c.n) for c in rec.counted("cpu.fit"))
    (t0, c0), (t1, c1) = marks[0], marks[-1]
    assert t1 - t0 >= 1.0
    assert read(_ctx(rec)) == pytest.approx((c1 - c0) / (t1 - t0), rel=1e-12)
    assert 0 < read(_ctx(rec)) <= 1.05
    assert read(_ctx(rec, clean=1)) is None  # one reading: no stretch
    assert read(_ctx(None)) is None
