"""The port's recorder (``dca_tpu_torch/timeline.py``) on the CPU: off, it
records nothing; on, the in-memory epoch is tiled by its leaf spans and
``History.epoch_s`` is the epoch spans' durations; the timers of the other
History and FitResult fields are its spans; under ``torch.profiler`` the
leaf spans are the trace's ``user_annotation`` events; the JSONL of
``DCA_TPU_TIMELINE`` still feeds ``scripts/timeline_report.py`` and holds
the threads' CPU samples.  The graphs' node counter needs a card
(``tests/test_torch_gpu.py``)."""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dca_tpu_torch import timeline
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models.network import get_ae_type
from dca_tpu_torch.train.loop import train

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAVES = ("dca.fit.perm", "dca.fit.steps", "dca.fit.validation", "dca.fit.fetch")
FIT = dict(batch_size=32, verbose=False, seed=3)


def _adata(n_cells=150, n_genes=20):
    return io.normalize(io.read_dataset(AnnData(make_counts(n_cells, n_genes, seed=4))))


def _net(n_genes=20, ae_type="nb-conddisp"):
    return get_ae_type(ae_type)(input_size=n_genes, hidden_size=(8, 4, 8), hidden_dropout=0.0,
                                device="cpu").build()


@pytest.fixture(autouse=True)
def _no_env_timeline(monkeypatch):
    monkeypatch.delenv("DCA_TPU_TIMELINE", raising=False)
    yield
    assert timeline._rec is None and not timeline._on


def test_off_it_records_nothing_and_enters_no_annotation(monkeypatch):
    """No recording, no profiler: not one ``record_function`` is entered,
    and every span is the shared null context."""
    entered = []
    monkeypatch.setattr(timeline, "record_function", lambda name: entered.append(name))
    hist = train(_adata(), _net(), epochs=2, **FIT)
    assert len(hist.epoch_s) == 2 and entered == []
    assert timeline.span("dca.fit.perm") is timeline._NULL
    assert timeline.device_span("dca.stream.device", True) is timeline._NULL
    timeline.count("graphs.replays", 3)
    timeline.end_epoch(flush=True)


def test_the_in_memory_epoch_is_tiled_by_its_leaf_spans():
    """Each epoch holds one perm, steps, validation and fetch span, in that
    order, back to back from its ``dca.fit.epoch`` span's start to its end
    (so covering at least 95% of it); a callbacks span follows it;
    ``epoch_s`` is the epoch spans' durations to the bit."""
    with timeline.recording() as rec:
        hist = train(_adata(), _net(), epochs=4, **FIT)
    epochs = rec.named("dca.fit.epoch")
    assert [s.dur for s in epochs] == hist.epoch_s
    assert [s.epoch for s in epochs] == [0, 1, 2, 3]
    for ep in epochs:
        leaves = [s for s in rec.spans if s.name in LEAVES and s.epoch == ep.epoch]
        assert [s.name for s in leaves] == list(LEAVES)
        assert leaves[0].t0 == ep.t0 and leaves[-1].t1 == ep.t1
        assert all(a.t1 == b.t0 for a, b in zip(leaves, leaves[1:]))
        assert sum(s.dur for s in leaves) >= 0.95 * ep.dur
        callbacks = [s for s in rec.named("dca.fit.callbacks") if s.epoch == ep.epoch]
        assert len(callbacks) == 1 and callbacks[0].t0 >= ep.t1
    assert {s.tid for s in rec.spans} == {threading.get_native_id()}


def test_fits_in_two_threads_at_once_tag_their_own_records(monkeypatch):
    """Two fits at once, each in a thread of its own (the hyperparameter
    search's trials), under one recording: the first fit's epochs 0-2 run
    beside the second's 2-4, yet each fit's spans and CPU samples carry its
    own fit number, thread and epochs, and only its thread is flagged as
    the fit thread in its samples."""
    barrier = threading.Barrier(2, timeout=60)
    begin = timeline.begin_epoch
    waits = {"A": (0, 1, 2), "B": (2, 3, 4)}

    def begin_epoch(epoch):
        begin(epoch)
        if epoch in waits[threading.current_thread().name]:
            barrier.wait()  # A's epoch e starts with B's e + 2

    monkeypatch.setattr(timeline, "begin_epoch", begin_epoch)
    adata, runs, errors = _adata(), {}, []

    def run(epochs):
        try:
            runs[threading.get_native_id()] = train(adata, _net(), epochs=epochs, **FIT)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            barrier.abort()

    with timeline.recording() as rec:
        threads = [threading.Thread(target=run, args=(n,), name=name)
                   for name, n in (("A", 3), ("B", 5))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert not errors and len(runs) == 2
    fits = {}
    for s in rec.spans:
        fits.setdefault(s.fit, set()).add(s.tid)
    assert len(fits) == 2 and sorted(len(t) for t in fits.values()) == [1, 1]
    for fit, (tid,) in fits.items():
        hist = runs[tid]
        n = len(hist.epoch_s)
        epochs = rec.named("dca.fit.epoch", fit)
        assert [s.epoch for s in epochs] == list(range(n))
        assert [s.dur for s in epochs] == hist.epoch_s
        for ep in epochs:
            leaves = [s for s in rec.spans if s.fit == fit and s.epoch == ep.epoch
                      and s.name in LEAVES]
            assert [s.name for s in leaves] == list(LEAVES)
            assert leaves[0].t0 == ep.t0 and leaves[-1].t1 == ep.t1
        clock = rec.counted("cpu.fit", fit)
        assert [c.epoch for c in clock] == list(range(n)) and {c.tid for c in clock} == {tid}
        flagged = {c.tid for c in rec.counted("cpu.thread", fit) if c.attrs["fit_thread"]}
        assert flagged == {tid}
    assert sorted(len(runs[t].epoch_s) for (t,) in fits.values()) == [3, 5]


def test_the_fields_are_the_durations_of_their_spans(tmp_path):
    """``tb_s``, ``checkpoint_s``, ``weights_s`` and ``restore_s`` are the
    durations of ``dca.fit.tb``, ``dca.fit.checkpoint``,
    ``dca.fit.weights`` and ``dca.fit.restore``, siblings of the epoch's
    callbacks, never inside them."""
    adata, net = _adata(), _net()
    kw = dict(FIT, output_dir=str(tmp_path), tensorboard=True, save_weights=True,
              checkpoint_every=1)
    with timeline.recording() as rec:
        first = train(adata, net, epochs=2, **kw)
        second = train(adata, net, epochs=3, resume=True, **kw)
    fits = sorted({s.fit for s in rec.spans})
    assert len(fits) == 2
    for hist, fit in zip((first, second), fits):
        assert hist.tb_s == [s.dur for s in rec.named("dca.fit.tb", fit)]
        assert hist.checkpoint_s == [s.dur for s in rec.named("dca.fit.checkpoint", fit)]
        assert hist.weights_s == [s.dur for s in rec.named("dca.fit.weights", fit)]
        assert hist.epoch_s == [s.dur for s in rec.named("dca.fit.epoch", fit)]
    assert len(second.epoch_s) == 1 and len(first.weights_s) >= 1
    assert [second.restore_s] == [s.dur for s in rec.named("dca.fit.restore", fits[1])]
    assert first.restore_s is None
    callbacks = rec.named("dca.fit.callbacks")
    for name in ("dca.fit.tb", "dca.fit.checkpoint", "dca.fit.weights"):
        for s in rec.named(name):
            assert not any(c.t0 <= s.t0 and s.t1 <= c.t1 for c in callbacks), name


def test_the_streaming_trainer_records_its_stages():
    """The streaming trainer's epoch spans are ``epoch_s``, and each epoch
    has a wait and a dispatch span for each part and the prefetch
    thread's prep and ship."""
    adata = io.normalize(io.read_dataset(AnnData(make_counts(150, 20, seed=4))),
                         lazy_scale=True)
    with timeline.recording() as rec:
        hist = train(adata, _net(), epochs=2, max_device_cells=64, **FIT)
    assert hist.epoch_s == [s.dur for s in rec.named("dca.fit.epoch")]
    for e in (0, 1):
        stages = [s for s in rec.spans if s.epoch == e]
        # 135 train rows in parts of 64: 64, 64 and 7, then one validation chunk
        assert sum(s.name == "dca.stream.dispatch" for s in stages) == 4
        assert sum(s.name == "dca.stream.wait" for s in stages) == 4
        assert {"dca.stream.prep", "dca.stream.ship", "dca.fit.fetch"} <= {
            s.name for s in stages}
    assert {s.tid for s in rec.named("dca.stream.prep")} != {threading.get_native_id()}


def _payload_nbytes(x, t, sf, derived):
    """The host bytes of a materialized part: each array of the input and
    target payloads once (a derived input's payload is the target's, a
    shared index stream is one array), the size factors, and a derived
    input's float32 row multipliers."""
    seen = {}
    for part in (x, t, sf):
        for a in ([part] if isinstance(part, np.ndarray) else
                  [getattr(part, k) for k in part.__slots__]):
            if isinstance(a, np.ndarray):
                seen[id(a)] = a.nbytes
    return sum(seen.values()) + (4 * len(sf) if derived else 0)


@pytest.mark.parametrize("tier,env", [
    ("host", {}),
    ("derived", {"DCA_TPU_DEVICE_DENSIFY": "1"}),
    ("padded", {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
                "DCA_TPU_PAYLOAD": "padded"}),
    ("resident", {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_RESIDENT": "1"}),
])
def test_the_streamed_parts_carry_their_rows_and_bytes(monkeypatch, tier, env):
    """A fit that train()'s gate streams (DCA_TPU_DEVICE_BYTES lowered):
    every ``dca.stream.*`` span carries its part's rows, which sum over an
    epoch's parts to the training and the validation rows, and each staged
    part counts once, in ``stream.bytes``, the host bytes of the payload
    the program built for it (the resident tier: the int64 row ids)."""
    from dca_tpu_torch.data.loader import StreamingData

    monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", "1000")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    built = []
    real = StreamingData.materialize

    def spy(self, idx):
        out = real(self, idx)
        built.append(_payload_nbytes(*out, derived=self.derive_input))
        return out

    monkeypatch.setattr(StreamingData, "materialize", spy)
    counts = sp.csr_matrix(make_counts(150, 20, seed=4))
    adata = io.normalize(io.read_dataset(AnnData(counts)), lazy_scale=True)
    with timeline.recording() as rec:
        train(adata, _net(), epochs=2, **FIT)
    n_train = int(150 * 0.9)
    stream = [s for s in rec.spans if s.name.startswith("dca.stream.")]
    assert {"dca.stream.wait", "dca.stream.dispatch"} <= {s.name for s in stream}
    assert all(isinstance(s.attrs["rows"], int) for s in stream)
    counted = rec.counted("stream.bytes")
    for e in (0, 1):
        for name in {s.name for s in stream}:
            parts = {s.attrs["part"]: s for s in stream if s.name == name and s.epoch == e}
            assert sum(s.attrs["rows"] for s in parts.values()
                       if s.attrs["kind"] != "val") == n_train, name
            assert sum(s.attrs["rows"] for s in parts.values()
                       if s.attrs["kind"] == "val") == 150 - n_train, name
        mine = sorted((c for c in counted if c.epoch == e), key=lambda c: c.attrs["part"])
        waits = sorted((s for s in stream if s.name == "dca.stream.wait" and s.epoch == e),
                       key=lambda s: s.attrs["part"])
        assert [c.attrs for c in mine] == [s.attrs for s in waits]
    if tier == "resident":
        assert not built
        assert [c.n for c in counted] == [8 * c.attrs["rows"] for c in counted]
    else:
        assert [c.n for c in sorted(counted, key=lambda c: (c.epoch, c.attrs["part"]))] == built


def test_an_in_memory_fit_records_no_part_attributes():
    """The in-memory fit records neither the streamed parts' rows nor
    their bytes."""
    with timeline.recording() as rec:
        train(_adata(), _net(), epochs=2, **FIT)
    assert rec.spans and not rec.counted("stream.bytes")
    assert not any(s.name.startswith("dca.stream.") or "rows" in s.attrs for s in rec.spans)
    assert not any("rows" in c.attrs for c in rec.counts)


def test_the_compiled_fit_records_its_epochs_and_fetch():
    """``compiled=True`` on the CPU: its epochs from Python are
    ``dca.fit.epoch`` spans, ``FitResult.epoch_s`` their durations, and its
    one read-back a ``dca.fit.fetch``."""
    with timeline.recording() as rec:
        hist = train(_adata(), _net(), epochs=3, compiled=True, **FIT)
    assert hist.fit.epoch_s == [s.dur for s in rec.named("dca.fit.epoch")]
    assert len(rec.named("dca.fit.fetch")) == 1 and hist.fit.enqueue_s is None


def test_the_denoise_blocks_are_spans():
    """Each block of the eval forward has its prep, compute and fetch span,
    by the block's index."""
    net = _net()
    x = np.asarray(_adata().X, np.float32)
    with timeline.recording() as rec:
        blocks = list(net.iter_forward_blocks(x, chunk_rows=40))
    assert len(blocks) == 4
    for name in ("dca.predict.prep", "dca.predict.compute", "dca.predict.fetch"):
        assert sorted(s.attrs["part"] for s in rec.named(name)) == [0, 1, 2, 3]
        assert sum(s.attrs["rows"] for s in rec.named(name)) == 150


@pytest.mark.parametrize("recording", [False, True], ids=["off", "on"])
def test_leaf_spans_are_annotations_of_the_profilers_trace(tmp_path, recording):
    """Under a CPU ``torch.profiler`` session the exported Chrome trace
    holds every in-memory epoch's leaf spans and its callbacks as
    ``user_annotation`` events, and never the enclosing ``dca.fit.epoch``;
    the recorder on or off.  On, the record holds the anchor taken with the
    trace's ``dca.anchor`` annotation."""
    from torch.profiler import ProfilerActivity, profile

    adata, net = _adata(), _net()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if recording:
            with timeline.recording() as rec:
                train(adata, net, epochs=3, **FIT)
        else:
            train(adata, net, epochs=3, **FIT)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("dca.")]
    for name in LEAVES + ("dca.fit.callbacks",):
        assert names.count(name) == 3, name
    assert "dca.fit.epoch" not in names
    if recording:
        assert names.count("dca.anchor") == 1 and len(rec.counted("anchor")) == 1
        assert len(rec.named("dca.fit.epoch")) == 3
    else:
        assert "dca.anchor" not in names


def test_the_jsonl_feeds_the_report_and_names_the_fit_thread(tmp_path, monkeypatch):
    """``DCA_TPU_TIMELINE`` on an in-memory fit: the JSONL keeps the
    streaming timeline's fields, ``scripts/timeline_report.py`` sums it,
    and its CPU samples name the fit thread: every thread of the process at
    the fit's start and end, and the fit thread's own clock after each
    epoch."""
    path = tmp_path / "tl.jsonl"
    monkeypatch.setenv("DCA_TPU_TIMELINE", str(path))
    hist = train(_adata(), _net(), epochs=3, **FIT)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert all({"epoch", "part", "kind", "stage", "t0", "t1", "dur"} <= set(r) for r in rows)
    assert {r["epoch"] for r in rows} == {0, 1, 2}
    epochs = [r for r in rows if r["stage"] == "epoch"]
    np.testing.assert_allclose([r["dur"] for r in epochs], hist.epoch_s, atol=1e-9)
    assert {"perm", "steps", "validation", "fetch", "callbacks"} <= {r["stage"] for r in rows}
    cpu = [r for r in rows if r["stage"] == "cpu"]
    mine = threading.get_native_id()
    comm = next(name for tid, name, _ in timeline.thread_cpu() if tid == mine)
    fit_samples = [r for r in cpu if r["fit_thread"] and r["kind"] == comm]
    assert len(fit_samples) >= 2 and all(r["part"] == mine for r in fit_samples)
    assert fit_samples[-1]["cpu_s"] >= fit_samples[0]["cpu_s"]
    clock = [r for r in cpu if r["kind"] == "fit"]
    assert [r["epoch"] for r in clock] == [0, 1, 2]
    assert all(b["cpu_s"] >= a["cpu_s"] > 0 for a, b in zip(clock, clock[1:]))
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "timeline_report.py"),
                          str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("wall") == 3 and "fetch" in out.stdout


def test_env_sessions_nest_and_a_second_recording_is_refused(tmp_path, monkeypatch):
    """Blocks inside one ``DCA_TPU_TIMELINE`` session share it; the file is
    written when the last one leaves; ``recording`` refuses to open over
    another record."""
    path = tmp_path / "tl.jsonl"
    monkeypatch.setenv("DCA_TPU_TIMELINE", str(path))
    with timeline.session():
        with timeline.session():
            with timeline.span("dca.test.inner"):
                pass
        assert timeline._on and not path.exists()
        with pytest.raises(RuntimeError):
            with timeline.recording():
                pass
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in rows] == ["dca.test.inner"]
    monkeypatch.delenv("DCA_TPU_TIMELINE")
    with timeline.recording() as rec:
        with timeline.session():  # no environment: the recording holds it
            timeline.count("graphs.replays", 7, key="False")
    assert [(c.name, c.n, c.attrs) for c in rec.counts] == [
        ("graphs.replays", 7, {"key": "False"})]


def test_thread_cpu_reads_this_thread():
    """Every thread of the process with its name and CPU seconds, this one
    among them."""
    sum(i * i for i in range(200000))
    threads = {tid: (name, cpu) for tid, name, cpu in timeline.thread_cpu()}
    name, cpu = threads[threading.get_native_id()]
    assert name and cpu >= 0
    assert all(c >= 0 for _, c in threads.values())
