"""The progress rule for the ranks of a process group that the launcher
did not start (``dca_tpu_torch/parallel/launch.py::watching``): torchrun's
ranks, ``multihost.initialize``'s and ``init_process_group`` by hand.

Two gloo ranks on the CPU, this file run as a script, fit zinb-conddisp
(8, 4, 8) on 60 cells x 16 genes for 5 epochs over ``devices="all"``.

  (a) rank 1 dies (exit code 3) or falls silent (its process sleeps) at
      the end of its second epoch, while rank 0 waits in a collective of
      the third, in the Python-epoch loop ("step") or in ``compiled=True``
      as a rank of an NCCL group runs it ("fit": the whole-fit graph, its
      replays here the epoch run eagerly, rank 1 failing once epoch 2 ran,
      before its point of progress): rank 0's ``train()`` raises
      ``LaunchError`` naming rank 1,
      within the stall timeout STALL_S plus MARGIN_S of rank 1's failure;
      no process group is left on rank 0, which then fits again on its
      own; no rank process outlives the test.  The group is made by hand
      (``init_process_group`` over a TCPStore, the timeout
      ``launch.TIMEOUT_S``) or by ``multihost.initialize(timeout=...)``
      from torchrun's variables;
      Rank 0, which hosts the store of a group made by hand, dies: rank 1
      raises ``LaunchError`` naming the store's loss and rank 0;
  (b) two fits in one group: each posts under keys of its own, the second
      from zero, the same counts on both ranks and in both fits: an
      epoch's steps and its end, every epoch;
  (c) on fakes: the rule's verdict on a real TCPStore with a rank that
      never began, and a failed collective waiting for the verdict;
  (d) the whole-fit graph under a group (``train/graphs.py::GraphFit``)
      with fake CUDA events: its wait posts once for each epoch the device
      completed and raises once the rule's check does; ``release_graphs``
      frees it and a later replay raises; a compiled fit over a mesh of
      one gloo rank, its replays running the epoch eagerly, replays and
      posts once an epoch up to the early stop and gives the eager
      epochs' bits.
"""

import datetime
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_launch import _FakeGraph
from test_torch_parallel import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
STALL_S = 6.0  # the rule's timeout in the ranks: room for a loaded host's scheduling
MARGIN_S = 5.0  # past it, the longest rank 0 may take to raise
RANK_TIMEOUT = 120  # seconds for the ranks, start-up included
FIT = dict(epochs=5, batch_size=16, validation_split=0.3, verbose=False, seed=0,
           reduce_lr=0, early_stop=0)
N_STEPS = 3  # 42 train rows at batch 16: 2 full steps and a trailing one


def _fit(devices="all", compiled=False):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.train.loop import train

    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(60, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    ad = io.normalize(io.read_dataset(AnnData(counts), check_counts=False))
    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), device="cpu",
                                    batchnorm=False, seed=3).build()
    return train(ad, net, devices=devices, compiled=compiled, **FIT)


def _as_on_the_card():
    """This rank's compiled fit as a rank of an NCCL group runs it, with no
    card: the whole-fit graph taken, its replays the epoch run eagerly,
    its events fakes (``_eager_graph_fit``); returns what undoes it."""
    from dca_tpu_torch.train import compiled, loop

    saved = compiled.GraphFit, loop.capture_steps, torch.cuda.Event
    compiled.GraphFit = _eager_graph_fit()
    loop.capture_steps = lambda *a: True
    torch.cuda.Event = lambda enable_timing=False: _FakeEvent(1)

    def undo():
        compiled.GraphFit, loop.capture_steps, torch.cuda.Event = saved

    return undo


def _join(spec, rank):
    import torch.distributed as dist

    from dca_tpu_torch.parallel import launch, multihost

    if spec["start"] == "hand":
        launch.TIMEOUT_S = STALL_S
        store = dist.TCPStore("127.0.0.1", spec["port"], 2, rank == 0,
                              datetime.timedelta(seconds=60))
        dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(spec["port"]))
        multihost.initialize(device="cpu", timeout=STALL_S)


def _rank_main(spec_path, rank):
    """One rank of a case: see the module's docstring; rank 0 prints one
    RESULT line."""
    import torch.distributed as dist

    from dca_tpu_torch.parallel import launch
    from dca_tpu_torch.train import loop

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    _join(spec, rank)
    if spec["how"] == "twice":
        for _ in range(2):
            _fit()
        dist.barrier()  # both ranks' fits, their last posts included, have ended
        store = dist.distributed_c10d._get_default_store()
        counts = [[int(dist.PrefixStore(f"dca_tpu_torch/fit/{k}", store).get(
            launch._progress_key(r))) for r in range(2)] for k in range(2)]
        dist.barrier()
        dist.destroy_process_group()
        print("RESULT " + json.dumps({"rank": rank, "counts": counts}), flush=True)
        return
    whole = spec["where"] == "fit"
    undo = _as_on_the_card() if whole else (lambda: None)
    if rank == spec["fails"]:
        from dca_tpu_torch.train import compiled

        def fail():
            with open(spec["failed_at"], "w") as f:
                f.write(repr(time.time()))
            if spec["how"] == "dies":
                os._exit(3)
            time.sleep(2 * STALL_S + MARGIN_S)

        end, post, posts = loop._FitCallbacks.end_epoch, compiled.post_progress, []

        def failing(self, epoch, monitor):  # at the end of epoch 2, before its post
            if epoch == 1:
                fail()
            return end(self, epoch, monitor)

        def failing_post():  # once epoch 2 of the whole-fit graph ran, before its post
            posts.append(1)
            if len(posts) == 2:
                fail()
            post()

        loop._FitCallbacks.end_epoch = failing
        compiled.post_progress = failing_post
        _fit(compiled=whole)
        return
    out = {"rank": rank}
    try:
        _fit(compiled=whole)
        out["error"] = None
    except Exception as e:
        out.update(error=type(e).__name__, message=str(e)[:2000], raised_at=time.time())
    out["group_left"] = dist.is_initialized()
    undo()
    out["next_fit"] = _fit(devices=None).history["loss"]
    print("RESULT " + json.dumps(out), flush=True)


def _run(tmp_path, how, start, where="step", fails=1):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"how": how, "start": start, "where": where, "fails": fails,
                                "port": _free_port(),
                                "failed_at": str(tmp_path / "failed_at")}))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, HERE, str(spec), str(rank)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.poll() is not None for p in procs)  # no rank left
    return procs, texts


@pytest.mark.parametrize("how,start,where", [
    ("dies", "hand", "step"), ("silent", "hand", "step"), ("silent", "initialize", "step"),
    ("dies", "initialize", "step"), ("dies", "hand", "fit"), ("silent", "hand", "fit")])
def test_a_failed_rank_ends_the_live_ranks_fit_naming_it(tmp_path, how, start, where):
    procs, texts = _run(tmp_path, how, start, where)
    assert procs[0].returncode == 0, texts[0][-4000:]
    assert procs[1].returncode != 0, texts[1][-4000:]  # it died, or woke to a failed fit
    line = [ln for ln in texts[0].splitlines() if ln.startswith("RESULT ")]
    assert line, texts[0][-4000:]
    out = json.loads(line[-1][len("RESULT "):])
    assert out["error"] == "LaunchError", out
    assert f"rank 1 of 2 made no progress for {STALL_S:g} s" in out["message"], out
    failed_at = float((tmp_path / "failed_at").read_text())
    assert out["raised_at"] - failed_at < STALL_S + MARGIN_S, out
    assert not out["group_left"]
    assert np.isfinite(out["next_fit"]).all() and len(out["next_fit"]) == FIT["epochs"]


def test_the_fit_ends_when_the_rank_that_hosts_the_store_dies(tmp_path):
    """Rank 0, whose process hosts the group's store (a group made by
    hand), dies at the end of its second epoch: rank 1's checker finds the
    store gone and ends its fit with ``LaunchError`` naming rank 0 as the
    store's host, within MARGIN_S of the death, no group left."""
    procs, texts = _run(tmp_path, "dies", "hand", fails=0)
    assert procs[1].returncode == 0, texts[1][-4000:]
    assert procs[0].returncode == 3, texts[0][-4000:]
    line = [ln for ln in texts[1].splitlines() if ln.startswith("RESULT ")]
    assert line, texts[1][-4000:]
    out = json.loads(line[-1][len("RESULT "):])
    assert out["error"] == "LaunchError", out
    assert "store stopped answering" in out["message"] and "rank 0" in out["message"], out
    failed_at = float((tmp_path / "failed_at").read_text())
    assert out["raised_at"] - failed_at < MARGIN_S, out
    assert not out["group_left"] and np.isfinite(out["next_fit"]).all()


def test_a_second_fit_in_the_group_posts_under_fresh_keys(tmp_path):
    procs, texts = _run(tmp_path, "twice", "hand")
    outs = []
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-4000:]
        line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        outs.append(json.loads(line[-1][len("RESULT "):]))
    posts = FIT["epochs"] * (N_STEPS + 1)  # each step run from Python, each epoch's end
    assert [o["counts"] for o in outs] == [[[posts, posts], [posts, posts]]] * 2


def test_the_verdict_names_a_rank_that_never_began():
    """On a real TCPStore: a rank whose key was never set counts 0, so
    once no rank has moved for the timeout it is the rank behind; the
    check reads no missing key (which would block)."""
    from dca_tpu_torch.parallel import launch

    store = torch.distributed.TCPStore("127.0.0.1", 0, None, True,
                                       datetime.timedelta(seconds=30), wait_for_workers=False)
    try:
        post = launch.Progress(store, 0)
        post()
        stall = launch._Stall(store, 2, 0.5)
        t0 = time.monotonic()
        assert stall.check() is None
        while stall.check() is None and time.monotonic() - t0 < 10:
            time.sleep(0.05)
        assert stall.check() == 1 and stall.counts == {0: 1, 1: 0}
        assert time.monotonic() - t0 < 5
    finally:
        del store


def test_a_failed_collective_waits_for_the_verdict(monkeypatch):
    """Under ``watching`` (one gloo rank, its peer faked by a key that
    never moves): an error raised inside ``torch.distributed`` waits for
    the rule's verdict and raises it as ``LaunchError``; the checker
    aborted the group; an error of the fit's own is raised as it is."""
    import torch.distributed as dist

    from dca_tpu_torch.parallel import launch

    aborted = threading.Event()
    monkeypatch.setattr(launch, "_abort_group", lambda thread: aborted.set())
    monkeypatch.setattr(launch, "TIMEOUT_S", 1.0)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
        mesh = object()
        with pytest.raises(ValueError, match="the fit.s own"):
            with launch.watching(mesh):
                raise ValueError("the fit's own")
        assert not aborted.is_set()
        t0 = time.monotonic()
        with pytest.raises(launch.LaunchError, match="rank 1 of 2 made no progress for 1 s") \
                as err:
            with launch.watching(mesh):
                launch.post_progress()
                dist.broadcast_object_list([None], src=3)  # a collective that fails
        assert isinstance(err.value.__cause__, Exception) and aborted.is_set()
        assert time.monotonic() - t0 < 1.0 + launch.SETTLE_S
    finally:
        dist.destroy_process_group()


class _FakeEvent:
    """A CUDA event's stand-in that completes after ``polls`` queries."""

    def __init__(self, polls=0):
        self.polls, self.queries = polls, 0

    def query(self):
        self.queries += 1
        return self.queries > self.polls

    def elapsed_time(self, other):
        return 0.0

    def record(self):
        pass


def test_the_group_wait_posts_once_per_completed_epoch():
    from dca_tpu_torch.parallel.launch import LaunchError
    from dca_tpu_torch.train.graphs import GraphFit

    events = [_FakeEvent()] + [_FakeEvent(polls=3) for _ in range(4)]
    posts, checks = [], []
    GraphFit.wait(events, lambda: posts.append(sum(e.queries for e in events)),
                  lambda: checks.append(1), poll=0)
    # each epoch's post comes after its event completed, and after no later one
    assert posts == [4, 8, 12, 16] and len(checks) == 12
    assert events[0].queries == 0  # the event before the first replay is not waited on

    def check():
        if sum(e.queries for e in late) > 5:
            raise LaunchError("the rule failed a rank")

    late, posts = [_FakeEvent()] + [_FakeEvent(polls=3) for _ in range(4)], []
    with pytest.raises(LaunchError):
        GraphFit.wait(late, lambda: posts.append(1), check, poll=0)
    assert posts == [1]  # the first epoch completed, the second never did


def test_release_graphs_frees_the_whole_fit_graph(monkeypatch):
    from dca_tpu_torch.train import graphs

    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing=False: _FakeEvent())
    fit = object.__new__(graphs.GraphFit)
    fit.graph = fake = _FakeGraph()
    graphs._register(fit)
    other = object.__new__(graphs.GraphFit)
    other.graph = _FakeGraph()
    graphs._register(other)
    other.thread = -1
    fit.run(2)
    graphs.release_graphs(threading.get_ident())
    assert fake.released.is_set() and fake.replays == 2 and fit.graph is None
    with pytest.raises(RuntimeError, match="released"):
        fit.run(1)
    assert not other.graph.released.is_set()
    graphs.release_graphs(-1)
    assert other.graph is None


def _eager_graph_fit():
    """``GraphFit`` with no card, as a rank of a group takes it (no IF
    node): each replay runs the epoch body eagerly."""
    from dca_tpu_torch.train import graphs

    class EagerGraphFit(graphs.GraphFit):
        def __init__(self, body, state, generator, stop, device, conditional=True):
            assert not conditional
            self.body, self.stop, self.graph = body, stop, _FakeGraph()
            self.capture_s, self.node_launches, self.body_launches = 0.0, {}, {}
            graphs._register(self)

        def _replay(self):
            self.body()

    return EagerGraphFit


def test_the_compiled_group_fit_posts_once_per_epoch_the_device_ran(monkeypatch):
    """``compiled=True`` over a mesh of one gloo rank with the whole-fit
    graph taken (its predicate forced, its replays run eagerly, its events
    fakes): one replay and one post for each epoch run, none after the
    early stop (no IF node under a group: ``stop`` is read after each
    replay), and the bits of the same fit's eager epochs."""
    import torch.distributed as dist

    from dca_tpu_torch.parallel import launch
    from dca_tpu_torch.parallel.mesh import make_mesh
    from dca_tpu_torch.train import compiled, loop

    fit = dict(FIT, epochs=8, early_stop=1, learning_rate=0.05)
    store = dist.TCPStore("127.0.0.1", 0, 1, True, datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        eager = _fit_on(mesh, fit)
        n_fit = next(launch._FITS)  # the next fit's namespace
        monkeypatch.setattr(compiled, "GraphFit", _eager_graph_fit())
        monkeypatch.setattr(loop, "capture_steps", lambda *a: True)
        monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing=False: _FakeEvent(1))
        graph = _fit_on(mesh, fit)
        count = int(dist.PrefixStore(f"dca_tpu_torch/fit/{n_fit + 1}",
                                     dist.distributed_c10d._get_default_store()).get(
            launch._progress_key(0)))
    finally:
        dist.destroy_process_group()
    assert graph.fit.capture_s == 0.0 and eager.fit.capture_s is None
    assert graph.history == eager.history and graph.fit.epochs_run < fit["epochs"]
    assert count == graph.fit.epochs_run and graph.fit.after_stop_s == []


def _fit_on(mesh, fit):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.train.loop import train

    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(60, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    ad = io.normalize(io.read_dataset(AnnData(counts), check_counts=False))
    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), device="cpu",
                                    batchnorm=False, seed=3).build()
    return train(ad, net, devices=mesh, compiled=True, **fit)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
