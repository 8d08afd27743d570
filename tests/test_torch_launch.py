"""Several devices from one process: ``train(devices=N)``, ``dca(adata,
devices=N)`` and ``python -m dca_tpu_torch ... --devices N`` with no
process group start their own ranks (``dca_tpu_torch/parallel/launch.py``),
here N gloo ranks on the CPU, against the JAX package's single-program
mesh on its 8 virtual CPU devices.

The data and the model are ``tests/test_torch_model_parallel.py``'s: 64
cells x 16 genes, (8, 4, 8) zinb-conddisp with ridge 0.01 and l2_coef
0.01, batch 16, validation_split 0.3, 2 epochs, from the JAX package's
initial weights, bridged.

  (a) ``train(devices=2)`` and ``train(devices=4, model_parallel=2)`` from
      this process against ``dca_tpu``'s fits on a mesh of as many
      devices: history rtol 1e-4, the gathered parameters rtol 5e-3, atol
      1.5e-3 (tests/test_torch_model_parallel.py's bounds); the grid fit
      again in the same process gives the same bits (its groups are made
      anew for the new process group);
  (b) ``dca(adata, devices=2)``, twice in a row: the history and the
      denoised matrix of the same fit's rank 0 under torchrun-style ranks
      (this file run as a script), bit for bit;
  (c) the CLI with ``--devices 2 --device cpu``: mean.tsv within rtol 1e-4
      of the one-process CLI's;
  (d) after every call no process group, no child process and no shared
      memory of the call is left; a worker that dies in the fit, or never
      joins, ends the call with an error naming its rank;
  (e) what ``devices`` means on CUDA devices (their count monkeypatched),
      and the shared-memory round trip of a dense and a CSR input.
"""

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from test_torch_parallel import _free_port, _results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)

FIT = dict(epochs=2, batch_size=16, validation_split=0.3, verbose=False, seed=0,
           reduce_lr=0, early_stop=0)
REG = {"ridge": 0.01, "l2_coef": 0.01}
DCA = dict(ae_type="zinb-conddisp", hidden_size=(8, 4, 8), epochs=2, batch_size=16,
           reduce_lr=0, early_stop=0, random_state=0, copy=True, return_info=True,
           device="cpu", training_kwds={"validation_split": 0.3})


def _counts():
    """64 cells x 16 genes of Poisson counts, no all-zero row or gene."""
    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(64, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    return counts


def _adata():
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    return io.normalize(io.read_dataset(AnnData(_counts()), check_counts=False))


def _network(weights):
    from dca_tpu_torch.models.network import AE_types

    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), seed=4,
                                    device="cpu", **REG).build()
    net.model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return net


def _state(net):
    return {k: v.detach().numpy().copy() for k, v in net.model.state_dict().items()}


def _children():
    """The pids of this process's children."""
    pid, kids = os.getpid(), set()
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                kids |= set(f.read().split())
        except OSError:
            pass
    return kids


def _memfds():
    """This process's open shared-memory files of the launcher."""
    out = []
    for fd in os.listdir("/proc/self/fd"):
        try:
            link = os.readlink(f"/proc/self/fd/{fd}")
        except OSError:
            continue
        if link.startswith("/memfd:dca_tpu_torch"):
            out.append(link)
    return out


def _left(before):
    """What a launcher call left behind: (a process group, new children,
    shared memory)."""
    return (torch.distributed.is_initialized(), sorted(_children() - before), _memfds())


# ---------------------------------------------------------------------------
# torchrun-style ranks: this file run as a script
# ---------------------------------------------------------------------------


def _rank_main(spec_path):
    """One rank: join the group from RANK/WORLD_SIZE/MASTER_ADDR, run
    ``dca(adata, devices="all")``; rank 0 leaves its history and denoised
    matrix in the spec's directory."""
    from dca_tpu_torch import dca
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.parallel import multihost

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    ret = dca(AnnData(_counts()), devices="all", **DCA)
    if multihost.is_primary():
        np.save(os.path.join(spec["dir"], "denoised.npy"), ret.X)
    print("RESULT " + json.dumps({"rank": multihost.process_index(),
                                  "history": ret.uns["dca_loss_history"]}), flush=True)
    torch.distributed.destroy_process_group()


def _start_ranks(world, d):
    path = os.path.join(d, "spec.json")
    with open(path, "w") as f:
        json.dump({"dir": d}, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, HERE, path], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


# ---------------------------------------------------------------------------
# the oracles (JAX imports stay in here)
# ---------------------------------------------------------------------------


def _jax_network():
    from dca_tpu.models import AE_types

    return AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), seed=4,
                                     **REG).build()


def _bridged(jnet):
    import jax

    from dca_tpu_torch.bridge import params_from_jax

    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                         jax.tree_util.tree_map(np.asarray, jnet.state))
    return {k: v.numpy() for k, v in sd.items()}


def _jax_fit(jnet, **mesh):
    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.train.loop import train as jtrain

    jad = jio.normalize(jio.read_dataset(JAnnData(_counts()), check_counts=False))
    return jtrain(jad, jnet, compiled=False, **FIT, **mesh).history


@pytest.fixture(scope="module")
def runs():
    """The torchrun-style ranks, started first; the JAX oracles; then the
    launcher's calls from this process, one after the other, each with
    what it left behind."""
    from dca_tpu_torch import dca
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.train.loop import train

    tmp = tempfile.mkdtemp(prefix="dca_torch_launch_")
    ranks = _start_ranks(2, tmp)
    jnet = _jax_network()
    weights = _bridged(jnet)
    oracles = {"dp2": _jax_fit(_jax_network(), devices=2)}
    mesh_net = _jax_network()
    oracles["mp22"] = _jax_fit(mesh_net, devices=4, model_parallel=2)
    oracles["mp22_params"] = _bridged(mesh_net)
    out = {"left": {}}

    def launched(name, fn):
        before = _children()
        t0 = time.perf_counter()
        out[name] = fn()
        out["left"][name] = _left(before)
        out.setdefault("seconds", {})[name] = time.perf_counter() - t0

    def fit(**mesh):
        net = _network(weights)
        hist = train(_adata(), net, **FIT, **mesh)
        return hist, _state(net)

    launched("dp2", lambda: fit(devices=2))
    launched("mp22", lambda: fit(devices=4, model_parallel=2))
    launched("mp22_again", lambda: fit(devices=4, model_parallel=2))
    for name in ("dca", "dca_again"):
        launched(name, lambda: dca(AnnData(_counts()), devices=2, **DCA))
    out["ranks"] = _results(ranks)
    out["ranks_denoised"] = np.load(os.path.join(tmp, "denoised.npy"))
    out["oracles"] = oracles
    return out


def test_two_ranks_from_one_process_match_the_jax_mesh(runs):
    hist, _ = runs["dp2"]
    assert hist.launch["ranks"] == 2 and hist.launch["backend"] == "gloo"
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist.history[key], runs["oracles"]["dp2"][key], rtol=1e-4,
                                   err_msg=key)


def test_a_grid_from_one_process_matches_the_jax_mesh(runs):
    hist, state = runs["mp22"]
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist.history[key], runs["oracles"]["mp22"][key], rtol=1e-4,
                                   err_msg=key)
    # the caller's network holds the whole trained parameters
    want = runs["oracles"]["mp22_params"]
    assert sorted(state) == sorted(want)
    for k in want:
        assert state[k].shape == want[k].shape, k
        np.testing.assert_allclose(state[k], want[k], rtol=5e-3, atol=1.5e-3, err_msg=k)


def test_a_second_grid_in_the_process_gives_the_same_bits(runs):
    (first, a), (second, b) = runs["mp22"], runs["mp22_again"]
    assert first.history == second.history
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["dca", "dca_again"])
def test_dca_is_the_torchrun_ranks_fit(runs, name):
    ret = runs[name]
    ranks = runs["ranks"]
    assert ranks[0]["history"] == ranks[1]["history"]
    assert ret.uns["dca_loss_history"] == ranks[0]["history"]
    np.testing.assert_array_equal(ret.X, runs["ranks_denoised"])


@pytest.mark.parametrize("name", ["dp2", "mp22", "mp22_again", "dca", "dca_again"])
def test_a_call_leaves_no_group_child_or_shared_memory(runs, name):
    assert runs["left"][name] == (False, [], [])


def _cli(tsv, out, *extra):
    from dca_tpu_torch.__main__ import main

    # without BatchNorm: the Dense bias before it has a gradient of exactly
    # 0, which RMSprop turns into learning-rate-sized steps of rounding
    # noise, other on one process and on two ranks
    main([tsv, out, "--device", "cpu", "-e", "2", "-s", "8,4,8", "--nocheckcounts",
          "--nobatchnorm", "--type", "zinb-conddisp", *extra])


def test_cli_without_torchrun_matches_one_process(tmp_path, capsys):
    counts = _counts().astype(int)
    tsv = str(tmp_path / "counts.tsv")
    pd.DataFrame(counts.T, index=[f"g{i}" for i in range(16)],
                 columns=[f"c{i}" for i in range(64)]).to_csv(tsv, sep="\t")
    before = _children()
    _cli(tsv, str(tmp_path / "two"), "--devices", "2")
    assert _left(before) == (False, [], [])
    assert len([ln for ln in capsys.readouterr().out.splitlines() if "Epoch " in ln]) == 2
    _cli(tsv, str(tmp_path / "one"))
    for fname, header in (("mean.tsv", 0), ("dispersion.tsv", None), ("dropout.tsv", None)):
        got, want = (pd.read_csv(tmp_path / d / fname, sep="\t", index_col=0, header=header)
                     for d in ("two", "one"))
        assert got.shape == want.shape == (16, 64), fname
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-4, err_msg=fname)
    assert sorted(os.listdir(tmp_path / "two")) == sorted(os.listdir(tmp_path / "one"))


# a worker that runs the real one, but at the end of its second epoch
# dies (exit code 3) or stops answering while its process lives on
FAILING = """
import os, sys, time
from dca_tpu_torch.parallel import launch
from dca_tpu_torch.train import loop
end = loop._FitCallbacks.end_epoch
def failing(self, epoch, monitor):
    if epoch == 1:
        sys.stderr.write("the worker HOW after epoch 2\\n")
        sys.stderr.flush()
        if "HOW" == "dies":
            os._exit(3)
        time.sleep(120)
    return end(self, epoch, monitor)
loop._FitCallbacks.end_epoch = failing
launch._worker_main(*(int(a) for a in sys.argv[1:4]))
"""
# launch.TIMEOUT_S of each case: it also bounds a worker's start-up, which
# takes several seconds on a loaded host, so the silent worker needs room
FAIL_TIMEOUTS = {"dies": 60.0, "silent": 3.0, "hangs": 20.0}


@pytest.mark.parametrize("how", ["dies", "silent", "hangs"])
def test_a_failed_worker_ends_the_call_naming_its_rank(monkeypatch, how):
    """A worker that dies in the fit, one that never joins, and one that
    stops answering after epoch 2 while its process lives (the progress
    rule: no rank moved for TIMEOUT_S, and rank 1 is behind)."""
    from dca_tpu_torch.parallel import launch
    from dca_tpu_torch.train.loop import train

    monkeypatch.setattr(launch, "TIMEOUT_S", FAIL_TIMEOUTS[how])
    script = ("import time; time.sleep(120)" if how == "silent"
              else FAILING.replace("HOW", how))
    monkeypatch.setattr(launch, "worker_command", lambda rank, world, port: [
        sys.executable, "-c", script, str(port), str(rank), str(world)])
    net = _network(_own_weights())
    before = _children()
    t0 = time.perf_counter()
    with pytest.raises(launch.LaunchError) as err:
        train(_adata(), net, **dict(FIT, epochs=5), devices=2)
    assert time.perf_counter() - t0 < 60
    msg = str(err.value)
    assert "rank 1 of 2" in msg, msg
    if how == "dies":
        assert "exited with code 3" in msg and "the worker dies after epoch 2" in msg, msg
    elif how == "hangs":
        assert "made no progress for 20 s" in msg and "the worker hangs after epoch 2" in msg, msg
    else:
        assert "did not join within 3 s" in msg, msg
    assert _left(before) == (False, [], [])


class _FakeProc:
    pid = 4242

    def poll(self):
        return None  # alive


class _FakeWorker:
    """A worker of ``launch._Monitor`` with no process behind it."""

    def __init__(self, rank):
        self.rank, self.proc, self.killed = rank, _FakeProc(), False

    def kill(self):
        self.killed = True

    def stderr(self):
        return ""


def test_the_rank_behind_is_the_least_count_then_the_oldest_move():
    from dca_tpu_torch.parallel.launch import behind

    assert behind({0: 4, 1: 3, 2: 5}, {0: 1.0, 1: 3.0, 2: 2.0}) == 1
    assert behind({0: 4, 1: 4, 2: 4}, {0: 3.0, 1: 2.0, 2: 1.0}) == 2
    assert behind({0: 2, 1: 2}, {0: 1.0, 1: 1.0}) == 0


@pytest.mark.parametrize("stops", [1, 0])
def test_the_monitor_fails_the_rank_behind_once_no_rank_moves(stops):
    """The progress rule on a real TCPStore with fake workers: while any
    rank posts, no rank is failed, however long another has been silent;
    once none has moved for the timeout the rank behind (``stops``, which
    stopped first) is failed, every worker killed, and rank 0's next post
    raises.  Rank 0 behind is named as this process."""
    import datetime

    from dca_tpu_torch.parallel import launch

    store = torch.distributed.TCPStore("127.0.0.1", 0, None, True,
                                       datetime.timedelta(seconds=30), wait_for_workers=False)
    world, timeout = 3, 2.0  # seconds: room for a loaded host's scheduling
    for r in range(world):
        store.set(launch._progress_key(r), "0")
    workers = [_FakeWorker(r) for r in range(1, world)]
    monitor = launch._Monitor(workers)
    try:
        monitor.stall = launch._Stall(store, world, timeout)
        posts = [launch.Progress(store, r, monitor.raise_failed if r == 0 else None)
                 for r in range(world)]
        for post in posts:
            post()
        # ``stops`` is silent for 4 timeouts while the others move
        t_end = time.monotonic() + 4 * timeout
        while time.monotonic() < t_end:
            for r in range(world):
                if r != stops:
                    posts[r]()
            time.sleep(timeout / 10)
        assert monitor.failed is None
        t_end = time.monotonic() + 10 * timeout
        while monitor.failed is None and time.monotonic() < t_end:
            time.sleep(0.05)
        assert monitor.failed is not None
        worker, what = monitor.failed
        assert (worker.rank if worker is not None else 0) == stops
        assert f"made no progress for {timeout:g} s" in what
        assert all(w.killed for w in workers)
        with pytest.raises(launch.LaunchError):
            posts[0]()
        with pytest.raises(launch.LaunchError, match=f"rank {stops} of {world}"):
            launch._raise_failure(monitor, world)
    finally:
        monitor.stop()
        monitor.stall = None
        del store


class _FakeGraph:
    """A captured graph's stand-in: counts its replays, records its reset."""

    def __init__(self):
        self.replays, self.released = 0, threading.Event()

    def replay(self):
        self.replays += 1

    def reset(self):
        self.released.set()


def _fake_steps(thread):
    """A ``GraphSteps`` of two fake graphs, registered as a capture on
    ``thread`` registers it (no CUDA device here)."""
    from dca_tpu_torch.train import graphs

    steps = object.__new__(graphs.GraphSteps)
    steps.graphs = {False: _FakeGraph(), True: _FakeGraph()}
    steps.launches = {False: {}, True: {}}
    steps.thread, steps.lock = thread, threading.Lock()
    with graphs._LIVE_LOCK:
        graphs._LIVE.add(steps)
    return steps


def test_release_graphs_destroys_the_graphs_of_one_thread():
    """``graphs.release_graphs(thread)`` resets the step graphs that
    ``thread`` captured and no other; a replay of released steps raises."""
    from dca_tpu_torch.train.graphs import release_graphs

    mine, other = _fake_steps(threading.get_ident()), _fake_steps(-1)
    mine.replay(False, 3)
    fakes = list(mine.graphs.values())
    release_graphs(threading.get_ident())
    assert all(g.released.is_set() for g in fakes) and fakes[0].replays == 3
    with pytest.raises(RuntimeError, match="released"):
        mine.replay(False)
    other.replay(True)
    assert not any(g.released.is_set() for g in other.graphs.values())
    assert other.graphs[True].replays == 1


def test_the_abort_ends_once_the_fits_graphs_are_released(monkeypatch):
    """The launcher's NCCL abort (``launch._abort_group``) starts the
    group's abort and meanwhile destroys rank 0's step graphs: an abort
    that, as NCCL's does, finishes only once no graph holds the
    communicator's collectives ends, with the graphs released."""
    import torch.distributed as dist

    from dca_tpu_torch.parallel import launch

    steps = _fake_steps(threading.get_ident())
    fakes = list(steps.graphs.values())
    seen = {}

    def abort():  # NCCL's: the communicator goes once no graph holds it
        seen["released"] = all(g.released.wait(10.0) for g in fakes)

    monkeypatch.setattr(dist.distributed_c10d, "_abort_process_group", abort)
    t0 = time.monotonic()
    launch._abort_group(threading.get_ident())
    assert seen == {"released": True} and time.monotonic() - t0 < 5.0


def _own_weights():
    # the port's own initial weights, for the tests that need no JAX oracle
    from dca_tpu_torch.models.network import AE_types

    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), seed=4,
                                    device="cpu", **REG).build()
    return _state(net)


def test_devices_name_the_cuda_devices_as_the_jax_package(monkeypatch):
    """An int N the first N visible devices, "all" every one, a list those
    it names, the network's first; more than are visible raise with the
    JAX package's message, through ``train`` too, before anything runs."""
    from dca_tpu_torch.parallel.mesh import rank_devices
    from dca_tpu_torch.train.loop import train

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    net = _network(_own_weights())
    net.device = torch.device("cuda")
    with pytest.raises(ValueError, match="requested 3 devices, only 1 visible"):
        train(_adata(), net, **FIT, devices=3)
    assert rank_devices(1, torch.device("cuda")) is None  # one device: no ranks to start
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert rank_devices(2, torch.device("cuda")) == cuda[:2]
    assert rank_devices("all", torch.device("cuda", 0)) == cuda
    assert rank_devices([0, "cuda:3"], torch.device("cuda")) == [cuda[0], cuda[3]]
    with pytest.raises(ValueError, match="starts with cuda:2.*network is on cuda:0"):
        rank_devices([2, 0], torch.device("cuda"))
    # the one card shared by N ranks (over gloo), and the CPU's N gloo ranks
    assert rank_devices(2, torch.device("cuda", 1), one_card=True) == [cuda[1]] * 2
    assert rank_devices(3, torch.device("cpu")) == [torch.device("cpu")] * 3
    assert rank_devices("all", torch.device("cpu")) is None


def test_a_torchrun_rank_without_a_group_starts_no_ranks(monkeypatch):
    """Under torchrun (WORLD_SIZE set) a rank that has not joined its group
    raises, naming initialize(), where each rank would start ranks of its
    own on the same devices."""
    from dca_tpu_torch.parallel.mesh import rank_devices
    from dca_tpu_torch.train.loop import train

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    before = _children()
    with pytest.raises(ValueError, match=r"rank 1 of WORLD_SIZE=2 \(torchrun\).*initialize"):
        train(_adata(), _network(_own_weights()), **FIT, devices=2)
    assert _left(before) == (False, [], [])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="torchrun"):
        rank_devices("all", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="torchrun"):
        rank_devices(2, torch.device("cuda", 0), one_card=True)
    # what starts no ranks is as before
    assert rank_devices("all", torch.device("cpu")) is None
    assert rank_devices(1, torch.device("cuda", 0)) is None


@pytest.mark.parametrize("kind", ["dense", "csr"])
def test_the_shared_inputs_cross_byte_for_byte(kind):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.parallel.launch import adata_from, attach, share_adata

    X = _counts()
    ad = io.read_dataset(AnnData(sp.csr_matrix(X) if kind == "csr" else X),
                         check_counts=False)
    ad = io.normalize(ad, lazy_scale=kind == "csr")
    shared, desc = share_adata(ad)
    try:
        # this process stands in for a worker: its own descriptors
        specs = {k: (None if fd is None else os.dup(fd), dt, sh)
                 for k, (fd, dt, sh) in shared.specs.items()}
        got = adata_from(desc, attach(specs))
    finally:
        shared.close()

    def same(a, b):
        if sp.issparse(a):
            assert sp.issparse(b)
            for part in ("data", "indices", "indptr"):
                x, y = getattr(a, part), getattr(b, part)
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), part
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    same(ad.X, got.X)
    same(ad.raw.X, got.raw.X)
    assert list(got.raw.var_names) == list(ad.raw.var_names)
    same(ad.obs["size_factors"], got.obs["size_factors"])
    assert sorted(got.uns) == sorted(k for k in ad.uns if k.startswith("dca_scale_"))
    for k in got.uns:
        same(ad.uns[k], got.uns[k])
    assert shared.nbytes > 0
    # the last hold on the memory is the mapping of the arrays
    del got
    gc.collect()
    assert _memfds() == []


if __name__ == "__main__":
    _rank_main(sys.argv[1])
