"""The sharded training step as a replayable program
(``dca_tpu_torch/parallel/step.py::make_sharded_train_step``, replayed from
CUDA graphs over NCCL by ``train/graphs.py``), on the CPU.

A CUDA graph replays what was captured and nothing else: a step that reads
a value back to the host (``Tensor.item``, ``.tolist``, ``.cpu``,
``.numpy`` or a tensor's truth value) cannot be captured, or would replay
the value it read at the capture.  The CPU tests have no card and no
NCCL, so the CPU stands in: the step of a launched 2-rank gloo fit runs with
those five methods made to raise, on rank 0 (this process) and on the
worker (the launcher's worker, patched the same way), data parallel and on
a 1 x 2 model-parallel grid, in memory and streamed.  The fits are
``tests/test_torch_launch.py``'s (64 cells x 16 genes, zinb-conddisp (8,
4, 8), batch 16, 2 epochs).

The predicate that decides whether a fit captures its steps
(``graphs.capture_steps``) is held to its rule over every (device,
backend, debug, ``_graphs``): captured only on CUDA, with no group or
over NCCL, outside ``debug`` and unless ``_graphs=False``.  The comparisons
of the multi-rank CPU fits against the JAX package's mesh stay in
``tests/test_torch_launch.py``, ``test_torch_parallel.py`` and
``test_torch_model_parallel.py``.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_launch import FIT, _adata, _children, _left, _network, _own_weights

HERE = os.path.dirname(os.path.abspath(__file__))
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__")
STEPS = {"calls": 0}  # the sharded steps run under no_host_reads in this process


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor (``HOST_READS``) raises inside."""
    own = {name: torch.Tensor.__dict__.get(name) for name in HOST_READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"the sharded step read a tensor back: Tensor.{name}")
        return read

    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in own.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)


def forbid_host_reads(loop):
    """Make every step that ``loop`` builds run under ``no_host_reads``."""
    make = loop.make_sharded_train_step

    def make_checked(*args, **kwargs):
        step = make(*args, **kwargs)

        def checked(*a, **k):
            with no_host_reads():
                step(*a, **k)
            STEPS["calls"] += 1

        return checked

    loop.make_sharded_train_step = make_checked


# the launcher's worker, its steps run under no_host_reads
WORKER = f"""
import sys
sys.path.insert(0, {HERE!r})
from dca_tpu_torch.parallel import launch
from dca_tpu_torch.train import loop
import test_torch_parallel_graphs
test_torch_parallel_graphs.forbid_host_reads(loop)
launch._worker_main(*(int(a) for a in sys.argv[1:4]))
"""

CASES = {  # name: train keywords
    "dp2": {},
    "mp12": {"model_parallel": 2},
    "dp2_streamed": {"max_device_cells": 16},
    "mp12_streamed": {"model_parallel": 2, "max_device_cells": 16},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_sharded_step_reads_nothing_back(monkeypatch, case):
    """The step of a launched 2-rank fit reads no tensor back, on either
    rank (a read raises, and a worker's error ends the call); the fit's
    history is finite and the step ran every step of the fit on rank 0."""
    from dca_tpu_torch.parallel import launch
    from dca_tpu_torch.train import loop

    monkeypatch.setattr(loop, "make_sharded_train_step", loop.make_sharded_train_step)
    forbid_host_reads(loop)
    monkeypatch.setattr(launch, "worker_command", lambda rank, world, port: [
        sys.executable, "-c", WORKER, str(port), str(rank), str(world)])
    monkeypatch.setenv("DCA_TPU_PREFETCH", "0")  # staging on the fit's thread, between steps
    STEPS["calls"] = 0
    before = _children()
    hist = loop.train(_adata(), _network(_own_weights()), **FIT, devices=2, **CASES[case])
    # 64 cells, 30% validation: 44 train rows, 2 full steps of 16 and a trailing 12
    assert STEPS["calls"] == 3 * FIT["epochs"]
    assert len(hist.history["loss"]) == FIT["epochs"]
    assert np.isfinite(hist.history["loss"] + hist.history["val_loss"]).all()
    assert _left(before) == (False, [], [])


def test_no_host_reads_refuses_each_read_and_restores_them():
    t = torch.ones(2)
    before = {name: torch.Tensor.__dict__.get(name) for name in HOST_READS}
    with no_host_reads():
        for read in (lambda: t.sum().item(), t.tolist, t.cpu, t.numpy, lambda: bool(t[0])):
            with pytest.raises(AssertionError, match="read a tensor back"):
                read()
    assert {name: torch.Tensor.__dict__.get(name) for name in HOST_READS} == before
    assert t.sum().item() == 2.0 and t.tolist() == [1.0, 1.0] and bool(t[0])


@pytest.mark.parametrize("graphs", [True, False])
@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("backend", [None, "gloo", "nccl"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_capture_predicate(device, backend, debug, graphs):
    """Captured only on CUDA, with no group or over NCCL, outside debug,
    unless _graphs=False: gloo's collectives run on the host."""
    from dca_tpu_torch.train.graphs import capture_steps

    want = device == "cuda" and backend in (None, "nccl") and not debug and graphs
    assert capture_steps(torch.device(device), backend, debug, graphs) is want


@pytest.mark.parametrize("graphs", [True, False])
@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("backend", [None, "gloo", "nccl"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_whole_fit_graph_predicate(monkeypatch, device, backend, debug, graphs):
    """``compiled=True`` takes the whole-fit graph (``graphs.GraphFit``)
    exactly where the steps would be captured: on CUDA, with no group or
    over NCCL, outside debug, unless _graphs=False; a group no longer
    keeps it from the graph.  What ``_train_compiled`` hands the fit, on a
    stand-in network and mesh."""
    from types import SimpleNamespace

    from dca_tpu_torch.train import compiled, loop

    seen = {}

    class Handed(Exception):
        pass

    def build_fit_fn(network, opt, **kw):
        def fit(*args, graphs, **kwargs):
            seen["graphs"] = graphs
            raise Handed

        return fit

    monkeypatch.setattr(compiled, "build_fit_fn", build_fit_fn)
    monkeypatch.setattr(loop, "_backend", lambda group: backend)
    net = SimpleNamespace(device=torch.device(device), definition=SimpleNamespace(debug=debug))
    mesh = None if backend is None else SimpleNamespace(world=object())
    with pytest.raises(Handed):
        loop._train_compiled(net, None, 0.1, mesh, (None, None, None), None, None, None, None,
                             None, n_train=42, batch_size=16, epochs=3, reduce_lr=0,
                             early_stop=0, save_weights=False, output_dir=None, verbose=False,
                             graphs=graphs, tb=False, tb_log=None, trace=None)
    want = device == "cuda" and backend in (None, "nccl") and not debug and graphs
    assert seen["graphs"] is want


@pytest.mark.parametrize("streamed", [False, True])
def test_a_group_of_one_rank_is_a_mesh_of_one(streamed):
    """Under a process group of one rank the mesh of one
    (``make_mesh(1)``, passed as ``devices``) runs the sharded step with
    its collectives over the one rank (``chip_smoke.py`` phase 14 does
    this over NCCL on the card): the fit of the single-device path within
    rtol 1e-5 (BatchNorm's mean is a sum over the group divided by the
    batch, the loss the kernel's sum over the summed count).
    ``devices="all"`` there stays the single-device path."""
    import datetime

    import torch.distributed as dist

    from dca_tpu_torch.parallel.mesh import make_mesh, resolve_mesh
    from dca_tpu_torch.train.loop import train

    kw = {"max_device_cells": 16} if streamed else {}
    one = train(_adata(), _network(_own_weights()), **FIT, **kw).history
    store = dist.TCPStore("127.0.0.1", 0, 1, True, datetime.timedelta(seconds=60))
    dist.init_process_group("gloo", store=store, world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        assert (mesh.n_data, mesh.n_model, mesh.rank) == (1, 1, 0)
        assert resolve_mesh(mesh) is mesh
        assert resolve_mesh("all") is None and resolve_mesh(None) is None
        got = train(_adata(), _network(_own_weights()), **FIT, devices=mesh, **kw).history
    finally:
        dist.destroy_process_group()
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got[key], one[key], rtol=1e-5)
