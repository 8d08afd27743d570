"""``train(compiled=True)`` under a process group against the JAX
package's whole-fit program over a mesh (``dca_tpu/train/loop.py::
_train_compiled`` with ``mesh``, ``dca_tpu/train/compiled.py::build_fit_fn``
jitted once over its devices), on the CPU.

The port's ranks are this file run as a script, torchrun-style, over gloo:
two ranks (a 2 x 1 grid, ``devices="all"``) and four (a 2 x 2 grid,
``model_parallel=2``); the JAX package runs ``train(compiled=True,
devices=2)`` and ``devices=4, model_parallel=2`` on the 8 virtual CPU
devices of ``tests/conftest.py``.  Both start from the JAX network's
initial weights (bridged with ``bridge.params_from_jax``), without
BatchNorm and at dropout 0, and the port takes the JAX program's row
orders (``test_torch_compiled._jax_perms``, injected through
``train(_perms=...)``).  60 cells x 16 genes: 42 train and 18 validation
rows, which both grids' 2 data indices divide, so neither package pads and
both run the whole-fit program (a padded split takes the Python-epoch loop
in both: ``test_torch_compiled.py``).  At learning rate 0.05
ReduceLROnPlateau(1) fires within the 10 epochs.  Held:
every rank the same history, the whole-fit program run (``History.fit``),
the histories within rtol 1e-4 of the JAX package's (the tolerance of
``tests/test_torch_compiled.py``) and the epochs run exactly equal.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_torch_compiled import _jax_perms
from test_torch_parallel import _free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
RANK_TIMEOUT = 240  # seconds for each group of ranks, start-up included
RTOL = 1e-4
FIT = dict(epochs=10, batch_size=16, validation_split=0.3, seed=0, reduce_lr=1,
           early_stop=2, learning_rate=0.05, verbose=False)
N_TRAIN = 42
GRIDS = {"2x1": (2, 1), "2x2": (4, 2)}  # name: (ranks, model_parallel)


def _counts():
    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(60, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    return counts


def _rank_main(spec_path):
    """One rank: the port's compiled fit over the group's grid; one RESULT
    line."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.parallel import multihost
    from dca_tpu_torch.train.loop import train

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    ad = io.normalize(io.read_dataset(AnnData(_counts()), check_counts=False))
    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), device="cpu",
                                    batchnorm=False, hidden_dropout=0.0).build()
    net.model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in np.load(spec["weights"]).items()})
    hist = train(ad, net, compiled=True, devices="all", model_parallel=spec["model"],
                 _perms=np.load(spec["perms"]), **FIT)
    print("RESULT " + json.dumps({"rank": multihost.process_index(), "history": hist.history,
                                  "whole_fit": hist.fit is not None,
                                  "epochs_run": None if hist.fit is None
                                  else hist.fit.epochs_run}), flush=True)
    torch.distributed.destroy_process_group()


def _start(world, spec):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, HERE, spec], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def _collect(procs):
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, text[-4000:]
            line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            assert line, text[-4000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return sorted(outs, key=lambda o: o["rank"])


def _jax_network():
    from dca_tpu.models import AE_types

    return AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), seed=4,
                                     batchnorm=False, hidden_dropout=0.0).build()


@pytest.fixture(scope="module")
def runs(monkeypatch_module):
    """Each grid's ranks, started first, and the JAX package's fits on the
    same grids meanwhile."""
    import jax

    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.train.loop import train as jtrain

    from dca_tpu_torch.bridge import params_from_jax

    monkeypatch_module.setenv("DCA_TPU_FUSED_LOSS", "1")
    tmp = tempfile.mkdtemp(prefix="dca_torch_compiled_group_")
    jnet = _jax_network()
    weights = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)).items()}
    np.savez(os.path.join(tmp, "w.npz"), **weights)
    np.save(os.path.join(tmp, "perms.npy"), _jax_perms(FIT["seed"], FIT["epochs"], N_TRAIN))
    procs = {}
    for name, (world, model) in GRIDS.items():
        spec = os.path.join(tmp, f"{name}.json")
        with open(spec, "w") as f:
            json.dump({"weights": os.path.join(tmp, "w.npz"),
                       "perms": os.path.join(tmp, "perms.npy"), "model": model}, f)
        procs[name] = _start(world, spec)
    oracles = {}
    try:
        for name, (world, model) in GRIDS.items():
            jad = jio.normalize(jio.read_dataset(JAnnData(_counts()), check_counts=False))
            mesh = dict(devices=world, model_parallel=model) if model > 1 else dict(
                devices=world)
            oracles[name] = jtrain(jad, _jax_network(), compiled=True, **FIT, **mesh).history
    finally:
        ranks = {name: _collect(p) for name, p in procs.items()}
    return ranks, oracles


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.mark.parametrize("grid", list(GRIDS))
def test_the_compiled_group_fit_matches_the_jax_mesh_program(runs, grid):
    ranks, oracles = runs
    outs, want = ranks[grid], oracles[grid]
    assert len(outs) == GRIDS[grid][0]
    assert all(o["whole_fit"] for o in outs)
    assert all(o["history"] == outs[0]["history"] for o in outs)
    got = outs[0]["history"]
    assert set(got) == set(want)
    assert outs[0]["epochs_run"] == len(want["loss"]) == len(got["loss"])
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_reduce_lr_fires_in_the_compiled_group_fit(runs, grid):
    """Not a vacuous match: the callbacks' device arithmetic lowered the
    rate a tenth on every rank, as the JAX package's program did."""
    ranks, oracles = runs
    lrs = ranks[grid][0]["history"]["lr"]
    assert lrs[0] == pytest.approx(FIT["learning_rate"])
    assert min(lrs) == pytest.approx(0.1 * FIT["learning_rate"]), lrs
    np.testing.assert_allclose(lrs, oracles[grid]["lr"], rtol=RTOL)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
