"""Data-parallel training of the PyTorch port over ``torch.distributed``
(gloo) on the CPU, against the JAX package's single-process fit.

The ranks are processes that run this file as a script: they import the
port and torch, never JAX or the JAX package, so every JAX import of this
file sits inside the functions that compute the oracles.  The data and the
model are ``tests/test_multiprocess.py``'s phase 5 (61 cells x 16 genes,
(8, 4, 8), batch 16, validation_split 0.3, 2 epochs), from the JAX
package's initial weights, bridged:

  (a) nb-conddisp on 2 ranks: 42 train rows, the trailing batch of 10
      split 5/5; 19 validation rows padded to 20 at weight 0, so the
      validation goes through the weighted loss (K1w's plain version);
  (b) zinb-conddisp on 3 ranks with ridge 0.01 and l2_coef 0.01, which
      catches a penalty counted once per rank;
  (c) 49 cells on 3 ranks: a trailing batch of 2 rows, so one rank's
      share is empty; 15 validation rows divide the ranks: no padding and
      no weighted evaluation;
  (d) zinb-conddisp on 3 ranks with hidden dropout 0.1, against the port's
      own single-process fit (JAX draws other random numbers).

Each rank's per-epoch loss and val_loss must be the same on every rank
and within rtol 1e-4 of the oracle.  The CLI runs under ``torchrun
--standalone`` with two ranks, and rank 0 alone writes its outputs.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
RANK_TIMEOUT = 240  # seconds for one group of ranks, start-up included

FIT = dict(epochs=2, batch_size=16, validation_split=0.3, verbose=False, seed=0,
           reduce_lr=0, early_stop=0)
CASES = {  # name: (ae_type, cells, network keywords, ranks)
    "a": ("nb-conddisp", 61, {}, 2),
    "b": ("zinb-conddisp", 61, {"ridge": 0.01, "l2_coef": 0.01}, 3),
    "c": ("nb-conddisp", 49, {}, 3),
    "d": ("zinb-conddisp", 61, {"hidden_dropout": 0.1}, 3),
}


def _counts(n_cells):
    """tests/test_multiprocess.py's phase-5 matrix, cut to ``n_cells``."""
    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(64, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    out = counts[:n_cells].copy()
    out[:, 0] += 1
    out[0, :] += 1
    return out


def _port_fit(case, weights=None, devices=None):
    """The port's fit of ``case`` on the CPU; returns (loss, val_loss)."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.train.loop import train

    ae_type, cells, kw, _ = CASES[case]
    ad = io.normalize(io.read_dataset(AnnData(_counts(cells)), check_counts=False))
    net = AE_types[ae_type](input_size=16, hidden_size=(8, 4, 8), seed=4, device="cpu",
                            **kw).build()
    if weights is not None:
        net.model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    hist = train(ad, net, devices=devices, **FIT).history
    return hist["loss"], hist["val_loss"]


# ---------------------------------------------------------------------------
# the ranks: this file run as a script
# ---------------------------------------------------------------------------


def _rank_main(spec_path):
    """One rank: join the group from RANK/WORLD_SIZE/MASTER_ADDR, fit every
    case of the spec, check the row-block helpers, print one RESULT line."""
    torch.set_num_threads(1)
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.parallel import multihost

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    rank, world = multihost.process_index(), multihost.process_count()

    calls = {"plain": 0, "weighted": 0}
    sums = fl._fwd_sums_reference

    def spy(y, mu, theta, pi, ridge, w=None):
        # on the CPU the wrappers run the kernels' plain versions: count them
        calls["plain" if w is None else "weighted"] += 1
        return sums(y, mu, theta, pi, ridge, w)

    fl._fwd_sums_reference = spy
    out = {"rank": rank, "fits": {}}
    for case in spec["cases"]:
        calls.update(plain=0, weighted=0)
        weights = None
        if case in spec["weights"]:
            weights = dict(np.load(spec["weights"][case]))
        loss, val = _port_fit(case, weights, devices="all")
        out["fits"][case] = {"loss": loss, "val_loss": val, "calls": dict(calls)}

    # the row-block helpers of multihost, as tests/multiproc_worker.py checks them
    n = 7
    lo, hi = multihost.process_row_range(n)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    np.testing.assert_array_equal(multihost.gather_to_host(torch.from_numpy(x[lo:hi])), x)
    path = os.path.join(spec["dir"], "rows.tsv")
    part = multihost.write_sharded(x[lo:hi], path, rownames=[f"c{i}" for i in range(lo, hi)])
    assert part.endswith(f".part{rank}")
    torch.distributed.barrier()
    if multihost.is_primary():
        multihost.concat_shards(path, has_header=False)
        back = pd.read_csv(path, sep="\t", index_col=0, header=None)
        np.testing.assert_array_equal(back.to_numpy(np.float32), x)
        assert list(back.index) == [f"c{i}" for i in range(n)]
    torch.distributed.barrier()
    out["rows"] = [lo, hi]
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_ranks(world, spec):
    """Start ``world`` ranks of this file on ``spec``; they find each other
    as torchrun's ranks do, from RANK, WORLD_SIZE and MASTER_ADDR/PORT."""
    path = os.path.join(spec["dir"], f"spec{world}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
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


def _results(procs):
    """Each rank's RESULT; a rank that fails or outlives RANK_TIMEOUT fails
    the test, and no rank is left running."""
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


# ---------------------------------------------------------------------------
# the oracles (JAX imports stay in here)
# ---------------------------------------------------------------------------


def _jax_network(case):
    from dca_tpu.models import AE_types

    ae_type, _, kw, _ = CASES[case]
    return AE_types[ae_type](input_size=16, hidden_size=(8, 4, 8), seed=4, **kw).build()


def _bridged(jnet):
    import jax

    from dca_tpu_torch.bridge import params_from_jax

    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                         jax.tree_util.tree_map(np.asarray, jnet.state))
    return {k: v.numpy() for k, v in sd.items()}


def _jax_fit(case, jnet):
    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.train.loop import train as jtrain

    jad = jio.normalize(jio.read_dataset(JAnnData(_counts(CASES[case][1])),
                                         check_counts=False))
    hist = jtrain(jad, jnet, compiled=False, **FIT).history
    return hist["loss"], hist["val_loss"]


@pytest.fixture(scope="module")
def runs():
    """Both groups of ranks, started before the oracles are computed so
    that they run meanwhile: {case: (oracle, [each rank's fit])} and each
    rank's result."""
    os.environ["DCA_TPU_FUSED_LOSS"] = "1"  # the JAX side's kernels, in interpret mode
    tmp = tempfile.mkdtemp(prefix="dca_torch_parallel_")
    try:
        jnets, weights = {}, {}
        for case in ("a", "b", "c"):
            jnets[case] = _jax_network(case)
            weights[case] = os.path.join(tmp, f"w_{case}.npz")
            np.savez(weights[case], **_bridged(jnets[case]))
        groups = {}
        for world in (2, 3):
            cases = [c for c, spec in CASES.items() if spec[3] == world]
            groups[world] = _start_ranks(world, {"dir": tmp, "cases": cases,
                                                 "weights": weights})
        oracles = {case: _jax_fit(case, jnets[case]) for case in ("a", "b", "c")}
        oracles["d"] = _port_fit("d")
        results = {world: _results(procs) for world, procs in groups.items()}
    finally:
        del os.environ["DCA_TPU_FUSED_LOSS"]
    fits = {case: (oracles[case], [r["fits"][case] for r in results[spec[3]]])
            for case, spec in CASES.items()}
    return fits, results


def _check_fit(runs, case):
    (loss, val_loss), ranks = runs[0][case]
    for fit in ranks[1:]:
        assert fit["loss"] == ranks[0]["loss"] and fit["val_loss"] == ranks[0]["val_loss"]
    # the sums of the batch statistics, the losses and the gradients run
    # over the ranks in another order than on one device
    np.testing.assert_allclose(ranks[0]["loss"], loss, rtol=1e-4, err_msg=case)
    np.testing.assert_allclose(ranks[0]["val_loss"], val_loss, rtol=1e-4, err_msg=case)
    return [fit["calls"] for fit in ranks]


def test_two_ranks_nb_match_jax_and_pad_the_validation(runs):
    calls = _check_fit(runs, "a")
    # per epoch 2 full steps and the trailing 5 rows on each rank, and the
    # padded validation block through the weighted loss
    assert calls == [{"plain": 6, "weighted": 2}] * 2


def test_three_ranks_zinb_with_l2_match_jax(runs):
    calls = _check_fit(runs, "b")
    assert calls == [{"plain": 6, "weighted": 2}] * 3


def test_three_ranks_with_an_empty_share_match_jax(runs):
    calls = _check_fit(runs, "c")
    # the trailing 2 rows go to ranks 0 and 1; rank 2 launches nothing for
    # them; 15 validation rows need no padding: no weighted evaluation
    assert calls == [{"plain": 8, "weighted": 0}] * 2 + [{"plain": 6, "weighted": 0}]


def test_three_ranks_draw_the_global_dropout_mask(runs):
    _check_fit(runs, "d")


def test_row_blocks_gather_and_sharded_writes(runs):
    _, results = runs
    assert [r["rows"] for r in results[2]] == [[0, 4], [4, 7]]
    assert [r["rows"] for r in results[3]] == [[0, 3], [3, 6], [6, 7]]


def test_cli_under_torchrun_writes_on_rank_0_alone(tmp_path):
    counts = _counts(61).astype(int)
    tsv = str(tmp_path / "counts.tsv")
    pd.DataFrame(counts.T, index=[f"g{i}" for i in range(16)],
                 columns=[f"c{i}" for i in range(61)]).to_csv(tsv, sep="\t")
    out = str(tmp_path / "out")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "--tee", "3", "-m", "dca_tpu_torch", tsv, out,
           "--devices", "all", "--device", "cpu", "-e", "2", "-s", "8,4,8", "--nocheckcounts"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    # torchrun --tee prefixes each rank's lines with [default<rank>]
    epochs = [ln for ln in lines if "Epoch " in ln]
    assert len(epochs) == 2 and all(ln.startswith("[default0]") for ln in epochs), epochs
    saving = [ln for ln in lines if "Saving" in ln]
    assert saving and all(ln.startswith("[default0]") for ln in saving), saving
    for fname, header, shape in (("mean.tsv", 0, (16, 61)), ("mean_norm.tsv", 0, (16, 61)),
                                 ("dispersion.tsv", None, (16, 61)),
                                 ("latent.tsv", None, (61, 4)), ("reduced.tsv", None, (61, 4))):
        df = pd.read_csv(os.path.join(out, fname), sep="\t", index_col=0, header=header)
        assert df.shape == shape and np.isfinite(df.to_numpy()).all(), fname
    assert sorted(os.listdir(out)) == sorted(["mean.tsv", "mean_norm.tsv", "dispersion.tsv",
                                              "latent.tsv", "reduced.tsv", "model.pickle"])


def _tiny_adata():
    from dca_tpu_torch.data.adata import AnnData

    return AnnData(_counts(40))


def test_model_parallel_is_refused_naming_the_roadmap(tmp_path):
    """A model axis that does not divide the ranks raises, as the JAX
    package's make_mesh asserts: here one rank (no process group) and
    model_parallel 2."""
    from dca_tpu_torch import dca

    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        dca(_tiny_adata(), epochs=1, devices="all", model_parallel=2, device="cpu")


def test_several_devices_without_a_group_are_refused(tmp_path):
    """Refused here before; now two devices without a process group start
    their ranks from this process (``parallel/launch.py``, two gloo ranks
    on the CPU), which alone predicts, and tear their group down after the
    fit (tests/test_torch_launch.py holds them against the JAX mesh)."""
    from dca_tpu_torch import dca

    assert not torch.distributed.is_initialized()
    ret = dca(_tiny_adata(), epochs=1, devices=2, device="cpu", hidden_size=(8, 4, 8),
              copy=True, return_info=True)
    assert not torch.distributed.is_initialized()
    assert len(ret.uns["dca_loss_history"]["loss"]) == 1
    assert ret.X.shape == (40, 16) and np.isfinite(ret.X).all()


def test_nccl_ranks_sharing_a_device_are_refused(monkeypatch):
    from dca_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0"),
                 ("LOCAL_WORLD_SIZE", "2"), ("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="refuses ranks that share a device"):
        multihost.initialize()
    assert not torch.distributed.is_initialized()


def test_process_row_range_blocks():
    from dca_tpu_torch.parallel.multihost import process_row_range

    assert [process_row_range(25, r, 2) for r in range(2)] == [(0, 13), (13, 25)]
    assert [process_row_range(2, r, 3) for r in range(3)] == [(0, 1), (1, 2), (2, 2)]
    assert [process_row_range(274, r, 2) for r in range(2)] == [(0, 137), (137, 274)]
    assert process_row_range(10) == (0, 10)  # no group: every row


if __name__ == "__main__":
    _rank_main(sys.argv[1])
