"""The streaming trainer of the PyTorch port under gene-dim model
parallelism (``train(devices=..., model_parallel=2, max_device_cells=32)``)
over a data x model grid of ``torch.distributed`` ranks (gloo) on the CPU,
against the JAX package's streamed fit on the same mesh.

The ranks are processes that run this file as a script: they import the
port and torch, never JAX or the JAX package, so every JAX import of this
file sits inside the functions that compute the oracles.  The data are
``tests/test_torch_model_parallel.py``'s 64 cells x 16 genes, as sparse
counts whose z-scale is deferred (``normalize(lazy_scale=True)``), (8, 4,
8) zinb-conddisp with ridge 0.01 and l2_coef 0.01, batch 16,
validation_split 0.3, 2 epochs, from the JAX package's initial weights,
bridged.  ``max_device_cells=32``: an epoch stages a part of 2 full
batches, a 12-row trailing part and one 20-row validation chunk.  The
2-rank cases run in one group of ranks (a grid of 1 x 2), the 4-rank cases
in another (2 x 2):

  (a) the host tier (DCA_TPU_DEVICE_DENSIFY=0) and the padded-payload tier
      (=1) at 1 x 2 and 2 x 2: loss and val_loss within rtol 1e-4 of
      ``dca_tpu``'s ``train(devices=2 / 4, model_parallel=2,
      max_device_cells=32)`` and of the port's own one-process streamed
      fit; the two tiers the same bits; each rank's K1 calls (the plain
      versions on the CPU) once a step and once a validation chunk;
  (b) the first 61 cells at 2 x 2: 19 validation rows padded to 20 at
      weight 0, evaluated through the weighted loss (K1w's plain version);
  (c) an ``output_subset`` of 5 genes at 1 x 2 (the input kernel sharded,
      the heads whole) and 15 genes (nothing shards), against JAX;
  (d) a streamed checkpoint at 1 x 2, resumed after epoch 1: the
      uninterrupted fit's epoch 2 and parameters, bit for bit;
  (e) ``tensorboard=True`` at 2 x 2: the plain fit's history, and rank 0's
      histograms of the whole tensors.

Every rank's history must be the same on every rank of its group.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from test_torch_parallel import _free_port, _results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)

FIT = dict(epochs=2, batch_size=16, validation_split=0.3, verbose=False, seed=0,
           reduce_lr=0, early_stop=0, max_device_cells=32)
REG = {"ridge": 0.01, "l2_coef": 0.01}
SUBSET = [1, 4, 6, 9, 13]
HOST, PADDED = {"DCA_TPU_DEVICE_DENSIFY": "0"}, {"DCA_TPU_DEVICE_DENSIFY": "1"}
SWITCHES = ("DCA_TPU_DEVICE_DENSIFY", "DCA_TPU_PAYLOAD")
# name: (oracle, genes, cells, ranks, switches, train keywords)
CASES = {
    "h12": ("12", 16, 64, 2, HOST, {}),
    "p12": ("12", 16, 64, 2, PADDED, {}),
    "subset": ("subset", 16, 64, 2, HOST, {"output_subset": SUBSET}),
    "g15": ("g15", 15, 64, 2, HOST, {}),
    "h22": ("22", 16, 64, 4, HOST, {}),
    "p22": ("22", 16, 64, 4, PADDED, {}),
    "r61": ("r61", 16, 61, 4, HOST, {}),
}


def _counts(n_genes=16, n_cells=64):
    """64 cells x 16 genes of Poisson counts (``test_torch_model_parallel``'s),
    cut to ``n_cells`` x ``n_genes``; no all-zero row or gene."""
    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(64, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    return counts[:n_cells, :n_genes].copy()


def _adata(case):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    _, genes, cells, _, _, _ = CASES[case]
    ad = io.read_dataset(AnnData(sp.csr_matrix(_counts(genes, cells))), check_counts=False)
    return io.normalize(ad, lazy_scale=True)


def _out(case):
    return len(SUBSET) if "output_subset" in CASES[case][5] else CASES[case][1]


def _fit_kw(case, ad, **extra):
    kw = dict(FIT, **CASES[case][5], **extra)
    if "output_subset" in kw:
        kw["output_subset"] = [ad.var_names[i] for i in kw["output_subset"]]
    return kw


def _switched(case):
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(CASES[case][4])


def _port_fit(case, weights, **extra):
    """The port's streamed fit of ``case`` on the CPU: (history, network)."""
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.train.loop import train

    _switched(case)
    net = AE_types["zinb-conddisp"](input_size=CASES[case][1], output_size=_out(case),
                                    hidden_size=(8, 4, 8), seed=4, device="cpu", **REG).build()
    net.model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    ad = _adata(case)
    return train(ad, net, **_fit_kw(case, ad, **extra)).history, net


def _state(net):
    return {k: v.detach().numpy().copy() for k, v in net.model.state_dict().items()}


# ---------------------------------------------------------------------------
# the ranks: this file run as a script
# ---------------------------------------------------------------------------


def _rank_main(spec_path):
    """One rank: join the group from RANK/WORLD_SIZE/MASTER_ADDR, fit every
    case of the spec through ``train(devices="all", model_parallel=2)``,
    counting the loss kernels' plain versions, then the resume (1 x 2) or
    TensorBoard (2 x 2) run; leave rank 0's gathered parameters in the
    spec's directory and print one RESULT line."""
    torch.set_num_threads(1)
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.parallel import multihost
    from dca_tpu_torch.tbevents import read_histograms

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    rank, world = multihost.process_index(), multihost.process_count()
    d = spec["dir"]
    calls = {"plain": 0, "weighted": 0}
    sums = fl._fwd_sums_reference

    def spy(y, mu, theta, pi, ridge, w=None):
        # on the CPU the wrappers run the kernels' plain versions: count them
        calls["plain" if w is None else "weighted"] += 1
        return sums(y, mu, theta, pi, ridge, w)

    fl._fwd_sums_reference = spy

    def fit(case, **extra):
        calls.update(plain=0, weighted=0)
        weights = dict(np.load(spec["weights"][CASES[case][0]]))
        hist, net = _port_fit(case, weights, devices="all", model_parallel=2, **extra)
        return {"loss": hist["loss"], "val_loss": hist["val_loss"], "calls": dict(calls)}, net

    def save(name, net):
        if rank == 0:
            np.savez(os.path.join(d, f"{name}.npz"), **_state(net))

    out = {"rank": rank, "fits": {}}
    for case in spec["cases"]:
        out["fits"][case], net = fit(case)
        save(case, net)
    if world == 2:
        run = os.path.join(d, "resume")
        fit("h12", epochs=1, output_dir=run, checkpoint_every=1)
        out["fits"]["resumed"], net = fit("h12", output_dir=run, checkpoint_every=1,
                                          resume=True)
        save("resumed", net)
    else:
        tb = os.path.join(d, "tb")
        out["fits"]["tensorboard"], _ = fit("h22", output_dir=tb, tensorboard=True)
        torch.distributed.barrier()
        if rank == 0:
            events = [f for f in os.listdir(os.path.join(tb, "tb"))
                      if f.startswith("events.out.tfevents.")]
            hists = read_histograms(os.path.join(tb, "tb", events[0]))
            out["tb_num"] = {tag: h["num"] for (step, tag), h in hists.items() if step == 1}
    out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "dca_tpu")
                            or m.startswith(("jax.", "dca_tpu.")))
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


def _start_ranks(world, spec):
    """Start ``world`` ranks of this file on ``spec``, found by each other
    as torchrun's ranks are, from RANK, WORLD_SIZE and MASTER_ADDR/PORT."""
    path = os.path.join(spec["dir"], "spec.json")
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


# ---------------------------------------------------------------------------
# the oracles (JAX imports stay in here)
# ---------------------------------------------------------------------------


def _jax_network(case):
    from dca_tpu.models import AE_types

    return AE_types["zinb-conddisp"](input_size=CASES[case][1], output_size=_out(case),
                                     hidden_size=(8, 4, 8), seed=4, **REG).build()


def _bridged(jnet):
    import jax

    from dca_tpu_torch.bridge import params_from_jax

    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                         jax.tree_util.tree_map(np.asarray, jnet.state))
    return {k: v.numpy() for k, v in sd.items()}


def _jax_fit(case):
    """``dca_tpu``'s streamed fit of ``case`` on its mesh of the same grid."""
    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.train.loop import train as jtrain

    _, genes, cells, world, _, _ = CASES[case]
    jad = jio.normalize(jio.read_dataset(JAnnData(sp.csr_matrix(_counts(genes, cells))),
                                         check_counts=False), lazy_scale=True)
    hist = jtrain(jad, _jax_network(case), compiled=False, devices=world, model_parallel=2,
                  **_fit_kw(case, jad)).history
    return {k: hist[k] for k in ("loss", "val_loss")}


@pytest.fixture(scope="module")
def runs():
    """Both groups of ranks, started before the oracles are computed so
    that they run meanwhile."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    tmp = tempfile.mkdtemp(prefix="dca_torch_stream_mp_")
    oracle_case = {CASES[c][0]: c for c in CASES}
    try:
        weights = {}
        for key, case in oracle_case.items():
            weights[key] = os.path.join(tmp, f"w_{key}.npz")
            np.savez(weights[key], **_bridged(_jax_network(case)))
        groups = {}
        for world in (2, 4):
            d = os.path.join(tmp, f"g{world}")
            os.makedirs(d)
            cases = [c for c, spec in CASES.items() if spec[3] == world]
            groups[world] = (d, _start_ranks(world, {"dir": d, "cases": cases,
                                                     "weights": weights}))
        oracles = {key: _jax_fit(case) for key, case in oracle_case.items()}
        own, _ = _port_fit("h12", dict(np.load(weights["12"])))
        results = {world: (d, _results(procs)) for world, (d, procs) in groups.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(oracles=oracles, own=own, results=results)


def _same_on_every_rank(runs, case, world=None):
    _, res = runs["results"][world or CASES[case][3]]
    for r in res[1:]:
        got, want = r["fits"][case], res[0]["fits"][case]
        assert (got["loss"], got["val_loss"]) == (want["loss"], want["val_loss"]), case
    return [r["fits"][case] for r in res]


def _close(fit, ref, case):
    # the sums of the batch statistics, the input layer's products, the
    # losses and the gradients run over the ranks in another order than on
    # one device
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(fit[key], ref[key], rtol=1e-4, err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", ["h12", "p12", "h22", "p22"])
def test_streamed_grid_matches_jax_and_the_one_process_fit(runs, case):
    fits = _same_on_every_rank(runs, case)
    _close(fits[0], runs["oracles"][CASES[case][0]], case)
    _close(fits[0], runs["own"], case)
    # 3 steps and 1 unpadded validation chunk an epoch on every rank: the
    # trailing 12 rows split 6 / 6 over 2 data indices
    assert [f["calls"] for f in fits] == [{"plain": 8, "weighted": 0}] * len(fits)


@pytest.mark.parametrize("grid", ["12", "22"])
def test_the_host_and_padded_tiers_give_the_same_bits(runs, grid):
    host = _same_on_every_rank(runs, "h" + grid)[0]
    padded = _same_on_every_rank(runs, "p" + grid)[0]
    assert (host["loss"], host["val_loss"]) == (padded["loss"], padded["val_loss"])


def test_a_padded_validation_chunk_goes_through_the_weighted_loss(runs):
    fits = _same_on_every_rank(runs, "r61")
    _close(fits[0], runs["oracles"]["r61"], "r61")
    # 19 validation rows padded to 20 over the 2 data indices: K1w once an
    # epoch on every rank, beside the 3 steps' K1
    assert [f["calls"] for f in fits] == [{"plain": 6, "weighted": 2}] * 4


@pytest.mark.parametrize("case", ["subset", "g15"])
def test_genes_that_do_not_divide_stay_whole_and_match_jax(runs, case):
    fits = _same_on_every_rank(runs, case)
    _close(fits[0], runs["oracles"][case], case)
    d, _ = runs["results"][2]
    got = dict(np.load(os.path.join(d, f"{case}.npz")))
    assert got["heads.mean.kernel"].shape == (8, _out(case))
    assert got["trunk.enc0.kernel"].shape == (CASES[case][1], 8)


def test_a_resumed_streamed_fit_gives_the_uninterrupted_bits(runs):
    whole = _same_on_every_rank(runs, "h12")[0]
    resumed = _same_on_every_rank(runs, "resumed", 2)[0]
    assert resumed["loss"] == whole["loss"][1:] and resumed["val_loss"] == whole["val_loss"][1:]
    d, _ = runs["results"][2]
    a, b = (dict(np.load(os.path.join(d, f"{n}.npz"))) for n in ("h12", "resumed"))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_tensorboard_rank_0_writes_whole_histograms(runs):
    got = _same_on_every_rank(runs, "tensorboard", 4)[0]
    want = _same_on_every_rank(runs, "h22")[0]
    assert (got["loss"], got["val_loss"]) == (want["loss"], want["val_loss"])
    _, res = runs["results"][4]
    num = res[0]["tb_num"]
    assert num["weights/heads/mean/kernel"] == num["grads/heads/mean/kernel"] == 8 * 16
    assert num["weights/trunk/enc0/kernel"] == num["grads/trunk/enc0/kernel"] == 16 * 8
    assert num["grads/heads/dispersion/bias"] == 16


def test_the_ranks_load_neither_jax_nor_the_jax_package(runs):
    for world in (2, 4):
        for r in runs["results"][world][1]:
            assert r["foreign"] == [], r["foreign"]


if __name__ == "__main__":
    _rank_main(sys.argv[1])
