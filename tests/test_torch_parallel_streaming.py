"""The streaming trainer under a ``torch.distributed`` process group (gloo)
on the CPU, against the JAX package's single-process streaming fit.

The ranks are processes that run this file as a script: they import the
port and torch, never JAX or the JAX package (each reports the modules it
loaded), so every JAX import of this file sits inside the functions that
compute the oracles.  The data and the model are
``tests/test_torch_parallel.py``'s: 61 cells x 16 genes, (8, 4, 8), batch
16, validation_split 0.3, 2 epochs, from the JAX package's initial weights,
bridged, and ``max_device_cells=32``: an epoch stages a part of 2 full
batches, a 10-row trailing part and one 19-row validation chunk.

  (a) nb-conddisp on 2 ranks, the host tier: each rank stages 8 rows of
      each full batch and 5 of the trailing one; the validation chunk is
      padded to 20 rows at weight 0, so it goes through the weighted loss
      (K1w's plain version);
  (b) zinb-conddisp on 3 ranks with ridge 0.01 and l2_coef 0.01, on
      lazily scaled sparse counts through the device densify, whose
      payloads a group forces to ``padded``;
  (c) 49 cells on 3 ranks: a trailing batch of 2 rows, so one rank's
      share is empty, and 15 validation rows, which need no padding;
  (d) zinb-conddisp on 3 ranks with hidden dropout 0.1, against the port's
      own single-process streamed fit (JAX draws other random numbers);
  (e) case (a) with ``checkpoint_every=1``, stopped after epoch 1 and
      resumed: the uninterrupted fit's history and parameters bit for bit;
  (f) case (a) with ``tensorboard=True``: rank 0 alone writes an event
      file, whose last ``grads/`` are the single-process gradient of its
      final parameters on the 19 validation rows, or, without a split, on
      the last train part's 13 rows.

Loss and val_loss must be the same on every rank and within rtol 1e-4 of
the oracle (``test_torch_parallel.py``'s tolerance: the sums over the ranks
run in another order).  Each rank counts the rows it passes to
``StreamingData.materialize``: over the ranks they are the epoch's rows
and the validation padding, no more.  The CLI runs under ``torchrun
--standalone`` on 2 ranks with the size gate set small, against the
single-process streamed CLI run.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from test_torch_parallel import RANK_TIMEOUT, _counts, _free_port, _results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)

FIT = dict(epochs=2, batch_size=16, validation_split=0.3, verbose=False, seed=0,
           reduce_lr=0, early_stop=0, max_device_cells=32)
HOST = {"DCA_TPU_DEVICE_DENSIFY": "0"}
CASES = {  # name: (ae_type, cells, network keywords, ranks, sparse input, switches)
    "a": ("nb-conddisp", 61, {}, 2, False, HOST),
    "b": ("zinb-conddisp", 61, {"ridge": 0.01, "l2_coef": 0.01}, 3, True,
          {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_PAYLOAD": "flat"}),
    "c": ("nb-conddisp", 49, {}, 3, False, HOST),
    "d": ("zinb-conddisp", 61, {"hidden_dropout": 0.1}, 3, False, HOST),
}
SWITCHES = ("DCA_TPU_DEVICE_DENSIFY", "DCA_TPU_PAYLOAD", "DCA_TPU_PREFETCH")
JAX_CASES = ("a", "b", "c")
HIST_STATS = ("min", "max", "num", "sum", "sum_squares")
GRAD_RTOL = 1e-3


def _adata(case):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    _, cells, _, _, sparse, _ = CASES[case]
    X = _counts(cells)
    ad = io.read_dataset(AnnData(sp.csr_matrix(X) if sparse else X), check_counts=False)
    return io.normalize(ad, lazy_scale=sparse)


def _port_net(case, weights=None):
    from dca_tpu_torch.models.network import AE_types

    ae_type, _, kw, _, _, _ = CASES[case]
    net = AE_types[ae_type](input_size=16, hidden_size=(8, 4, 8), seed=4, device="cpu",
                            **kw).build()
    if weights is not None:
        net.model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return net


def _switched(case, extra=None):
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(CASES[case][5])
    os.environ.update(extra or {})


def _port_fit(case, weights=None, devices=None, switches=None, **kw):
    """The port's streamed fit of ``case`` on the CPU; returns (history,
    network)."""
    from dca_tpu_torch.train.loop import train

    _switched(case, switches)
    net = _port_net(case, weights)
    return train(_adata(case), net, devices=devices, **{**FIT, **kw}).history, net


# ---------------------------------------------------------------------------
# the ranks: this file run as a script
# ---------------------------------------------------------------------------


def _rank_main(spec_path):
    """One rank: join the group from RANK/WORLD_SIZE/MASTER_ADDR, fit every
    case of the spec (and on 2 ranks the prefetch, resume, TensorBoard and
    refusal runs), print one RESULT line."""
    torch.set_num_threads(1)
    from dca_tpu_torch.data.loader import StreamingData
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.parallel import multihost
    from dca_tpu_torch.train import loop

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    rank, world = multihost.process_index(), multihost.process_count()

    calls = dict.fromkeys(("plain", "weighted", "weighted_bwd", "rows", "padded", "flat"), 0)
    sums, bwd, materialize = fl._fwd_sums_reference, fl._bwd_reference, StreamingData.materialize

    def spy_fwd(y, mu, theta, pi, ridge, w=None):
        # on the CPU the wrappers run the kernels' plain versions: count them
        calls["plain" if w is None else "weighted"] += 1
        return sums(y, mu, theta, pi, ridge, w)

    def spy_bwd(y, mu, theta, pi, ridge, g, denom, w=None):
        calls["weighted_bwd"] += w is not None
        return bwd(y, mu, theta, pi, ridge, g, denom, w)

    def spy_materialize(self, idx):
        calls["rows"] += len(idx)
        return materialize(self, idx)

    def spy_scatter(name, scatter):
        def spy(*a, **k):
            calls[name] += 1
            return scatter(*a, **k)
        return spy

    fl._fwd_sums_reference, fl._bwd_reference = spy_fwd, spy_bwd
    StreamingData.materialize = spy_materialize
    loop.device_densify = spy_scatter("padded", loop.device_densify)
    loop.device_densify_flat = spy_scatter("flat", loop.device_densify_flat)

    def fit(case, **kw):
        calls.update(dict.fromkeys(calls, 0))
        weights = dict(np.load(spec["weights"][case])) if case in spec["weights"] else None
        hist, net = _port_fit(case, weights, devices="all", **kw)
        return {"loss": hist["loss"], "val_loss": hist.get("val_loss"),
                "calls": dict(calls)}, net

    out = {"rank": rank, "fits": {}}
    nets = {}
    for case in spec["cases"]:
        out["fits"][case], nets[case] = fit(case)
    if world == 2:
        out["fits"]["prefetch0"], _ = fit("a", switches={"DCA_TPU_PREFETCH": "0"})
        # (e): a checkpoint every epoch; 1 epoch, then resumed to 2
        ckdir = os.path.join(spec["dir"], "resume")
        first, _ = fit("a", output_dir=ckdir, checkpoint_every=1, epochs=1)
        second, net = fit("a", output_dir=ckdir, checkpoint_every=1, resume=True)
        want = nets["a"].model.state_dict()
        out["resume"] = {"first": first, "second": second,
                         "same_state": all(torch.equal(v, want[k])
                                           for k, v in net.model.state_dict().items())}
        # (f): TensorBoard on rank 0 alone, with a validation split and
        # without one
        for name, split in (("tb", FIT["validation_split"]), ("tb_nosplit", 0.0)):
            out["fits"][name], net = fit("a", output_dir=os.path.join(spec["dir"], name),
                                         tensorboard=True, validation_split=split)
            if rank == 0:
                np.savez(os.path.join(spec["dir"], f"{name}_state.npz"),
                         **{k: v.numpy() for k, v in net.model.state_dict().items()})
        try:
            fit("a", batch_size=1)
            out["refusal"] = None
        except ValueError as e:
            out["refusal"] = str(e)
    out["foreign"] = sorted(m for m in sys.modules if m in ("jax", "dca_tpu")
                            or m.startswith(("jax.", "dca_tpu.")))
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


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


# ---------------------------------------------------------------------------
# the oracles (JAX imports stay in here)
# ---------------------------------------------------------------------------


def _jax_pair(case):
    """The JAX package's network of ``case`` and its weights, bridged."""
    import jax

    from dca_tpu.models import AE_types

    from dca_tpu_torch.bridge import params_from_jax

    ae_type, _, kw, _, _, _ = CASES[case]
    jnet = AE_types[ae_type](input_size=16, hidden_size=(8, 4, 8), seed=4, **kw).build()
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                         jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, {k: v.numpy() for k, v in sd.items()}


def _jax_fit(case, jnet):
    """The JAX package's single-process streaming fit of ``case``."""
    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.train.loop import train as jtrain

    _, cells, _, _, sparse, _ = CASES[case]
    X = _counts(cells)
    jad = jio.read_dataset(JAnnData(sp.csr_matrix(X) if sparse else X), check_counts=False)
    hist = jtrain(jio.normalize(jad, lazy_scale=sparse), jnet, compiled=False, **FIT).history
    return hist["loss"], hist["val_loss"]


@pytest.fixture(scope="module")
def runs():
    """Both groups of ranks, started before the oracles are computed so
    that they run meanwhile: the oracles, each world's rank results and
    the run's directory."""
    saved = {k: os.environ.get(k) for k in SWITCHES + ("DCA_TPU_FUSED_LOSS",)}
    tmp = tempfile.mkdtemp(prefix="dca_torch_parallel_streaming_")
    try:
        jnets, weights = {}, {}
        for case in JAX_CASES:
            jnets[case], w = _jax_pair(case)
            weights[case] = os.path.join(tmp, f"w_{case}.npz")
            np.savez(weights[case], **w)
        groups = {}
        for world in (2, 3):
            cases = [c for c, spec in CASES.items() if spec[3] == world]
            groups[world] = _start_ranks(world, {"dir": tmp, "cases": cases,
                                                 "weights": weights})
        os.environ["DCA_TPU_FUSED_LOSS"] = "1"  # the JAX side's kernels, in interpret mode
        oracles = {case: _jax_fit(case, jnets[case]) for case in JAX_CASES}
        hist, _ = _port_fit("d")
        oracles["d"] = hist["loss"], hist["val_loss"]
        results = {world: _results(procs) for world, procs in groups.items()}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return oracles, results, tmp


def _ranks(runs, key, world=None):
    world = world or CASES[key][3]
    return [r["fits"][key] for r in runs[1][world]]


def _check_fit(runs, case, fits=None):
    """Every rank's history the same; within rtol 1e-4 of the oracle.
    Returns each rank's calls."""
    (loss, val_loss), fits = runs[0][case], fits or _ranks(runs, case)
    for fit in fits[1:]:
        assert fit["loss"] == fits[0]["loss"] and fit["val_loss"] == fits[0]["val_loss"]
    np.testing.assert_allclose(fits[0]["loss"], loss, rtol=1e-4, err_msg=case)
    np.testing.assert_allclose(fits[0]["val_loss"], val_loss, rtol=1e-4, err_msg=case)
    return [{k: v for k, v in fit["calls"].items() if k in ("plain", "weighted", "weighted_bwd")}
            for fit in fits]


def test_two_ranks_nb_host_tier_match_jax_and_pad_the_validation(runs):
    calls = _check_fit(runs, "a")
    # per epoch 2 full steps and the trailing 5 rows on each rank, and the
    # padded validation block through the weighted loss
    assert calls == [{"plain": 6, "weighted": 2, "weighted_bwd": 0}] * 2


def test_three_ranks_zinb_with_l2_on_padded_payloads_match_jax(runs):
    calls = _check_fit(runs, "b")
    assert calls == [{"plain": 6, "weighted": 2, "weighted_bwd": 0}] * 3
    # DCA_TPU_PAYLOAD=flat asked, and the group staged padded payloads:
    # input and target (one index stream) of 3 parts an epoch
    assert [(f["calls"]["padded"], f["calls"]["flat"]) for f in _ranks(runs, "b")] == [
        (12, 0)] * 3


def test_three_ranks_with_an_empty_share_match_jax(runs):
    calls = _check_fit(runs, "c")
    # the trailing 2 rows go to ranks 0 and 1; rank 2 launches nothing for
    # them; 15 validation rows need no padding: no weighted evaluation
    assert calls == [{"plain": 8, "weighted": 0, "weighted_bwd": 0}] * 2 + [
        {"plain": 6, "weighted": 0, "weighted_bwd": 0}]


def test_three_ranks_draw_the_global_dropout_mask(runs):
    _check_fit(runs, "d")


@pytest.mark.parametrize("case, want", [
    # per epoch: 8 rows of each full batch, 5 of the trailing 10, 10 of the
    # 19 validation rows padded to 20
    ("a", [62, 62]),
    # 6, 6 and 4 rows of each batch; 1, 1 and 0 of the trailing 2; 5 of 15
    ("c", [36, 36, 26]),
])
def test_each_rank_materializes_only_its_rows(runs, case, want):
    _, cells, _, world, _, _ = CASES[case]
    n_val = cells - int(cells * (1.0 - FIT["validation_split"]))
    rows = [fit["calls"]["rows"] for fit in _ranks(runs, case)]
    assert rows == want
    assert sum(rows) == FIT["epochs"] * (cells + (-n_val) % world)


def test_prefetch_off_gives_the_same_bits(runs):
    assert _ranks(runs, "prefetch0", 2) == _ranks(runs, "a")


def test_a_resumed_fit_under_a_group_gives_the_uninterrupted_bits(runs):
    for r, fit in zip(runs[1][2], _ranks(runs, "a")):
        res = r["resume"]
        for key in ("loss", "val_loss"):
            assert res["first"][key] + res["second"][key] == fit[key], (r["rank"], key)
        assert res["same_state"], r["rank"]


@pytest.mark.parametrize("name", ["tb", "tb_nosplit"])
def test_tensorboard_on_rank_0_alone_logs_the_single_process_gradient(runs, name):
    """With a split the gradient is taken on the 19 validation rows (each
    rank's padded block, weighted); without one on the last staged train
    part, the epoch's trailing 13 rows (61 train rows in parts of 32: 32,
    then 16 and the trailing 13), each rank's block of them."""
    from dca_tpu_torch.data.io import size_factors
    from dca_tpu_torch.tbevents import read_histograms
    from dca_tpu_torch.train.loop import _tb_grads

    _, results, tmp = runs
    fits = _ranks(runs, name, 2)
    assert (fits[1]["loss"], fits[1]["val_loss"]) == (fits[0]["loss"], fits[0]["val_loss"])
    if name == "tb":
        # the fit is the plain fit, and each rank takes the weighted
        # backward on its padded validation block once an epoch
        assert fits == [dict(f, calls={**f["calls"], "weighted": 4, "weighted_bwd": 2})
                        for f in _ranks(runs, "a")]
    else:
        # 3 full steps and the trailing one an epoch, and the gradient's
        # forward
        assert fits[0]["calls"]["plain"] == 10 and fits[0]["calls"]["weighted"] == 0
    tb_dir = os.path.join(tmp, name, "tb")
    files = [n for n in os.listdir(tb_dir) if n.startswith("events.out.tfevents.")]
    assert len(files) == 1, files
    hists = read_histograms(os.path.join(tb_dir, files[0]))
    last = FIT["epochs"] - 1
    net = _port_net("a", dict(np.load(os.path.join(tmp, f"{name}_state.npz"))))
    ad = _adata("a")
    if name == "tb":
        rows = np.arange(int(ad.n_obs * (1.0 - FIT["validation_split"])), ad.n_obs)
    else:
        rng = np.random.RandomState(FIT["seed"])
        rows = [rng.permutation(ad.n_obs) for _ in range(FIT["epochs"])][-1][48:]
    x, t, sf = (torch.from_numpy(np.array(a[rows], np.float32))
                for a in (ad.X, ad.raw.X, size_factors(ad)))
    grads = _tb_grads(net, x, sf, t)
    assert {tag for step, tag in hists if step == last and tag.startswith("grads/")} == {
        "grads/" + p for p in grads}
    for path, g in grads.items():
        v = g.detach().numpy().astype(np.float64).ravel()
        want = dict(zip(HIST_STATS, (v.min(), v.max(), v.size, v.sum(), np.square(v).sum())))
        got = hists[(last, "grads/" + path)]
        for k in HIST_STATS:
            # an elementwise rtol carried through the sum bounds its error
            # by rtol * sum |g| <= rtol * sqrt(num * sum g^2)
            scale = (np.sqrt(want["num"] * want["sum_squares"]) if k == "sum"
                     else abs(want[k]))
            assert abs(got[k] - want[k]) <= GRAD_RTOL * scale, (path, k, got[k], want[k])


def test_a_batch_smaller_than_the_ranks_is_refused(runs):
    for r in runs[1][2]:
        assert r["refusal"] is not None and "batch_size >= the number of ranks" in r["refusal"]


def test_the_ranks_load_neither_jax_nor_the_jax_package(runs):
    for world in (2, 3):
        assert [r["foreign"] for r in runs[1][world]] == [[]] * world


def test_stream_places_put_each_rank_on_its_rows():
    """Over the ranks, the blocks that ``part_rows`` stages are the part,
    and ``stream_places`` sends each step's block of rows to their places
    in this rank's buffer: 42 train rows, batch 16, parts of 32 (one of 2
    full batches), a trailing 10 rows; one rank stages every row in order."""
    from dca_tpu_torch.parallel.multihost import process_row_range
    from dca_tpu_torch.parallel.step import part_rows, stream_places

    n_train, bs, chunk = 42, 16, 32
    perm = np.random.RandomState(0).permutation(n_train)
    np.testing.assert_array_equal(stream_places(n_train, bs, chunk), np.arange(n_train) % chunk)
    for world in (1, 2, 3, 5):
        staged = {r: [part_rows(perm[:32], bs, r, world),
                      part_rows(perm[32:], 10, r, world)] for r in range(world)}
        for part, size in ((0, 32), (1, 10)):
            got = np.concatenate([staged[r][part] for r in range(world)])
            assert sorted(got) == sorted(perm[:32] if part == 0 else perm[32:])
            assert sum(len(staged[r][part]) for r in range(world)) == size
        for r in range(world):
            place = stream_places(n_train, bs, chunk, r, world)
            for step, batch in enumerate((slice(0, 16), slice(16, 32), slice(32, 42))):
                rows = perm[batch]
                lo, hi = process_row_range(len(rows), r, world)
                buf = staged[r][0 if step < 2 else 1]
                np.testing.assert_array_equal(buf[place[batch][lo:hi]], rows[lo:hi])


def _cli(out, ranks, tsv):
    # without BatchNorm: the Dense bias before it has a gradient of exactly
    # 0, which RMSprop turns into learning-rate-sized steps of rounding
    # noise, other on one process and on two ranks; the eval-mode BatchNorm
    # carries it into the outputs (3.9e-4 apart here, the in-memory
    # data-parallel run's distance alike)
    cmd = [sys.executable, "-m", "dca_tpu_torch", tsv, out, "--device", "cpu", "-e", "2",
           "-s", "8,4,8", "--nocheckcounts", "--nobatchnorm"]
    if ranks:
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks), "--tee", "3"] + cmd[1:] + ["--devices", "all"])
    env = dict(os.environ, OMP_NUM_THREADS="1", DCA_TPU_DEVICE_BYTES="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if ranks:
        # the streaming writer too, on rank 0 (the same bytes as the
        # in-memory write's)
        env["DCA_TPU_HOST_DENSE_BYTES"] = "1"
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_cli_under_torchrun_streams_and_writes_on_rank_0_alone(tmp_path):
    counts = _counts(61).astype(int)
    tsv = str(tmp_path / "counts.tsv")
    pd.DataFrame(counts.T, index=[f"g{i}" for i in range(16)],
                 columns=[f"c{i}" for i in range(61)]).to_csv(tsv, sep="\t")
    lines = _cli(str(tmp_path / "dp"), 2, tsv)
    # torchrun --tee prefixes each rank's lines with [default<rank>]
    epochs = [ln for ln in lines if "Epoch " in ln]
    assert len(epochs) == 2 and all(ln.startswith("[default0]") and ln.endswith("[streaming]")
                                     for ln in epochs), epochs
    saving = [ln for ln in lines if "Saving" in ln]
    assert saving and all(ln.startswith("[default0]") and ln.endswith("[streaming]")
                          for ln in saving), saving
    single = _cli(str(tmp_path / "one"), 0, tsv)
    assert sum("[streaming]" in ln for ln in single) == 2
    for fname, header in (("mean.tsv", 0), ("mean_norm.tsv", 0), ("dispersion.tsv", None)):
        got, want = (pd.read_csv(tmp_path / d / fname, sep="\t", index_col=0, header=header)
                     for d in ("dp", "one"))
        assert got.shape == want.shape == (16, 61), fname
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-4, err_msg=fname)
    assert sorted(os.listdir(tmp_path / "dp")) == sorted(os.listdir(tmp_path / "one"))


if __name__ == "__main__":
    _rank_main(sys.argv[1])
