"""Gene-dim model parallelism of the PyTorch port (``model_parallel``,
``--modelparallel``) over a data x model grid of ``torch.distributed``
ranks (gloo) on the CPU, against the JAX package.

The ranks are processes that run this file as a script: they import the
port and torch, never JAX or the JAX package, so every JAX import of this
file sits inside the functions that compute the oracles.  The data are 64
cells x 16 genes (``_counts``), (8, 4, 8), batch 16, validation_split
0.3, 2 epochs (44 train rows: 2 full batches and a trailing 12; 20
validation rows), from the JAX package's initial weights, bridged.  All
2-rank cases run in one group of ranks (a grid of 1 x 2), all 4-rank
cases in another (2 x 2):

  (a) zinb-conddisp with ridge 0.01 and l2_coef 0.01 at 1 x 2 and 2 x 2:
      loss and val_loss within rtol 1e-4 of the JAX single-device fit, the
      gathered parameters of the 2 x 2 fit within rtol 5e-3, atol 1.5e-3
      of ``dca_tpu``'s ``train(devices=4, model_parallel=2)`` (the bound of
      tests/test_parallel.py's mesh fits);
  (b) one training step's gathered gradients at 2 x 2 against ``jax.grad``
      of ``dca_tpu``'s ``loss_fn`` on the same batch, rtol 1e-4, atol 1e-6;
  (c) nb (constant theta), nb-shared ((H, 1) head whole, the mean head
      sharded), zinb-elempi and zinb-fork, 1 epoch at 1 x 2, against JAX;
  (d) 15 genes, where nothing divides 2 and every tensor stays whole, and
      an ``output_subset`` of 5 of the 16 genes (the input kernel sharded,
      the heads whole), against JAX;
  (e) hidden and input dropout 0.1 at 2 x 2 against the port's own
      single-process fit (JAX draws other numbers);
  (f) ``compiled=True`` at 1 x 2: the Python-epoch loop's history;
  (g) checkpoint and resume at 1 x 2: a fit resumed after epoch 1 gives
      the uninterrupted fit's epoch 2 and parameters, bit for bit; the
      ``weights.hdf5`` of a model-parallel fit loads into a one-process
      network as the gathered parameters' bytes; the ``tensorboard`` fit at
      2 x 2 keeps the plain fit's history and rank 0 writes whole
      histograms;
  (h) the CLI under ``torchrun --standalone --nproc-per-node 2 ...
      --devices all --modelparallel 2``: rank 0 alone prints and writes,
      and mean.tsv is within rtol 1e-4 of the one-process CLI's;
  (i) the streaming trainer under model parallelism trains on a 1 x 2
      grid that ``dca`` starts from this process (its comparison with JAX:
      tests/test_torch_stream_model_parallel.py);
  (j) a rank's many fits in one process group make the grid's data and
      model groups once.

Every rank's history must be the same on every rank of its group.
"""

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pandas as pd
import pytest
import torch

from test_torch_parallel import RANK_TIMEOUT, _free_port, _results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)

FIT = dict(epochs=2, batch_size=16, validation_split=0.3, verbose=False, seed=0,
           reduce_lr=0, early_stop=0)
SUBSET = [1, 4, 6, 9, 13]  # the output_subset's genes
REG = {"ridge": 0.01, "l2_coef": 0.01}
CASES = {  # name: (ae_type, genes, network keywords, ranks, train keywords)
    "a12": ("zinb-conddisp", 16, REG, 2, {}),
    "nb": ("nb", 16, {}, 2, {"epochs": 1}),
    "nb-shared": ("nb-shared", 16, {}, 2, {"epochs": 1}),
    "zinb-elempi": ("zinb-elempi", 16, {}, 2, {"epochs": 1}),
    "zinb-fork": ("zinb-fork", 16, {}, 2, {"epochs": 1}),
    "g15": ("zinb-conddisp", 15, {}, 2, {}),
    "subset": ("zinb-conddisp", 16, {}, 2, {"output_subset": SUBSET}),
    "compiled": ("zinb-conddisp", 16, REG, 2, {"compiled": True}),
    "a22": ("zinb-conddisp", 16, REG, 4, {}),
    "dropout": ("zinb-conddisp", 16, {"hidden_dropout": 0.1, "input_dropout": 0.1}, 4, {}),
}
JAX_CASES = ("a12", "nb", "nb-shared", "zinb-elempi", "zinb-fork", "g15", "subset")


def _counts(n_genes=16):
    """64 cells x ``n_genes`` of Poisson counts, no all-zero row or gene."""
    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(64, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    return counts[:, :n_genes].copy()


def _adata(n_genes):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    return io.normalize(io.read_dataset(AnnData(_counts(n_genes)), check_counts=False))


def _network(case, weights=None, **net_kw):
    from dca_tpu_torch.models.network import AE_types

    ae_type, genes, kw, _, tkw = CASES[case]
    kw = dict(kw, **net_kw)
    out = len(tkw["output_subset"]) if "output_subset" in tkw else genes
    net = AE_types[ae_type](input_size=genes, output_size=out, hidden_size=(8, 4, 8), seed=4,
                            device="cpu", **kw).build()
    if weights is not None:
        net.model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return net


def _fit_kw(case, ad, **extra):
    kw = dict(FIT, **CASES[case][4], **extra)
    if "output_subset" in kw:
        kw["output_subset"] = [ad.var_names[i] for i in kw["output_subset"]]
    return kw


def _port_fit(case, weights=None, net_kw=None, **extra):
    """The port's fit of ``case`` on the CPU: (history, network)."""
    from dca_tpu_torch.train.loop import train

    ad = _adata(CASES[case][1])
    net = _network(case, weights, **(net_kw or {}))
    return train(ad, net, **_fit_kw(case, ad, **extra)).history, net


def _state(net):
    return {k: v.detach().numpy().copy() for k, v in net.model.state_dict().items()}


# ---------------------------------------------------------------------------
# the ranks: this file run as a script
# ---------------------------------------------------------------------------


def _grad_step(spec, weights):
    """One training step of case a22's network on the first 16 rows of its
    train split, at 2 x 2: {path: gathered gradient}."""
    from dca_tpu_torch.data.io import densify, size_factors
    from dca_tpu_torch.parallel.mesh import resolve_mesh
    from dca_tpu_torch.parallel.step import (all_reduce_grads, batch_shard,
                                             place_train_state, sharded_params)

    ad = _adata(16)
    net = _network("a22", weights)
    mesh = resolve_mesh("all", 2)
    place_train_state(net, mesh)
    shard = batch_shard(mesh, 16)
    rows = slice(shard.lo, shard.hi)
    cols = slice(*mesh.gene_block(16))
    x = torch.from_numpy(densify(ad.X)[:16][rows, cols])
    t = torch.from_numpy(densify(ad.raw.X)[:16][rows, cols])
    sf = torch.from_numpy(np.asarray(size_factors(ad), np.float32)[:16][rows])
    loss, _ = net.loss_fn(x, sf, t, True, torch.Generator().manual_seed(0), shard=shard)
    named = list(net.model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    grads = all_reduce_grads(grads, mesh, sharded_params(net))
    whole = net.whole_named({n: g for (n, _), g in zip(named, grads)})
    return {n: g.tolist() for n, g in whole.items()}


def _rank_main(spec_path):
    """One rank: join the group from RANK/WORLD_SIZE/MASTER_ADDR, fit every
    case of the spec through ``train(devices="all", model_parallel=2)``,
    leave rank 0's gathered parameters in the spec's directory, print one
    RESULT line."""
    torch.set_num_threads(1)
    from dca_tpu_torch.parallel import multihost
    from dca_tpu_torch.tbevents import read_histograms

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    rank, world = multihost.process_index(), multihost.process_count()
    d = spec["dir"]
    out = {"rank": rank, "fits": {}}
    made = []  # the groups made after the world's, counted
    new_group = torch.distributed.new_group

    def counted(*args, **kwargs):
        made.append(args)
        return new_group(*args, **kwargs)

    torch.distributed.new_group = counted

    def save(name, net):
        if rank == 0:
            np.savez(os.path.join(d, f"{name}.npz"), **_state(net))

    def fit(case, net_kw=None, **extra):
        weights = dict(np.load(spec["weights"][case])) if case in spec["weights"] else None
        return _port_fit(case, weights, net_kw, devices="all", model_parallel=2, **extra)

    for case in spec["cases"]:
        hist, net = fit(case)
        out["fits"][case] = hist
        save(case, net)
        out.setdefault("groups", [len(made)])
    if world == 2:
        # (g) resume after epoch 1 against the uninterrupted a12 fit, and
        # the weights file of a model-parallel fit
        run = os.path.join(d, "resume")
        fit("a12", epochs=1, output_dir=run, checkpoint_every=1)
        hist, net = fit("a12", output_dir=run, resume=True)
        out["fits"]["resumed"] = hist
        save("resumed", net)
        _, net = fit("a12", epochs=1, output_dir=os.path.join(d, "weights"), save_weights=True)
        save("weights", net)
    else:
        out["grads"] = _grad_step(spec, dict(np.load(spec["weights"]["a22"])))
        tb = os.path.join(d, "tb")
        # debug: the sanitizer's plain losses, and the NB summands logged
        hist, _ = fit("a22", {"debug": True}, output_dir=tb, tensorboard=True)
        out["fits"]["tensorboard"] = hist
        torch.distributed.barrier()
        if rank == 0:
            events = [f for f in os.listdir(os.path.join(tb, "tb"))
                      if f.startswith("events.out.tfevents.")]
            hists = read_histograms(os.path.join(tb, "tb", events[0]))
            out["tb_num"] = {tag: h["num"] for (step, tag), h in hists.items() if step == 1}
    out["groups"].append(len(made))
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

    ae_type, genes, kw, _, tkw = CASES[case]
    out = len(tkw["output_subset"]) if "output_subset" in tkw else genes
    return AE_types[ae_type](input_size=genes, output_size=out, hidden_size=(8, 4, 8), seed=4,
                             **kw).build()


def _bridged(jnet):
    import jax

    from dca_tpu_torch.bridge import params_from_jax

    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                         jax.tree_util.tree_map(np.asarray, jnet.state))
    return {k: v.numpy() for k, v in sd.items()}


def _jax_fit(case, jnet, **extra):
    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.train.loop import train as jtrain

    jad = jio.normalize(jio.read_dataset(JAnnData(_counts(CASES[case][1])),
                                         check_counts=False))
    return jtrain(jad, jnet, compiled=False, **_fit_kw(case, jad, **extra)).history


def _jax_grads(jnet):
    """``jax.grad`` of ``dca_tpu``'s loss_fn on the first 16 rows of the
    train split, in training mode: {dotted path: gradient}."""
    import jax

    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu_torch.bridge import flatten_tree

    jad = jio.normalize(jio.read_dataset(JAnnData(_counts(16)), check_counts=False))
    x = np.asarray(jad.X, np.float32)[:16]
    t = np.asarray(jad.raw.X, np.float32)[:16]
    sf = np.asarray(jad.obs["size_factors"], np.float32)[:16]
    grads = jax.grad(lambda p: jnet.loss_fn(p, jnet.state, x, sf, t, True,
                                            jax.random.PRNGKey(0))[0])(jnet.params)
    return {k: np.asarray(v) for k, v in flatten_tree(grads, ".").items()}


@pytest.fixture(scope="module")
def runs():
    """Both groups of ranks, started before the oracles are computed so
    that they run meanwhile."""
    tmp = tempfile.mkdtemp(prefix="dca_torch_mp_")
    jnets, weights = {}, {}
    for case in JAX_CASES + ("a22", "compiled"):
        jnets[case] = _jax_network(case)
        weights[case] = os.path.join(tmp, f"w_{case}.npz")
        np.savez(weights[case], **_bridged(jnets[case]))
    groups = {}
    for world in (2, 4):
        d = os.path.join(tmp, f"g{world}")
        os.makedirs(d)
        cases = [c for c, spec in CASES.items() if spec[3] == world]
        groups[world] = (d, _start_ranks(world, {"dir": d, "cases": cases,
                                                 "weights": weights}))
    oracles = {case: _jax_fit(case, jnets[case]) for case in JAX_CASES}
    mesh_net = _jax_network("a22")
    _jax_fit("a22", mesh_net, devices=4, model_parallel=2)
    mesh_params = _bridged(mesh_net)
    grads = _jax_grads(_jax_network("a22"))
    own = _port_fit("dropout")[0]
    results = {world: (d, _results(procs)) for world, (d, procs) in groups.items()}
    return dict(oracles=oracles, mesh_params=mesh_params, grads=grads, own=own,
                results=results)


def _ranks(runs, world):
    d, res = runs["results"][world]
    return d, res


def _same_on_every_rank(res, case):
    for r in res[1:]:
        assert r["fits"][case] == res[0]["fits"][case], case
    return res[0]["fits"][case]


def _close(hist, ref, case, keys=("loss", "val_loss")):
    # the sums of the batch statistics, the input layer's products, the
    # losses and the gradients run over the ranks in another order than on
    # one device
    for key in keys:
        np.testing.assert_allclose(hist[key], ref[key], rtol=1e-4, err_msg=f"{case} {key}")


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_zinb_with_l2_matches_jax(runs, world):
    _, res = _ranks(runs, world)
    case = "a12" if world == 2 else "a22"
    _close(_same_on_every_rank(res, case), runs["oracles"]["a12"], case)


def test_gathered_parameters_match_the_jax_mesh_fit(runs):
    d, _ = _ranks(runs, 4)
    got = dict(np.load(os.path.join(d, "a22.npz")))
    want = runs["mesh_params"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3, atol=1.5e-3, err_msg=k)


def test_one_step_gradients_match_jax_grad(runs):
    _, res = _ranks(runs, 4)
    want = runs["grads"]
    for r in res:
        got = {k.replace("/", "."): np.asarray(v, np.float32) for k, v in r["grads"].items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["nb", "nb-shared", "zinb-elempi", "zinb-fork"])
def test_architectures_match_jax(runs, case):
    _, res = _ranks(runs, 2)
    _close(_same_on_every_rank(res, case), runs["oracles"][case], case)


@pytest.mark.parametrize("case", ["g15", "subset"])
def test_genes_that_do_not_divide_stay_whole_and_match_jax(runs, case):
    d, res = _ranks(runs, 2)
    _close(_same_on_every_rank(res, case), runs["oracles"][case], case)
    # the gathered network is the whole one
    got = dict(np.load(os.path.join(d, f"{case}.npz")))
    n_out = 5 if case == "subset" else 15
    assert got["heads.mean.kernel"].shape == (8, n_out)
    assert got["trunk.enc0.kernel"].shape == (CASES[case][1], 8)


def test_layout_follows_the_gene_spec():
    """``gene_dim`` shards exactly the tensors ``_gene_spec`` puts on the
    'model' axis, along the same dimension."""
    import jax

    from dca_tpu.models import AE_types
    from dca_tpu.parallel.mesh import _gene_spec
    from dca_tpu_torch.parallel.mesh import gene_dim

    for ae_type in ("zinb-conddisp", "nb", "nb-shared", "zinb-elempi", "zinb-fork"):
        for genes, out, M in ((16, 16, 2), (15, 15, 2), (16, 5, 2), (16, 16, 4), (12, 12, 4)):
            jnet = AE_types[ae_type](input_size=genes, output_size=out, hidden_size=(8, 4, 8),
                                     seed=4).build()
            for path, leaf in jax.tree_util.tree_flatten_with_path(jnet.params)[0]:
                keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
                spec = tuple(_gene_spec(keys, leaf, jnet.definition, M))
                dim = gene_dim(keys, jnet.definition, M)
                want = None if "model" not in spec else spec.index("model")
                assert dim == want, (ae_type, genes, out, M, keys, spec)


@pytest.mark.parametrize("world", [2, 4])
def test_fits_in_one_process_group_make_the_grid_once(runs, world):
    """A rank's many fits (and the gradient step's mesh) in one process
    group reuse the groups its first fit made: M = 2 data groups and
    D model groups, no more."""
    _, res = _ranks(runs, world)
    for r in res:
        assert r["groups"] == [2 + world // 2] * 2, r["rank"]


def test_dropout_draws_the_global_masks(runs):
    _, res = _ranks(runs, 4)
    _close(_same_on_every_rank(res, "dropout"), runs["own"], "dropout")


def test_compiled_fit_is_the_python_epoch_loop(runs):
    _, res = _ranks(runs, 2)
    got, want = _same_on_every_rank(res, "compiled"), _same_on_every_rank(res, "a12")
    for key in ("loss", "val_loss"):
        # float32 sums on the device against the loop's float64 ones
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


def test_resume_and_weights_file(runs):
    d, res = _ranks(runs, 2)
    whole = _same_on_every_rank(res, "a12")
    resumed = _same_on_every_rank(res, "resumed")
    assert resumed["loss"] == whole["loss"][1:] and resumed["val_loss"] == whole["val_loss"][1:]
    a, b = (dict(np.load(os.path.join(d, f"{n}.npz"))) for n in ("a12", "resumed"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the weights file of the 1-epoch fit: its one (best) epoch's state,
    # whole, into a one-process network
    net = _network("a12")
    net.load_weights(os.path.join(d, "weights", "weights.hdf5"))
    want = dict(np.load(os.path.join(d, "weights.npz")))
    for k, v in _state(net).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_tensorboard_logs_whole_tensors(runs):
    """A debug fit logging to TensorBoard at 2 x 2: the plain fit's
    history (its plain losses against the kernels' plain versions), and
    rank 0's histograms of the whole tensors and of the NB summands of
    all 20 validation rows and 16 genes."""
    _, res = _ranks(runs, 4)
    got, want = _same_on_every_rank(res, "tensorboard"), _same_on_every_rank(res, "a22")
    _close(got, want, "tensorboard")
    num = res[0]["tb_num"]
    assert num["debug/t1"] == num["debug/t2"] == 20 * 16
    # every parameter's histogram, and its gradient's, over the whole tensor
    assert num["weights/heads/mean/kernel"] == num["grads/heads/mean/kernel"] == 8 * 16
    assert num["weights/trunk/enc0/kernel"] == num["grads/trunk/enc0/kernel"] == 16 * 8
    assert num["grads/heads/dispersion/bias"] == 16


def _cli(out, tsv, ranks):
    # without BatchNorm: the Dense bias before it has a gradient of exactly
    # 0, which RMSprop turns into learning-rate-sized steps of rounding
    # noise, other on one process and on two ranks (tests/
    # test_torch_parallel_streaming.py's CLI comparison)
    cmd = [sys.executable, "-m", "dca_tpu_torch", tsv, out, "--device", "cpu", "-e", "2",
           "-s", "8,4,8", "--nocheckcounts", "--nobatchnorm", "--type", "zinb-conddisp"]
    if ranks:
        cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(ranks), "--tee", "3"] + cmd[1:]
               + ["--devices", "all", "--modelparallel", str(ranks)])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=RANK_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_cli_under_torchrun_writes_on_rank_0_alone(tmp_path):
    counts = _counts().astype(int)
    tsv = str(tmp_path / "counts.tsv")
    pd.DataFrame(counts.T, index=[f"g{i}" for i in range(16)],
                 columns=[f"c{i}" for i in range(64)]).to_csv(tsv, sep="\t")
    lines = _cli(str(tmp_path / "mp"), tsv, 2)
    # torchrun --tee prefixes each rank's lines with [default<rank>]
    epochs = [ln for ln in lines if "Epoch " in ln]
    assert len(epochs) == 2 and all(ln.startswith("[default0]") for ln in epochs), epochs
    saving = [ln for ln in lines if "Saving" in ln]
    assert saving and all(ln.startswith("[default0]") for ln in saving), saving
    _cli(str(tmp_path / "one"), tsv, 0)
    for fname, header in (("mean.tsv", 0), ("dispersion.tsv", None), ("dropout.tsv", None)):
        got, want = (pd.read_csv(tmp_path / d / fname, sep="\t", index_col=0, header=header)
                     for d in ("mp", "one"))
        assert got.shape == want.shape == (16, 64), fname
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-4, err_msg=fname)
    assert sorted(os.listdir(tmp_path / "mp")) == sorted(os.listdir(tmp_path / "one"))


def test_streaming_under_model_parallelism_is_refused_naming_the_roadmap(capsys):
    """Refused here before; now the streamed fit (parts of at most 8 cells)
    runs on a 1 x 2 grid, here of two ranks that ``dca`` starts from this
    process, and leaves the whole network (its comparison with the JAX
    package: tests/test_torch_stream_model_parallel.py)."""
    from dca_tpu_torch import dca
    from dca_tpu_torch.data.adata import AnnData

    ret, net = dca(AnnData(_counts()), epochs=2, devices=2, model_parallel=2, device="cpu",
                   hidden_size=(8, 4, 8), verbose=True, copy=True, return_info=True,
                   return_model=True, training_kwds={"max_device_cells": 8})
    assert capsys.readouterr().out.count("[streaming]") == 2
    hist = ret.uns["dca_loss_history"]
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"] + hist["val_loss"]).all()
    assert net.model.state_dict()["trunk.enc0.kernel"].shape == (16, 8)
    assert net.mesh is None and not torch.distributed.is_initialized()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
