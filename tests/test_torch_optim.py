"""The port's seven Keras optimizers (``dca_tpu_torch/train/optim.py``)
against the JAX package's (``dca_tpu/train/optim.py``) on the CPU: one
update and ten, with and without clipping, the learning rate a float and a
0-d tensor; the in-place form a captured CUDA graph needs (every tensor
keeps its address, the step count a tensor); the list of state tensors the
graph warm-up restores; and a ``train()`` trajectory of each against the
JAX package's loop on the same weights and row order.  RMSprop's one-launch
kernel on the card (``ops/fused_optim.py``): its launch plan, and the CPU
keeping the plain loop."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import ZINBAutoencoder as JZINBAutoencoder
from dca_tpu.train import optim as joptim
from dca_tpu.train.loop import train as jtrain

from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models.network import ZINBAutoencoder, get_ae_type
from dca_tpu_torch.ops import fused_optim
from dca_tpu_torch.parallel.step import StepBuffers, make_sharded_train_step
from dca_tpu_torch.train import optim
from dca_tpu_torch.train.graphs import EagerEpoch
from dca_tpu_torch.train.loop import train

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

NAMES = ["SGD", "RMSprop", "Adam", "Adamax", "Nadam", "Adagrad", "Adadelta"]
SHAPES = [(7, 5), (5,), (3, 2), (1, 4)]


def _updates(name, steps, clipvalue, lr_tensor, seed):
    """Both packages' parameters and states after ``steps`` updates from
    the same parameters and gradients (some beyond the clip value), the
    learning rate cut after the fifth."""
    rs = np.random.RandomState(seed)
    params = [rs.normal(size=s).astype(np.float32) for s in SHAPES]
    jopt = joptim.get_optimizer(name, clipvalue=clipvalue)
    opt = optim.get_optimizer(name, clipvalue=clipvalue)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    tparams = [torch.tensor(p) for p in params]
    tstate = opt.init(tparams)
    for i in range(steps):
        grads = [(rs.normal(size=s) * 4.0).astype(np.float32) for s in SHAPES]
        lr = opt.default_lr * (0.1 if i >= 5 else 1.0)
        jparams, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jparams,
                                      jnp.float32(lr) if lr_tensor else lr)
        opt.update([torch.tensor(g) for g in grads], tstate, tparams,
                    torch.tensor(lr, dtype=torch.float32) if lr_tensor else lr)
    return tparams, tstate, jparams, jstate


@pytest.mark.parametrize("lr_tensor", [False, True], ids=["lr_float", "lr_tensor"])
@pytest.mark.parametrize("clipvalue", [5.0, None], ids=["clip5", "noclip"])
@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("name", NAMES)
def test_update_matches_jax(name, steps, clipvalue, lr_tensor):
    """The same float32 operations in the same order: rtol 1e-5 after one
    update, 1e-4 after ten (the bias corrections' float32 ``pow`` may round
    in the last bit on the two sides, and the differences grow through the
    steps); atol 1e-7 for the entries that pass near 0."""
    tparams, tstate, jparams, jstate = _updates(name, steps, clipvalue, lr_tensor,
                                                seed=steps + 7 * NAMES.index(name))
    rtol = 1e-5 if steps == 1 else 1e-4
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=1e-7)
    assert sorted(tstate) == sorted(jstate)
    for key, value in jstate.items():
        if key == "t":
            assert tstate["t"].dtype == torch.int32 and tstate["t"].shape == ()
            assert int(tstate["t"]) == int(value) == steps
            continue
        for t, j in zip(tstate[key], value):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=1e-9,
                                       err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_update_keeps_every_address(name):
    """Graph-safe: an update writes each parameter and each state tensor in
    place, the step count included, so a captured step replays on them."""
    opt = optim.get_optimizer(name, clipvalue=5.0)
    params = [torch.randn(s) for s in SHAPES]
    state = opt.init(params)
    before = [t.data_ptr() for t in params + optim.state_tensors(state)]
    values = [t.clone() for t in params]
    for _ in range(3):
        opt.update([torch.randn(s) for s in SHAPES], state, params, torch.tensor(1e-3))
    assert [t.data_ptr() for t in params + optim.state_tensors(state)] == before
    assert all(not torch.equal(p, v) for p, v in zip(params, values))


def _all_tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [t for item in items for t in _all_tensors(item)]


@pytest.mark.parametrize("name", NAMES)
def test_state_tensors_lists_every_tensor(name):
    """The restore list covers the whole state: every per-parameter tensor,
    and the step count of Adam, Adamax and Nadam; SGD's empty state gives
    none."""
    params = [torch.randn(s) for s in SHAPES]
    state = optim.get_optimizer(name).init(params)
    listed = optim.state_tensors(state)
    assert {id(t) for t in listed} == {id(t) for t in _all_tensors(state)}
    assert len(listed) == len(_all_tensors(state))
    has_t = name in ("Adam", "Adamax", "Nadam")
    assert any(t is state.get("t") for t in listed) == has_t
    per_param = {"SGD": 0, "RMSprop": 1, "Adagrad": 1, "Adadelta": 2}.get(name, 2)
    assert len(listed) == per_param * len(SHAPES) + has_t


def test_get_optimizer_resolves_every_name_case_insensitively():
    for name in NAMES:
        for spelled in (name, name.lower(), name.upper()):
            opt = optim.get_optimizer(spelled, clipvalue=5.0)
            assert (opt.name, opt.default_lr) == (
                joptim.get_optimizer(spelled).name, joptim.get_optimizer(spelled).default_lr)


def _bridged(activation="relu", n_cells=200, n_genes=50):
    counts = make_counts(n_cells, n_genes)
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    kw = dict(input_size=n_genes, hidden_size=(16, 8, 16), hidden_dropout=0.0, ridge=0.05,
              activation=activation)
    jnet = JZINBAutoencoder(seed=7, **kw).build()
    net = ZINBAutoencoder(device="cpu", **kw).build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    return jad, jnet, ad, net


def fit_both(optimizer, activation="relu", epochs=3, **kw):
    """zinb-conddisp (16, 8, 16) from the same weights on the same data:
    dropout 0 and one seed give both packages the same row order, so the
    per-epoch losses must agree up to float rounding in another order,
    grown through the steps: rtol 1e-4.  The JAX side runs its fused
    kernels in interpret mode (DCA_TPU_FUSED_LOSS=1 in the caller), the
    log1p/Stirling math of the port's plain version."""
    jad, jnet, ad, net = _bridged(activation)
    jhist = jtrain(jad, jnet, optimizer=optimizer, epochs=epochs, verbose=False, seed=11,
                   compiled=False, **kw)
    hist = train(ad, net, optimizer=optimizer, epochs=epochs, verbose=False, seed=11, **kw)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist.history[key], jhist.history[key], rtol=1e-4,
                                   err_msg=key)
    assert hist.history["lr"] == jhist.history["lr"]
    return hist, net


@pytest.mark.parametrize("name", NAMES)
def test_trajectory_matches_jax(monkeypatch, name):
    """train() with each optimizer at its default learning rate."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    fit_both(name)


def test_warm_up_restore_leaves_adam_where_it_started():
    """What the CUDA-graph warm-up does (``train/graphs.py``), on the CPU:
    two real steps, then every listed tensor copied back.  Adam's step
    count is among them, so the fit that follows has the bits of a fit
    that never took those steps; without the count restored its bias
    corrections would run two steps ahead."""
    _, _, ad, net = _bridged()
    _, _, _, twin = _bridged()
    X = torch.from_numpy(np.asarray(ad.X, np.float32))
    T = torch.from_numpy(np.asarray(ad.raw.X, np.float32))
    SF = torch.from_numpy(np.array(ad.obs.size_factors, np.float32))
    opt = optim.get_optimizer("Adam", clipvalue=5.0)
    perm = np.random.RandomState(3).permutation(X.shape[0])
    runs = []
    for model, warm_up in ((net, True), (twin, False)):
        params = list(model.model.parameters())
        state = opt.init(params)
        bufs = StepBuffers.create(X.shape[0], 32, 1e-3, "cpu")
        train_step = make_sharded_train_step(model, opt)
        run = EagerEpoch(lambda trailing=False: train_step(X, T, SF, bufs, state, None,
                                                           trailing), bufs, X.shape[0] % 32)
        written = (params + list(model.model.buffers()) + optim.state_tensors(state)
                   + [bufs.step_i, bufs.losses])
        if warm_up:
            saved = [t.detach().clone() for t in written]
            run.start(perm)
            run.step()
            run.step(trailing=True)
            assert int(state["t"]) == 2
            with torch.no_grad():
                for t, s in zip(written, saved):
                    t.copy_(s)
        assert int(state["t"]) == 0
        run(perm)
        runs.append((bufs.losses.clone(), [t.clone() for t in written]))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def _leaves(ae_type, genes=3451):
    net = get_ae_type(ae_type)(input_size=genes, hidden_size=(64, 32, 64),
                               device="cpu").build()
    return [p.numel() for p in net.model.parameters()]


def _flat_views(sizes):
    """Whether each of ``sizes`` starts 16-byte aligned as a view into one
    float32 buffer at the running offset, as the gradients of a flat
    all-reduce do."""
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return [int(o) % 4 == 0 for o in offsets]


NB_LEAVES = _leaves("nb-conddisp")
ZINB_LEAVES = _leaves("zinb-conddisp")
ODD_LEAVES = [1, 3, 3451, 1725, 862, 2048, 2049, 0, 4]
PLANS = {
    "nb-conddisp": (NB_LEAVES, [True] * 13),
    "zinb-conddisp": (ZINB_LEAVES, [True] * 15),
    "nb-conddisp-flat": (NB_LEAVES, _flat_views(NB_LEAVES)),
    "odd": (ODD_LEAVES, _flat_views(ODD_LEAVES)),
    "130-leaves": ([(i % 7) * 1000 + 1 for i in range(130)], [i % 3 > 0 for i in range(130)]),
}


def test_the_configs_leaves_are_what_the_benchmark_counts():
    """13 leaves (nb-conddisp) and 15 (zinb-conddisp) at 3451 genes, of
    673,910 and 898,225 elements: ``portbench/metrics/optim_roofline.py``
    counts the same from the widths."""
    assert (len(NB_LEAVES), sum(NB_LEAVES)) == (13, 673_910)
    assert (len(ZINB_LEAVES), sum(ZINB_LEAVES)) == (15, 898_225)


@pytest.mark.parametrize("case", list(PLANS))
def test_rmsprop_launch_plan(case):
    """Each non-empty leaf in exactly one launch, in order, at most 64 a
    launch; its blocks ceil(n / CHUNK), numbered on from the launch's
    previous leaf's; 16-byte loads where its tensors are aligned."""
    sizes, aligned = PLANS[case]
    launches = fused_optim.plan(sizes, aligned)
    assert [i for ln in launches for i in ln.leaves] == [i for i, n in enumerate(sizes) if n]
    assert all(0 < len(ln.leaves) <= fused_optim.MAX_LEAVES for ln in launches)
    n_launches = -(-sum(1 for n in sizes if n) // fused_optim.MAX_LEAVES)
    assert len(launches) == n_launches
    for ln in launches:
        assert ln.first_block[0] == 0
        assert list(np.diff(ln.first_block)) == [-(-sizes[i] // fused_optim.CHUNK)
                                                for i in ln.leaves]
        assert ln.vector == tuple(aligned[i] for i in ln.leaves)
    blocks = [ln.first_block[-1] for ln in launches]
    want = {"nb-conddisp": [336], "zinb-conddisp": [446], "nb-conddisp-flat": [336],
            "odd": [10], "130-leaves": [118, 118, 3]}[case]
    assert blocks == want
    if case == "nb-conddisp-flat":
        assert not all(ln.vector[i] for ln in launches for i in range(len(ln.leaves)))


def test_rmsprop_on_the_cpu_takes_the_plain_loop():
    """Parameters on the CPU: RMSprop's update is the plain loop's bits,
    and the kernel's launch count stays 0."""
    rs = np.random.RandomState(5)
    params = [torch.tensor(rs.normal(size=s).astype(np.float32)) for s in SHAPES]
    twins = [p.clone() for p in params]
    opt = optim.get_optimizer("RMSprop", clipvalue=5.0)
    state, twin_state = opt.init(params), opt.init(twins)
    fused_optim.reset_launches()
    lr = torch.tensor(1e-3)
    for _ in range(3):
        grads = [torch.tensor((rs.normal(size=s) * 4).astype(np.float32)) for s in SHAPES]
        opt.update(grads, state, params, lr)
        with torch.no_grad():
            optim._rmsprop_loop(twins, grads, twin_state["a"], lr, 5.0, 0.9, 1e-7)
    assert fused_optim.launches == {"rmsprop": 0}
    for a, b in zip(params + state["a"], twins + twin_state["a"]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        fused_optim.rmsprop(params, grads, state["a"], lr, 5.0)
