"""The training step that reads its batch, step index and learning rate
from device buffers (``parallel/step.py::StepBuffers``), as the CUDA-graph
epoch captures it, run eagerly on the CPU: against the JAX package's loop
(a ReduceLROnPlateau cut mid-fit, a split with no training step and one
with no trailing step), and against the loop it replaced, which sliced
the permutation on the host and wrote each step's loss by setitem.  The
graph replay itself needs a card (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch

import jax

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import NBAutoencoder as JNBAutoencoder
from dca_tpu.models import ZINBAutoencoder as JZINBAutoencoder
from dca_tpu.train.loop import train as jtrain

from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models.network import NBAutoencoder, ZINBAutoencoder
from dca_tpu_torch.parallel.step import StepBuffers, make_sharded_train_step
from dca_tpu_torch.train import optim
from dca_tpu_torch.train.graphs import EagerEpoch
from dca_tpu_torch.train.loop import train

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

FAMILIES = {"nb": (JNBAutoencoder, NBAutoencoder, {}),
            "zinb": (JZINBAutoencoder, ZINBAutoencoder, {"ridge": 0.05})}


def _bridged(family, n_cells, n_genes=50):
    """Both packages' networks at (16, 8, 16) from the same weights, and
    both packages' preprocessed data."""
    jcls, cls, kw = FAMILIES[family]
    counts = make_counts(n_cells, n_genes)
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    jnet = jcls(input_size=n_genes, hidden_size=(16, 8, 16), hidden_dropout=0.0, seed=7,
                **kw).build()
    net = cls(input_size=n_genes, hidden_size=(16, 8, 16), hidden_dropout=0.0, device="cpu",
              **kw).build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    return jad, jnet, ad, net


def _fit_both(family, n_cells, **kw):
    jad, jnet, ad, net = _bridged(family, n_cells)
    jhist = jtrain(jad, jnet, verbose=False, seed=11, compiled=False, **kw)
    hist = train(ad, net, verbose=False, seed=11, **kw)
    # loss and val_loss: float rounding in another order, grown through
    # the RMSprop steps (the trajectory tests of test_torch_train.py)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist.history[key], jhist.history[key], rtol=1e-4,
                                   err_msg=key)
    assert hist.history["lr"] == jhist.history["lr"]
    assert hist.capture_s is None  # the CPU fit replays no graph
    assert len(hist.epoch_s) == len(hist.history["loss"])
    return hist


@pytest.mark.parametrize("family", ["nb", "zinb"])
def test_step_matches_jax_with_a_plateau_cut_mid_fit(monkeypatch, family):
    """reduce_lr=1 at a learning rate small enough that val_loss improves
    by less than min_delta (1e-4) within 4 epochs: ReduceLROnPlateau
    rewrites the device learning rate mid-fit, and both packages' histories
    of it must be equal.  (How exactly the step reads the rewritten rate:
    ``test_step_counter_and_loss_buffer_match_the_setitem_loop``.)"""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    hist = _fit_both(family, 200, epochs=4, reduce_lr=1, early_stop=0, learning_rate=1e-5)
    lrs = hist.history["lr"]
    assert lrs[:2] == [1e-5, 1e-5] and lrs[-1] < 1e-5, lrs


@pytest.mark.parametrize("family", ["nb", "zinb"])
@pytest.mark.parametrize("n_cells,validation_split,n_full,rem", [
    (200, 0.2, 5, 0),    # 160 training rows: five full steps, no trailing step
    (200, 0.999, 0, 0),  # no training row: no step at all, validation only
    (200, 0.1, 5, 20),   # the common case, 5 full steps and 20 trailing rows
])
def test_step_matches_jax_at_the_edges_of_the_split(monkeypatch, family, n_cells,
                                                   validation_split, n_full, rem):
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    n_train = int(n_cells * (1.0 - validation_split))
    assert divmod(n_train, 32) == (n_full, rem) or (n_train, n_full) == (0, 0)
    _fit_both(family, n_cells, epochs=3, validation_split=validation_split)


def _old_epoch(net, opt, opt_state, X, T, SF, perm, bs, lr, generator):
    """The loop the buffers replaced: the batch sliced from the permutation
    on the host, the learning rate a Python float, each full step's loss
    written by setitem, the trailing step's returned."""
    params = list(net.model.parameters())
    n_full = len(perm) // bs

    def step(idx):
        loss, new_state = net.loss_fn(X[idx], SF[idx], T[idx], True, generator)
        grads = torch.autograd.grad(loss, params)
        opt.update(grads, opt_state, params, lr)
        net.model.load_bn_state(new_state)
        return loss.detach()

    full_losses = torch.zeros(n_full)
    for i in range(n_full):
        full_losses[i] = step(perm[i * bs:(i + 1) * bs])
    rem_loss = step(perm[n_full * bs:])
    return full_losses, rem_loss


@pytest.mark.parametrize("family", ["nb", "zinb"])
def test_step_counter_and_loss_buffer_match_the_setitem_loop(family):
    """Two epochs through the buffers and through the old loop, from the
    same weights, the learning rate cut between them (rewritten in place in
    the buffer, a new float for the old loop): the same bits, loss by loss
    and parameter by parameter; after each epoch the step counter stands
    at n_full."""
    _, _, ad, net = _bridged(family, 200)
    _, _, _, net_old = _bridged(family, 200)
    X = torch.from_numpy(np.asarray(ad.X, np.float32))
    T = torch.from_numpy(np.asarray(ad.raw.X, np.float32))
    SF = torch.from_numpy(np.array(ad.obs.size_factors, np.float32))
    n_train, bs = X.shape[0], 32
    n_full, rem = divmod(n_train, bs)
    assert n_full > 0 and rem > 0
    opt = optim.get_optimizer("RMSprop", clipvalue=5.0)
    state = opt.init(list(net.model.parameters()))
    old_state = opt.init(list(net_old.model.parameters()))
    bufs = StepBuffers.create(n_train, bs, 1e-3, "cpu")
    train_step = make_sharded_train_step(net, opt)
    gen, old_gen = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    run = EagerEpoch(lambda trailing=False: train_step(X, T, SF, bufs, state, gen, trailing),
                     bufs, rem)
    rs = np.random.RandomState(3)
    for lr in (1e-3, 1e-4):
        perm = rs.permutation(n_train)
        bufs.lr.fill_(lr)
        run(perm)
        full_losses, rem_loss = _old_epoch(net_old, opt, old_state, X, T, SF,
                                           torch.from_numpy(perm), bs, lr, old_gen)
        assert bufs.step_i.tolist() == [n_full]
        assert torch.equal(bufs.losses[:n_full], full_losses)
        assert torch.equal(bufs.losses[n_full], rem_loss)
        for (name, got), want in zip(net.model.state_dict().items(),
                                     net_old.model.state_dict().values()):
            assert torch.equal(got, want), name
        for got, want in zip(state["a"], old_state["a"]):
            assert torch.equal(got, want)


def test_only_a_trailing_step():
    """A batch longer than the split (which ``train`` never forms: it cuts
    the batch to the split) leaves no full step and one trailing step of
    all the rows: the step counter stays at 0, the full steps' part of the
    buffer is empty, and the trailing step's loss is the old loop's."""
    _, _, ad, net = _bridged("nb", 40)
    _, _, _, net_old = _bridged("nb", 40)
    X = torch.from_numpy(np.asarray(ad.X, np.float32))
    T = torch.from_numpy(np.asarray(ad.raw.X, np.float32))
    SF = torch.from_numpy(np.array(ad.obs.size_factors, np.float32))
    perm = np.random.RandomState(4).permutation(X.shape[0])
    opt = optim.get_optimizer("RMSprop", clipvalue=5.0)
    state = opt.init(list(net.model.parameters()))
    bufs = StepBuffers.create(X.shape[0], 64, 1e-3, "cpu")
    assert bufs.n_full == 0
    train_step = make_sharded_train_step(net, opt)
    EagerEpoch(lambda trailing=False: train_step(X, T, SF, bufs, state, None, trailing),
               bufs, X.shape[0])(perm)
    old_state = opt.init(list(net_old.model.parameters()))
    _, rem_loss = _old_epoch(net_old, opt, old_state, X, T, SF, torch.from_numpy(perm), 64,
                             1e-3, None)
    assert bufs.step_i.tolist() == [0]
    assert torch.equal(bufs.losses[0], rem_loss)


@pytest.mark.parametrize("lr", [1e-3, 1e-4, 0.03])
def test_rmsprop_device_learning_rate_same_bits_as_a_float(lr):
    """The trainer's 0-d float32 learning rate gives the bits of the Python
    float it holds (both multiply the gradient in float32)."""
    rs = np.random.RandomState(5)
    shapes = [(7, 5), (5,)]
    opt = optim.get_optimizer("RMSprop", clipvalue=5.0)
    params = [torch.tensor(rs.normal(size=s).astype(np.float32)) for s in shapes]
    twin = [p.clone() for p in params]
    state, twin_state = opt.init(params), opt.init(twin)
    for _ in range(3):
        grads = [torch.tensor((rs.normal(size=s) * 4.0).astype(np.float32)) for s in shapes]
        opt.update(grads, state, params, torch.tensor(lr, dtype=torch.float32))
        opt.update(grads, twin_state, twin, lr)
    for p, q in zip(params, twin):
        assert torch.equal(p, q)
