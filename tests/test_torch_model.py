"""The PyTorch port's model, optimizer and predict against the JAX package,
on the same weights: the JAX package initialises them and
``dca_tpu_torch.bridge.params_from_jax`` carries them across."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dca_tpu.models import NBAutoencoder as JNBAutoencoder
from dca_tpu.models import core as jcore
from dca_tpu.train import optim as joptim

from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.data import io
from dca_tpu_torch.models import core
from dca_tpu_torch.models.network import NBAutoencoder, get_ae_type
from dca_tpu_torch.ops import initializers
from dca_tpu_torch.train import optim

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

HID = (16, 8, 16)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(n_genes=20, hidden=HID, seed=3):
    """A built JAX network and the port's network on its weights."""
    jnet = JNBAutoencoder(input_size=n_genes, hidden_size=hidden, seed=seed).build()
    net = NBAutoencoder(input_size=n_genes, hidden_size=hidden, device="cpu").build()
    net.model.load_state_dict(params_from_jax(_np_tree(jnet.params), _np_tree(jnet.state)))
    return jnet, net


def _batch(B=12, G=20, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(B, G)).astype(np.float32)
    sf = rs.uniform(0.5, 2.0, size=B).astype(np.float32)
    y = rs.negative_binomial(2, 0.4, size=(B, G)).astype(np.float32)
    return x, sf, y


def test_definition_and_module_layout_match_jax():
    jnet, net = _pair()
    # two dataclasses of the same fields: compare their values
    assert (dataclasses.asdict(core.build_definition("nb-conddisp", 20, hidden_size=HID))
            == dataclasses.asdict(jnet.definition))
    names = {k: tuple(v.shape) for k, v in net.model.state_dict().items()}
    flat = {}
    for tree in (jnet.params, jnet.state):
        for group in ("trunk", "heads"):
            for layer, leaves in tree.get(group, {}).items():
                for key, leaf in leaves.items():
                    flat[f"{group}.{layer}.{key}"] = tuple(leaf.shape)
    assert names == flat


@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_jax(training):
    jnet, net = _pair()
    x, sf, _ = _batch()
    jout, jstate = jcore.apply(jnet.definition, jnet.params, jnet.state, x, sf,
                               training=training)
    out, state = core.apply(net.definition, net.model, torch.from_numpy(x),
                            torch.from_numpy(sf), training=training)
    # f32 matmuls of two libraries, summed in another order
    for key in ("output", "mean", "disp", "latent", "decoded"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert out["pi"] is None and jout["pi"] is None
    for layer, s in jstate["trunk"].items():
        for key in ("moving_mean", "moving_var"):
            np.testing.assert_allclose(state["trunk"][layer][key].numpy(),
                                       np.asarray(s[key]), rtol=1e-5, atol=1e-6)


def test_batchnorm_moving_update_uses_biased_variance():
    _, net = _pair()
    x, sf, _ = _batch(B=5)
    _, state = core.apply(net.definition, net.model, torch.from_numpy(x),
                          torch.from_numpy(sf), training=True)
    d = net.model.trunk["enc0"]
    h = torch.from_numpy(x) @ d.kernel.detach() + d.bias.detach()
    want = 0.99 * 1.0 + 0.01 * h.var(dim=0, unbiased=False)
    torch.testing.assert_close(state["trunk"]["enc0"]["moving_var"], want)


def test_loss_gradients_match_jax_grad():
    jnet, net = _pair()
    x, sf, y = _batch(seed=1)
    jgrads = jax.grad(
        lambda p: jnet.loss_fn(p, jnet.state, x, sf, y, True, None)[0])(jnet.params)
    loss, _ = net.loss_fn(torch.from_numpy(x), torch.from_numpy(sf),
                          torch.from_numpy(y), True)
    params = dict(net.model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jflat = {}
    for group in ("trunk", "heads"):
        for layer, leaves in jgrads[group].items():
            for key, g in leaves.items():
                jflat[f"{group}.{layer}.{key}"] = np.asarray(g)
    assert set(grads) == set(jflat)
    # on the CPU the JAX loss is losses.nb_nll (log(1 + x), lax.lgamma) and
    # the port's is the kernels' plain version (log1p, Stirling): the
    # fused-vs-reference gradient tolerance of tests/test_pallas.py
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[name], rtol=2e-3, atol=1e-5,
                                   err_msg=name)


def test_regularization_matches_jax():
    jnet = JNBAutoencoder(input_size=20, hidden_size=HID, l1_coef=0.01, l2_coef=0.02,
                          l2_enc_coef=0.05).build()
    net = NBAutoencoder(input_size=20, hidden_size=HID, l1_coef=0.01, l2_coef=0.02,
                        l2_enc_coef=0.05, device="cpu").build()
    net.model.load_state_dict(params_from_jax(_np_tree(jnet.params), _np_tree(jnet.state)))
    got = core.regularization_loss(net.definition, net.model).item()
    ref = float(jcore.regularization_loss(jnet.definition, jnet.params))
    assert abs(got - ref) <= 1e-6 * abs(ref)


@pytest.mark.parametrize("steps", [1, 10])
def test_rmsprop_matches_jax(steps):
    rs = np.random.RandomState(steps)
    shapes = [(7, 5), (5,), (3, 2)]
    params = [rs.normal(size=s).astype(np.float32) for s in shapes]
    jopt = joptim.rmsprop(clipvalue=5.0)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    opt = optim.get_optimizer("RMSprop", clipvalue=5.0)
    tparams = [torch.tensor(p) for p in params]
    tstate = opt.init(tparams)
    for i in range(steps):
        grads = [(rs.normal(size=s) * 4.0).astype(np.float32) for s in shapes]
        lr = 1e-3 * (0.1 if i >= 5 else 1.0)  # lr as a runtime value
        jparams, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate,
                                      jparams, jnp.float32(lr))
        opt.update([torch.tensor(g) for g in grads], tstate, tparams, lr)
    # the same float32 operations in the same order, a few ulp apart at most
    for t, j in zip(tparams, jparams):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    for t, j in zip(tstate["a"], jstate["a"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-9)


def test_adam_and_prelu_are_not_ported_yet():
    with pytest.raises(ValueError, match="ROADMAP.md"):
        optim.get_optimizer("Adam")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_ae_type("zinb-conddisp")(input_size=20, hidden_size=HID, activation="PReLU",
                                     device="cpu").build()


def test_predict_matches_jax():
    """Predict in full mode with the info quirk of nb-conddisp (dispersion
    from the denoised matrix), on the same weights, against the JAX
    package's predict."""
    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData

    counts = make_counts(40, 20, seed=5)
    jnet, net = _pair()
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    np.testing.assert_array_equal(ad.X, jad.X)
    jnet.predict(jad, mode="full", return_info=True)
    net.predict(ad, mode="full", return_info=True)
    np.testing.assert_allclose(ad.X, jad.X, rtol=1e-5, atol=1e-6)
    for key in ("X_dca", "X_dca_mean_norm", "X_dca_dispersion"):
        # the dispersion forward reads the denoised counts, whose scale
        # carries the matmul rounding further
        np.testing.assert_allclose(ad.obsm[key], jad.obsm[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(initializers.INITIALIZERS))
def test_initializer_statistics_match_jax(name):
    """JAX's random stream cannot be matched: compare the distributions."""
    from dca_tpu.ops import initializers as jinit

    shape = (300, 200)
    got = initializers.get_initializer(name)(
        torch.Generator().manual_seed(0), shape).numpy()
    ref = np.asarray(jinit.get_initializer(name)(jax.random.PRNGKey(0), shape))
    assert got.shape == ref.shape and got.dtype == np.float32
    # 60,000 draws: mean and std agree to well inside 5% of the std
    assert abs(got.mean() - ref.mean()) <= 0.05 * ref.std() + 1e-12
    np.testing.assert_allclose(got.std(), ref.std(), rtol=0.05, atol=1e-12)
    # the spread's tail: the 99th percentile of |w| (a maximum is too noisy
    # for the untruncated normal)
    np.testing.assert_allclose(np.quantile(np.abs(got), 0.99),
                               np.quantile(np.abs(ref), 0.99), rtol=0.05)


def test_dropout_keeps_expectation():
    x = torch.ones(400, 300)
    y = core._dropout(x, 0.25, torch.Generator().manual_seed(1))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1.0 / 0.75))
