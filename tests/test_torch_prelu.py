"""PReLU in the port (``ops/activations.prelu``, the ``prelu_alpha`` of
every hidden layer in ``models/core.py``) against the JAX package on the
CPU, on bridged weights with random non-zero alphas: the activation's
values and gradients at 0 and NaN, the forward in eval and training mode,
the loss gradients (the alphas' among them) and ``predict``, for
zinb-conddisp and the fork architectures; K4 switched on leaves the PReLU
layers on the plain path; and a ``train()`` trajectory with PReLU and
Adam."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import AE_types as JAE_types
from dca_tpu.models import core as jcore

from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models import core
from dca_tpu_torch.models.network import get_ae_type
from dca_tpu_torch.ops import fused_dense
from dca_tpu_torch.ops.activations import prelu

from conftest import make_counts
from test_torch_optim import fit_both

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

HID = (16, 8, 16)
G = 20
ARCHS = ["zinb-conddisp", "nb-fork", "zinb-fork"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_random_alphas(params, seed):
    """The params tree with every prelu_alpha drawn from N(0, 0.3)."""
    rs = np.random.RandomState(seed)

    def walk(tree):
        return {k: (jnp.asarray(rs.normal(0.0, 0.3, np.shape(v)).astype(np.float32))
                    if k == "prelu_alpha" else walk(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}

    return walk(params)


def _pair(arch, seed=3, **kw):
    """A built JAX PReLU network with random alphas, and the port's network
    on its weights."""
    jnet = JAE_types[arch](input_size=G, hidden_size=HID, seed=seed, ridge=0.1,
                           activation="PReLU", **kw).build()
    jnet.params = _with_random_alphas(jnet.params, seed)
    net = get_ae_type(arch)(input_size=G, hidden_size=HID, ridge=0.1, activation="PReLU",
                            device="cpu", **kw).build()
    net.model.load_state_dict(params_from_jax(_np_tree(jnet.params), _np_tree(jnet.state)))
    return jnet, net


def _batch(B=12, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(B, G)).astype(np.float32)
    sf = rs.uniform(0.5, 2.0, size=B).astype(np.float32)
    y = rs.negative_binomial(2, 0.4, size=(B, G)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.3] = 0.0
    return x, sf, y


def test_every_hidden_layer_has_an_alpha_initialised_to_zero():
    for arch in ARCHS:
        jnet = JAE_types[arch](input_size=G, hidden_size=HID, activation="PReLU").build()
        net = get_ae_type(arch)(input_size=G, hidden_size=HID, activation="PReLU",
                                device="cpu").build()
        alphas = {k: v for k, v in net.model.named_parameters() if k.endswith("prelu_alpha")}
        want = {k: v for k, v in params_from_jax(_np_tree(jnet.params), {}).items()
                if k.endswith("prelu_alpha")}
        assert sorted(alphas) == sorted(want) and alphas, arch
        n_layers = len(net.definition.shared) + sum(
            len(v) for v in net.definition.branches.values())
        assert len(alphas) == n_layers
        for k, v in alphas.items():
            assert torch.equal(v, torch.zeros_like(v)) and v.shape == want[k].shape, k


def test_prelu_values_and_gradients_at_zero_and_nan():
    """where(x >= 0, x, alpha x): at x = 0 the gradient is 1 for x and 0 for
    alpha, and a NaN x gives a NaN output and a NaN alpha gradient, as in
    JAX."""
    x = np.array([[-2.0, -0.0, 0.0, 1.5, np.nan, -1e-30]], np.float32)
    alpha = np.array([0.25, -0.5, 0.7, 0.1, 0.3, 2.0], np.float32)
    ct = np.array([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]], np.float32)

    def jf(x, a):
        return jnp.sum(jnp.where(x >= 0, x, a * x) * ct)

    jval = np.asarray(jnp.where(x >= 0, x, alpha * x))
    jgx, jga = jax.grad(jf, argnums=(0, 1))(x, alpha)
    tx = torch.tensor(x, requires_grad=True)
    ta = torch.tensor(alpha, requires_grad=True)
    out = prelu(tx, ta)
    gx, ga = torch.autograd.grad((out * torch.tensor(ct)).sum(), (tx, ta))
    np.testing.assert_array_equal(out.detach().numpy(), jval)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(jga))
    assert gx[0, 2] == ct[0, 2] and ga[2] == 0.0
    assert np.isnan(out[0, 4].item()) and np.isnan(ga[4].item())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jnet, net = _pair(arch)
    x, sf, _ = _batch()
    for training in (False, True):
        jout, _ = jcore.apply(jnet.definition, jnet.params, jnet.state, x, sf,
                              training=training)
        out, _ = core.apply(net.definition, net.model, torch.from_numpy(x),
                            torch.from_numpy(sf), training=training)
        for key in ("output", "mean", "disp", "pi", "latent", "decoded"):
            if jout[key] is None:
                assert out[key] is None, key
                continue
            np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{key} {training}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    """The alphas' gradients among the rest; the plain loss against
    losses.py at the fused-vs-reference tolerances of test_pallas.py."""
    jnet, net = _pair(arch, l2_coef=0.02)
    x, sf, y = _batch(seed=1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnet.loss_fn(p, jnet.state, x, sf, y, True, None)[0])(jnet.params)
    loss, _ = net.loss_fn(torch.from_numpy(x), torch.from_numpy(sf), torch.from_numpy(y),
                          True)
    params = dict(net.model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jflat = params_from_jax(_np_tree(jgrads), {})
    assert set(grads) == set(jflat)
    assert any(k.endswith("prelu_alpha") for k in grads)
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[name].numpy(), rtol=2e-3, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_predict_matches_jax(arch):
    counts = make_counts(40, G, seed=5)
    jnet, net = _pair(arch)
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    jnet.predict(jad, mode="full", return_info=True)
    net.predict(ad, mode="full", return_info=True)
    np.testing.assert_allclose(ad.X, jad.X, rtol=1e-5, atol=1e-6)
    assert sorted(ad.obsm_keys()) == sorted(jad.obsm_keys())
    for key in ad.obsm_keys():
        np.testing.assert_allclose(ad.obsm[key], jad.obsm[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_dense_switch_leaves_prelu_layers_plain(monkeypatch, arch):
    """With DCA_TPU_FUSED_DENSE=1 only the dense heads reach K4's wrapper
    (on the CPU its plain version); no hidden layer does, in the full
    forward nor in the decoder, since K4 has no epilogue for a trainable
    alpha.  The outputs are those of the switch off."""
    _, net = _pair(arch)
    x, sf, _ = _batch()
    off = net.forward(x, sf)
    calls = []
    real = core.fused_dense_block

    def spy(x, w, b, bn=None, activation="linear", **kw):
        calls.append((activation, bn is not None))
        return real(x, w, b, bn=bn, activation=activation, **kw)

    monkeypatch.setattr(core, "fused_dense_block", spy)
    monkeypatch.setenv("DCA_TPU_FUSED_DENSE", "1")
    assert not fused_dense.supported_activation("PReLU")
    on = net.forward(x, sf)
    n_heads = sum(h.kind == "dense" for h in net.definition.heads.values())
    assert calls and all(act in ("mean", "disp", "sigmoid") and not bn for act, bn in calls)
    assert len(calls) == n_heads
    for key, v in off.items():
        if v is not None:
            np.testing.assert_allclose(on[key], v, rtol=1e-5, atol=1e-6, err_msg=key)
    calls.clear()
    latent = torch.relu(torch.from_numpy(net.forward(x, sf, keys=("latent",))["latent"]))
    net.get_decoder()(latent.numpy(), sf)
    assert calls and all(act in ("mean", "disp", "sigmoid") and not bn for act, bn in calls)


def test_trajectory_prelu_adam_matches_jax(monkeypatch):
    """train() zinb-conddisp with PReLU and Adam: the alphas train with the
    rest (they leave zero), and the losses follow the JAX package's."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    _, net = fit_both("Adam", activation="PReLU")
    alphas = [p for k, p in net.model.named_parameters() if k.endswith("prelu_alpha")]
    assert alphas and all(bool((a != 0).any()) for a in alphas)
