"""Every architecture of the PyTorch port against the JAX package, on the
same weights: the JAX package initialises them and
``dca_tpu_torch.bridge.params_from_jax`` carries them across.

Parametrised over the 11 ``AE_types`` and ``zinb-elempi`` with
``sharedpi``: the forward outputs in eval and training mode, the loss and
its gradients with the l1/l2 penalties, and ``predict(return_info=True)``
with each class's info quirk.  On the CPU the port's NB/ZINB losses run the
kernels' plain versions and the JAX package's its ``losses.py``."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import AE_types as JAE_types
from dca_tpu.models import core as jcore

from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models import core
from dca_tpu_torch.models.network import AE_types, get_ae_type

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

HID = (16, 8, 16)
G = 20
ARCHS = sorted(AE_types) + ["zinb-elempi/sharedpi"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **kw):
    """A built JAX network and the port's network on its weights."""
    name, _, variant = arch.partition("/")
    if variant == "sharedpi":
        kw["sharedpi"] = True
    jnet = JAE_types[name](input_size=G, hidden_size=HID, seed=3, ridge=0.1, **kw).build()
    net = get_ae_type(name)(input_size=G, hidden_size=HID, ridge=0.1, device="cpu",
                            **kw).build()
    net.model.load_state_dict(params_from_jax(_np_tree(jnet.params), _np_tree(jnet.state)))
    return jnet, net


def _batch(B=12, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(B, G)).astype(np.float32)
    sf = rs.uniform(0.5, 2.0, size=B).astype(np.float32)
    y = rs.negative_binomial(2, 0.4, size=(B, G)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.3] = 0.0
    return x, sf, y


def test_registry_matches_jax():
    assert sorted(AE_types) == sorted(JAE_types)
    for name, cls in AE_types.items():
        assert cls.ae_type == JAE_types[name].ae_type == name


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jnet, net = _pair(arch)
    x, sf, _ = _batch()
    for training in (False, True):
        jout, jstate = jcore.apply(jnet.definition, jnet.params, jnet.state, x, sf,
                                   training=training)
        out, state = core.apply(net.definition, net.model, torch.from_numpy(x),
                                torch.from_numpy(sf), training=training)
        # f32 matmuls of two libraries, summed in another order
        for key in ("output", "mean", "disp", "pi", "latent", "decoded"):
            if jout[key] is None:
                assert out[key] is None, key
                continue
            np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(jout[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{key} {training}")
        if training:
            for group in ("trunk", "branches"):
                want = {k: v for k, v in jstate[group].items() if v}
                assert jax.tree_util.tree_structure(_np_tree(want)) == \
                    jax.tree_util.tree_structure(jax.tree_util.tree_map(
                        lambda t: t.numpy(), state[group]))
                jax.tree_util.tree_map(
                    lambda a, b: np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                                            atol=1e-6),
                    state[group], _np_tree(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_and_penalties_match_jax(arch):
    coefs = dict(l1_coef=0.01, l2_coef=0.02, l2_enc_coef=0.05)
    jnet, net = _pair(arch, **coefs)
    got = core.regularization_loss(net.definition, net.model).item()
    ref = float(jcore.regularization_loss(jnet.definition, jnet.params))
    assert abs(got - ref) <= 1e-6 * abs(ref)

    x, sf, y = _batch(seed=1)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnet.loss_fn(p, jnet.state, x, sf, y, True, None)[0])(jnet.params)
    loss, _ = net.loss_fn(torch.from_numpy(x), torch.from_numpy(sf), torch.from_numpy(y),
                          True)
    params = dict(net.model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jflat = params_from_jax(_np_tree(jgrads), {})
    assert set(grads) == set(jflat)
    # the kernels' plain versions (log1p, Stirling) against losses.py
    # (log(1 + x), lax.lgamma, power): the fused-vs-reference tolerances of
    # tests/test_pallas.py
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[name].numpy(), rtol=2e-3, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_predict_matches_jax(arch):
    """predict(mode='full', return_info=True): the NB conditional classes
    take the dispersion from the denoised matrix, the ZINB classes
    dispersion and dropout from the input, the constant classes their
    per-gene theta."""
    counts = make_counts(40, G, seed=5)
    jnet, net = _pair(arch)
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    jnet.predict(jad, mode="full", return_info=True)
    net.predict(ad, mode="full", return_info=True)
    np.testing.assert_allclose(ad.X, jad.X, rtol=1e-5, atol=1e-6)
    assert sorted(ad.obsm_keys()) == sorted(jad.obsm_keys())
    for key in ad.obsm_keys():
        # the NB dispersion forward reads the denoised counts, whose scale
        # carries the matmul rounding further
        np.testing.assert_allclose(ad.obsm[key], jad.obsm[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert ("X_dca_dispersion" in ad.var_keys()) == ("X_dca_dispersion" in jad.var_keys())
    if "X_dca_dispersion" in ad.var_keys():
        np.testing.assert_allclose(ad.var["X_dca_dispersion"], jad.var["X_dca_dispersion"],
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ["nb-fork", "zinb-fork", "zinb"])
def test_bridge_and_save_round_trip(arch, tmp_path):
    """save() writes the JAX package's payload layout (four-part keys of
    the fork branches included); the bridge reads it back name by name."""
    jnet, net = _pair(arch)
    net.file_path = str(tmp_path)
    net.save()
    with open(os.path.join(tmp_path, "model.pickle"), "rb") as f:
        payload = pickle.load(f)
    assert payload["ae_type"] == arch
    assert (jax.tree_util.tree_structure(payload["params"])
            == jax.tree_util.tree_structure(_np_tree(jnet.params)))
    jax.tree_util.tree_map(np.testing.assert_array_equal, payload["params"],
                           _np_tree(jnet.params))
    fresh = get_ae_type(arch)(input_size=G, hidden_size=HID, device="cpu").build()
    fresh.model.load_state_dict(params_from_jax(payload["params"], payload["state"]))
    for k, v in net.model.state_dict().items():
        torch.testing.assert_close(fresh.model.state_dict()[k], v, rtol=0, atol=0)
