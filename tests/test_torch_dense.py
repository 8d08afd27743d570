"""The fused dense block K4 and the eval forward built on it, against the JAX
package on the CPU.

On the CPU the port's ``fused_dense_block`` runs its plain version,
``fused_dense_reference``; the JAX package's runs its Pallas kernel in
interpret mode, as ``tests/test_pallas.py`` runs it.  The same inputs, made
with numpy, go to both; the tolerances are ``test_pallas.py``'s for the
same cases (float32 sums in another order).  The model tests bridge the JAX
package's weights into the port (``bridge.params_from_jax``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dca_tpu.models import AE_types as JAE_types
from dca_tpu.models import core as jcore
from dca_tpu.ops import fused_dense as jfd

from dca_tpu_torch import config
from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.models import core
from dca_tpu_torch.models.network import get_ae_type
from dca_tpu_torch.ops import fused_dense as fd

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

ACTS = ["mean", "disp", "sigmoid", "relu", "selu", "elu", "tanh", "linear"]


def _dense_inputs(B, K, N, seed=0):
    """The inputs of test_pallas.py's fused dense tests."""
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(B, K)).astype(np.float32)
    w = (rs.normal(size=(K, N)) * 0.1).astype(np.float32)
    b = rs.normal(size=(N,)).astype(np.float32) * 0.1
    mm = rs.normal(size=(N,)).astype(np.float32) * 0.1
    mv = rs.uniform(0.5, 2.0, size=(N,)).astype(np.float32)
    beta = rs.normal(size=(N,)).astype(np.float32) * 0.1
    sf = rs.uniform(0.5, 2.0, size=(B,)).astype(np.float32)
    return x, w, b, (mm, mv, beta), sf


def _both(x, w, b, bn=None, activation="linear", sf=None, **jax_kw):
    """(port, JAX) outputs of the fused block on the same inputs."""
    t = torch.from_numpy
    got = fd.fused_dense_block(t(x), t(w), t(b), bn=None if bn is None else tuple(map(t, bn)),
                               activation=activation,
                               size_factors=None if sf is None else t(sf))
    want = jfd.fused_dense_block(x, w, b, bn=bn, activation=activation, size_factors=sf,
                                 interpret=True, **jax_kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("shape", [(16, 64, 128), (33, 200, 70), (8, 513, 300)])
def test_trunk_block_matches_jax(shape):
    """Dense -> inference BN -> relu."""
    x, w, b, bn, _ = _dense_inputs(*shape)
    got, want = _both(x, w, b, bn, "relu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_long_k_matches_jax_multi_k_blocks():
    """K = 1500 over the JAX kernel's accumulating K loop (block_k=256)."""
    x, w, b, bn, _ = _dense_inputs(16, 1500, 96, seed=4)
    got, want = _both(x, w, b, bn, "relu", block_k=256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_mean_head_with_size_factors_matches_jax():
    x, w, b, _, sf = _dense_inputs(24, 64, 250, seed=2)
    got, want = _both(x, w, b, None, "mean", sf)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ACTS)
def test_every_epilogue_matches_jax(activation):
    """Each of the 8 epilogues, with BN and size factors."""
    x, w, b, bn, sf = _dense_inputs(17, 32, 130, seed=3)
    got, want = _both(x, w, b, bn, activation, sf)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=activation)


def test_disp_epilogue_does_not_overflow():
    """softplus as max(z, 0) + log1p(exp(-|z|)): finite and clipped at 1e4
    where exp(z) overflows float32 (z > 88)."""
    x = np.full((2, 1), 100.0, np.float32)
    w = np.ones((1, 3), np.float32)
    b = np.asarray([0.0, -200.0, -100.0], np.float32)
    got, want = _both(x, w, b, None, "disp")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.float32([100.0, 1e-4, np.log(2.0)]))


def test_nan_in_x_stays_nan():
    """A NaN in a row of x makes that row NaN under every epilogue, on both
    sides (the kernel's clips keep NaN, as jnp.clip does), and leaves the
    other rows as they were."""
    x, w, b, bn, sf = _dense_inputs(9, 20, 12, seed=6)
    x[4, 3] = np.nan
    for act in ACTS:
        got, want = _both(x, w, b, bn, act, sf)
        assert np.isnan(got[4]).all() and np.isnan(want[4]).all(), act
        rest = np.arange(9) != 4
        assert np.isfinite(got[rest]).all(), act
        np.testing.assert_allclose(got[rest], want[rest], rtol=1e-5, atol=1e-6, err_msg=act)


def test_bf16_mode_matches_jax_bf16_mode(monkeypatch):
    """DCA_TPU_MATMUL=bf16 on both sides: x and W rounded to bfloat16, the
    products (exact in float32) summed in float32."""
    x, w, b, bn, sf = _dense_inputs(16, 64, 128, seed=5)
    monkeypatch.setenv("DCA_TPU_MATMUL", "bf16")
    got, want = _both(x, w, b, bn, "relu", sf)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("DCA_TPU_MATMUL", "f32")
    f32, _ = _both(x, w, b, bn, "relu", sf)
    assert not np.array_equal(got, f32)


def test_reference_folds_bn_as_the_layer_does():
    """The folded BN z * s + t of the plain version against the model's
    own eval layer (z - mean) * rsqrt(var + eps) + beta."""
    x, w, b, (mm, mv, beta), _ = _dense_inputs(10, 30, 20, seed=7)
    t = torch.from_numpy
    got = fd.fused_dense_reference(t(x), t(w), t(b), bn=(t(mm), t(mv), t(beta)),
                                   activation="linear")
    want = (t(x) @ t(w) + t(b) - t(mm)) * torch.rsqrt(t(mv) + fd.BN_EPS) + t(beta)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x, w, b, bn, _ = (torch.from_numpy(a) if not isinstance(a, tuple) else a
                      for a in _dense_inputs(4, 6, 5))
    with pytest.raises(ValueError, match="not fusable"):
        fd.fused_dense_block(x, w, b, activation="softplus")
    with pytest.raises(TypeError):
        fd.fused_dense_block(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        fd.fused_dense_block(x, w.t().contiguous().t(), b)
    with pytest.raises(ValueError):
        fd.fused_dense_block(x, w, b[:3])
    assert fd.supported_activation("selu") and not fd.supported_activation("PReLU")


def test_switches_read_the_jax_package_names(monkeypatch):
    monkeypatch.delenv("DCA_TPU_FUSED_DENSE", raising=False)
    monkeypatch.delenv("DCA_TPU_MATMUL", raising=False)
    assert not config.use_fused_dense() and config.matmul_dtype() is None
    monkeypatch.setenv("DCA_TPU_FUSED_DENSE", "1")
    monkeypatch.setenv("DCA_TPU_MATMUL", "bf16")
    assert config.use_fused_dense() and config.matmul_dtype() is torch.bfloat16
    monkeypatch.setenv("DCA_TPU_FUSED_DENSE", "auto")
    assert not config.use_fused_dense(30000)  # off at every width
    monkeypatch.setenv("DCA_TPU_MATMUL", "fp32")
    with pytest.raises(ValueError, match="DCA_TPU_MATMUL"):
        config.matmul_dtype()


# ---------------------------------------------------------------------------
# the model's eval forward through K4, on bridged weights
# ---------------------------------------------------------------------------

G = 90


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, **kw):
    jnet = JAE_types[arch](input_size=G, hidden_size=(16, 8, 16), seed=1, **kw).build()
    net = get_ae_type(arch)(input_size=G, hidden_size=(16, 8, 16), device="cpu", **kw).build()
    net.model.load_state_dict(params_from_jax(_np_tree(jnet.params), _np_tree(jnet.state)))
    return jnet, net


def _batch(B=11, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(B, G)).astype(np.float32),
            rs.uniform(0.5, 2.0, size=(B,)).astype(np.float32))


@pytest.mark.parametrize("arch", ["zinb-conddisp", "nb", "zinb-fork", "nb-fork", "zinb-elempi"])
def test_fused_forward_matches_jax_fused_forward(arch, monkeypatch):
    """DCA_TPU_FUSED_DENSE=1 on both sides: the trunk layers before center,
    the fork branches and the dense heads through the fused block."""
    monkeypatch.setenv("DCA_TPU_FUSED_DENSE", "1")
    jnet, net = _pair(arch)
    x, sf = _batch()
    want, _ = jcore.apply(jnet.definition, jnet.params, jnet.state, x, sf, training=False)
    with torch.no_grad():
        got, _ = core.apply(net.definition, net.model, torch.from_numpy(x),
                            torch.from_numpy(sf), training=False)
    for k in ("output", "mean", "disp", "pi", "latent", "decoded"):
        if want[k] is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_fused_forward_runs_the_fused_block_where_jax_does(monkeypatch):
    """The layers that go through the fused block: with keys, only the
    heads those outputs need (the JAX package's per-keys predict, after
    XLA drops the unused heads).  zinb-conddisp, full predict with info:
    encoder, mean, dispersion, pi; nb-conddisp denoise: encoder, mean; its
    dispersion after the denoise: encoder, dispersion."""
    monkeypatch.setenv("DCA_TPU_FUSED_DENSE", "1")
    calls = []

    def spy(x, kernel, bias, **kw):
        calls.append((tuple(kernel.shape), kw.get("activation")))
        return fd.fused_dense_block(x, kernel, bias, **kw)

    monkeypatch.setattr(core, "fused_dense_block", spy)
    x, sf = (torch.from_numpy(a) for a in _batch())
    for arch, keys, want in (
        ("zinb-conddisp", ("output", "mean_norm", "latent", "disp", "pi"),
         [((G, 16), "relu"), ((16, G), "mean"), ((16, G), "sigmoid"), ((16, G), "disp")]),
        ("nb-conddisp", ("output", "mean_norm"), [((G, 16), "relu"), ((16, G), "mean")]),
        ("nb-conddisp", ("disp",), [((G, 16), "relu"), ((16, G), "disp")]),
    ):
        net = get_ae_type(arch)(input_size=G, hidden_size=(16, 8, 16), device="cpu").build()
        calls.clear()
        out, _ = core.apply(net.definition, net.model, x, sf, keys=keys)
        assert sorted(out) == sorted(keys)
        assert sorted(calls) == sorted(want), (arch, keys, calls)
        full, _ = core.apply(net.definition, net.model, x, sf)
        for k in keys:
            torch.testing.assert_close(out[k], full[k], rtol=0, atol=0)
    # training never fuses
    calls.clear()
    core.apply(net.definition, net.model, x, sf, training=True,
               generator=torch.Generator().manual_seed(0))
    assert calls == []


@pytest.mark.parametrize("fused", ["0", "1"])
def test_get_decoder_matches_full_forward_and_jax(fused, monkeypatch):
    """decode(center activations) equals the full forward's output, and the
    JAX package's get_decoder on the same weights."""
    monkeypatch.setenv("DCA_TPU_FUSED_DENSE", fused)
    jnet, net = _pair("zinb-conddisp")
    x, sf = _batch(seed=2)
    out = net.forward(x, sf)
    center = [layer for layer in net.definition.shared
              if layer.name in ("enc0", "center")]
    with torch.no_grad():
        latent_act, _ = core._apply_stack(center, net.model.trunk, torch.from_numpy(x), "relu",
                                          False, None, {})
    dec = net.get_decoder()(latent_act.numpy(), sf)
    np.testing.assert_allclose(dec, out["output"], rtol=1e-5, atol=1e-6)
    jdec = jnet.get_decoder()(latent_act.numpy(), sf)
    np.testing.assert_allclose(dec, jdec, rtol=1e-5, atol=1e-5)
    enc = net.get_encoder()(x, sf)
    np.testing.assert_allclose(enc, out["latent"], rtol=0, atol=0)


def test_bf16_training_step_matches_jax(monkeypatch):
    """One training step's loss and gradients under DCA_TPU_MATMUL=bf16 on
    both sides.  Both round the products' inputs to bfloat16 in the forward
    and take the gradient through the rounding, so the kernels' gradients
    come out of a bfloat16 cotangent on both sides.  Tolerances: the loss
    at rtol 1e-5 (float32 sums in another order); the gradients at rtol
    1e-3, a quarter of a bfloat16 step, should the two frameworks' sums
    before that rounding land on two sides of a rounding boundary, and
    atol 1e-6 for the biases of the layers before a BatchNorm, whose
    gradient is float32 rounding noise (~1e-9: the BN removes the bias)."""
    monkeypatch.setenv("DCA_TPU_MATMUL", "bf16")
    jnet, net = _pair("zinb-conddisp", ridge=0.05)
    x, sf = _batch(seed=3)
    rs = np.random.RandomState(4)
    y = rs.negative_binomial(2, 0.4, size=x.shape).astype(np.float32)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jnet.loss_fn(p, jnet.state, x, sf, y, True, None)[0])(jnet.params)
    loss, _ = net.loss_fn(torch.from_numpy(x), torch.from_numpy(sf), torch.from_numpy(y), True)
    params = dict(net.model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jflat = params_from_jax(_np_tree(jgrads), {})
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[name].numpy(), rtol=1e-3, atol=1e-6,
                                   err_msg=name)
    monkeypatch.setenv("DCA_TPU_MATMUL", "f32")
    f32_loss, _ = net.loss_fn(torch.from_numpy(x), torch.from_numpy(sf), torch.from_numpy(y),
                              True)
    assert f32_loss.item() != loss.item()  # the rounding took effect


def test_dot_rounds_inputs_like_jax(monkeypatch):
    monkeypatch.setenv("DCA_TPU_MATMUL", "bf16")
    rs = np.random.RandomState(8)
    x = rs.normal(size=(5, 40)).astype(np.float32)
    w = rs.normal(size=(40, 7)).astype(np.float32)
    got = core._dot(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jcore._dot(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
