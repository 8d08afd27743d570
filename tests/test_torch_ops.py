"""The PyTorch port's special functions, losses and fused NB loss against
the JAX package.

On the CPU the port's ``nb_nll_fused`` runs its plain version, which
repeats the CUDA kernels' arithmetic (``log1p``, the Stirling
``lgamma``/``digamma``); here it is held against the JAX package's Pallas
kernels in interpret mode and against its ``losses.nb_nll``.  The kernels
themselves are compared with the plain version on the card by
``chip_smoke.py`` and by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import scipy.special as ss
import torch

import jax
import jax.numpy as jnp

from dca_tpu import losses as jlosses
from dca_tpu.ops import activations as jactivations
from dca_tpu.ops import fused_loss as jfused
from dca_tpu.ops import special as jspecial

from dca_tpu_torch import losses
from dca_tpu_torch.ops import _build, fused_loss, special
from dca_tpu_torch.ops.activations import DispAct, MeanAct

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once


def _data(B, G, seed=0, nan_frac=0.0):
    """The inputs of tests/test_pallas.py, optionally with NaN targets."""
    rs = np.random.RandomState(seed)
    y = rs.negative_binomial(2, 0.4, size=(B, G)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.3] = 0.0
    mu = rs.uniform(0.1, 8.0, size=(B, G)).astype(np.float32)
    th = rs.uniform(0.1, 5.0, size=(B, G)).astype(np.float32)
    if nan_frac:
        y[rs.uniform(size=y.shape) < nan_frac] = np.nan
    return y, mu, th


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float32, requires_grad=grad)


# ---------------------------------------------------------------------------
# special functions (the plain twins of csrc/special.cuh)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["lgamma", "digamma"])
def test_special_matches_scipy_and_jax(fn):
    x = np.logspace(-4, 6, 500).astype(np.float32)
    got = getattr(special, fn)(torch.from_numpy(x)).numpy()
    ref = {"lgamma": ss.gammaln, "digamma": ss.digamma}[fn](x.astype(np.float64))
    # the accuracy tests/test_pallas.py asks of the JAX twins
    assert np.max(np.abs(got - ref) / (np.abs(ref) + 1.0)) < 1e-5
    # same recurrence, series and constants: float rounding apart
    jref = np.asarray(getattr(jspecial, fn)(x))
    assert np.max(np.abs(got - jref) / (np.abs(jref) + 1.0)) < 1e-6


@pytest.mark.parametrize("name", ["MeanAct", "DispAct"])
def test_output_activations_match_jax(name):
    x = np.concatenate([np.linspace(-30.0, 30.0, 201), [-1e5, 1e5]]).astype(np.float32)
    got = {"MeanAct": MeanAct, "DispAct": DispAct}[name](torch.from_numpy(x)).numpy()
    ref = np.asarray(getattr(jactivations, name)(jnp.asarray(x)))
    # exp and softplus of two libraries: float rounding apart; clips exact
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    lo, hi = {"MeanAct": (1e-5, 1e6), "DispAct": (1e-4, 1e4)}[name]
    assert got.min() == np.float32(lo) and got.max() == np.float32(hi)


# ---------------------------------------------------------------------------
# losses.nb_nll: the op-order oracle, against dca_tpu.losses.nb_nll
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masking", [False, True])
def test_nb_nll_matches_jax(masking):
    y, mu, th = _data(24, 96, seed=1)
    got = losses.nb_nll(_t(y), _t(mu), _t(th), masking=masking).item()
    ref = float(jlosses.nb_nll(y, mu, th, masking=masking))
    # torch.lgamma and lax.lgamma are different library functions
    assert abs(got - ref) / abs(ref) < 1e-5, (got, ref)
    elem = losses.nb_nll(_t(y), _t(mu), _t(th), masking=masking, mean=False).numpy()
    jelem = np.asarray(jlosses.nb_nll(y, mu, th, masking=masking, mean=False))
    np.testing.assert_allclose(elem, jelem, rtol=1e-5, atol=1e-5)


def test_nb_nll_masking_and_weights_match_jax():
    y, mu, th = _data(24, 96, seed=2, nan_frac=0.1)
    got = losses.nb_nll(_t(y), _t(mu), _t(th), masking=True).item()
    ref = float(jlosses.nb_nll(y, mu, th, masking=True))
    assert np.isfinite(got) and abs(got - ref) / abs(ref) < 1e-5, (got, ref)
    w = np.random.RandomState(2).uniform(0.0, 2.0, size=24).astype(np.float32)
    w[:3] = 0.0
    got = losses.nb_nll(_t(y), _t(mu), _t(th), sample_weights=_t(w)).item()
    ref = float(jlosses.nb_nll(y, mu, th, sample_weights=w))
    assert abs(got - ref) / abs(ref) < 1e-5, (got, ref)


def test_nb_nll_debug_sanitizer_raises():
    y, mu, th = _data(4, 8, seed=3)
    mu[0, 0] = np.inf
    with pytest.raises(FloatingPointError, match="y_pred"):
        losses.nb_nll(_t(y), _t(mu), _t(th), debug=True)


# ---------------------------------------------------------------------------
# nb_nll_fused: the kernels' plain version on the CPU, against the JAX
# package's Pallas kernels (interpret mode) and losses.nb_nll
# ---------------------------------------------------------------------------


def _port_value_and_grads(y, mu, th):
    m, t = _t(mu, True), _t(th, True)
    loss = fused_loss.nb_nll_fused(_t(y), m, t)
    dmu, dth = torch.autograd.grad(loss, (m, t))
    return loss.item(), dmu.numpy(), dth.numpy()


def _jax_fused(y, mu, th):
    # interpret=True is a nondiff_argnum of the custom VJP: positional
    fn = lambda m, t: jfused.nb_nll_fused(jnp.asarray(y), m, t, 1.0, True)  # noqa: E731
    val, grads = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(th))
    return float(val), [np.asarray(g) for g in grads]


def _jax_losses(y, mu, th):
    fn = lambda m, t: jlosses.nb_nll(jnp.asarray(y), m, t, masking=True)  # noqa: E731
    val, grads = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(th))
    return float(val), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape,nan_frac", [((16, 128), 0.0), ((33, 170), 0.0),
                                            ((7, 50), 0.0), ((24, 96), 0.1)])
def test_fused_matches_jax_kernels_and_losses(shape, nan_frac):
    y, mu, th = _data(*shape, seed=sum(shape), nan_frac=nan_frac)
    got, dmu, dth = _port_value_and_grads(y, mu, th)
    assert np.isfinite(got)
    for ref, (rmu, rth) in (_jax_fused(y, mu, th), _jax_losses(y, mu, th)):
        # log1p + Stirling against log(1 + x) + lax.lgamma, and sums in
        # another order: the tolerances tests/test_pallas.py uses
        assert abs(got - ref) / abs(ref) < 1e-4, (got, ref)
        np.testing.assert_allclose(dmu, rmu, rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(dth, rth, rtol=2e-3, atol=1e-5)


def test_fused_analytic_grads_match_autograd_of_plain_version():
    """K2's analytic gradient against autograd through K1's plain math."""
    y, mu, th = _data(16, 64, seed=4, nan_frac=0.1)
    _, dmu, dth = _port_value_and_grads(y, mu, th)
    m, t = _t(mu, True), _t(th, True)
    rmu, rth = torch.autograd.grad(fused_loss.nb_nll_fused_reference(_t(y), m, t), (m, t))
    # digamma from its own series vs autograd's derivative of the lgamma
    # series: both ~1e-6 relative
    np.testing.assert_allclose(dmu, rmu.numpy(), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(dth, rth.numpy(), rtol=1e-4, atol=1e-7)


def test_fused_theta_clip_zero_grad():
    y, mu, th = _data(8, 128, seed=7)
    th[0, 0] = 2e6  # above the clip
    th[3, 5] = 5e6
    _, _, dth = _port_value_and_grads(y, mu, th)
    _, (_, rth) = _jax_fused(y, mu, th)
    assert dth[0, 0] == 0.0 and dth[3, 5] == 0.0
    np.testing.assert_allclose(dth, rth, rtol=2e-3, atol=1e-5)


def test_fused_all_nan_targets_denominator_is_one():
    y, mu, th = _data(4, 16, seed=8)
    y[:] = np.nan
    got, dmu, _ = _port_value_and_grads(y, mu, th)
    ref, (rmu, _) = _jax_fused(y, mu, th)
    assert abs(got - ref) / abs(ref) < 1e-4
    np.testing.assert_allclose(dmu, rmu, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "theta_shape", "rank"])
def test_fused_rejects_what_the_kernel_does_not_take(bad):
    y, mu, th = (_t(a) for a in _data(8, 16, seed=9))
    err = TypeError if bad == "dtype" else ValueError
    if bad == "dtype":
        mu = mu.double()
    elif bad == "contiguous":
        mu = mu.t().contiguous().t()
    elif bad == "theta_shape":
        th = th[:1].contiguous()
    else:
        y, mu, th = y.reshape(-1), mu.reshape(-1), th.reshape(-1)
    with pytest.raises(err):
        fused_loss.nb_nll_fused(y, mu, th)


def test_kernel_wrappers_refuse_cpu_tensors():
    y, mu, th = (_t(a) for a in _data(4, 8, seed=10))
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss.nb_nll_fwd_kernel(y, mu, th)
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss.nb_nll_bwd_kernel(y, mu, th, torch.ones(1))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
