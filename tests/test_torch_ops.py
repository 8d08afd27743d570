"""The PyTorch port's special functions, losses and fused NB/ZINB losses
against the JAX package.

On the CPU the port's ``nb_nll_fused`` and ``zinb_nll_fused`` run their
plain versions, which repeat the CUDA kernels' arithmetic (``log1p``, the
Stirling ``lgamma``/``digamma``, exp/log for the zero probability); here
they are held against the JAX package's Pallas kernels in interpret mode
and against its ``losses.nb_nll``/``zinb_nll``.  The kernels
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
        th = th[:2].contiguous()  # (2, G): no broadcast rule takes it
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


# ---------------------------------------------------------------------------
# ZINB, broadcast theta/pi, MSE and Poisson
# ---------------------------------------------------------------------------


def _pi(shape, seed):
    return np.random.RandomState(seed).uniform(0.05, 0.7, size=shape).astype(np.float32)


def _zinb_port(y, mu, th, pi, ridge):
    m, t, p = _t(mu, True), _t(th, True), _t(pi, True)
    loss = fused_loss.zinb_nll_fused(_t(y), m, t, p, ridge)
    grads = torch.autograd.grad(loss, (m, t, p))
    return loss.item(), [g.numpy() for g in grads]


def _zinb_jax(fn, y, mu, th, pi):
    val, grads = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        jnp.asarray(mu), jnp.asarray(th), jnp.asarray(pi))
    return float(val), [np.asarray(g) for g in grads]


def _zinb_jax_refs(y, mu, th, pi, ridge):
    """The JAX package's Pallas kernels (interpret mode, positional) and its
    losses.zinb_nll, each with its gradients."""
    yj = jnp.asarray(y)
    kern = lambda m, t, p: jfused.zinb_nll_fused(yj, m, t, p, ridge, True)  # noqa: E731
    loss = lambda m, t, p: jlosses.zinb_nll(yj, m, t, p, ridge_lambda=ridge,  # noqa: E731
                                            masking=True)
    return _zinb_jax(kern, y, mu, th, pi), _zinb_jax(loss, y, mu, th, pi)


@pytest.mark.parametrize("ridge", [0.0, 0.07])
@pytest.mark.parametrize("shape,nan_frac", [((16, 128), 0.0), ((33, 170), 0.0),
                                            ((7, 50), 0.0), ((24, 96), 0.1)])
def test_zinb_fused_matches_jax_kernels_and_losses(shape, nan_frac, ridge):
    y, mu, th = _data(*shape, seed=sum(shape) + 1, nan_frac=nan_frac)
    pi = _pi(shape, sum(shape))
    got, grads = _zinb_port(y, mu, th, pi, ridge)
    assert np.isfinite(got)
    for ref, rgrads in _zinb_jax_refs(y, mu, th, pi, ridge):
        assert abs(got - ref) / abs(ref) < 1e-4, (got, ref)
        for g, r in zip(grads, rgrads):
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("th_shape,pi_shape", [
    ((1, 150), (24, 150)),   # zinb: constant theta, full pi
    ((24, 1), (24, 1)),      # zinb-shared: both (B, 1)
    ((1, 150), (1, 150)),    # both gene-wise
    ((24, 1), (1, 150)),     # mixed
    ((1, 150), None),        # nb: constant theta
    ((24, 1), None),         # nb-shared
])
def test_broadcast_theta_pi_match_jax(th_shape, pi_shape):
    """The pairs tests/test_pallas.py pins for the JAX kernels: the plain
    version broadcasts, and each gradient is summed to its operand's shape."""
    y, mu, _ = _data(24, 150, seed=7)
    th = np.random.RandomState(11).uniform(0.1, 5.0, size=th_shape).astype(np.float32)
    if pi_shape is None:
        got, dmu, dth = _port_value_and_grads(y, mu, th)
        grads = [dmu, dth]
        refs = [_jax_fused(y, mu, th), _jax_losses(y, mu, th)]
    else:
        pi = _pi(pi_shape, 12)
        got, grads = _zinb_port(y, mu, th, pi, 0.07)
        refs = _zinb_jax_refs(y, mu, th, pi, 0.07)
    for ref, rgrads in refs:
        assert abs(got - ref) / abs(ref) < 1e-4, (got, ref)
        for g, r in zip(grads, rgrads):
            assert g.shape == r.shape
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-4)


def test_zinb_theta_clip_zero_grad():
    y, mu, th = _data(8, 128, seed=13)
    th[0, 0] = 2e6
    th[3, 5] = 5e6
    y[3, 5] = 0.0  # the zero case too
    pi = _pi((8, 128), 13)
    _, (_, dth, _) = _zinb_port(y, mu, th, pi, 0.0)
    (_, (_, rth, _)), _ = _zinb_jax_refs(y, mu, th, pi, 0.0)
    assert dth[0, 0] == 0.0 and dth[3, 5] == 0.0
    np.testing.assert_allclose(dth, rth, rtol=2e-3, atol=1e-5)


def test_zinb_all_nan_targets_count_every_result():
    """NaN targets take the NB case at y = 0, and ZINB's denominator counts
    the non-NaN results: every element, unlike NB's count of targets."""
    y, mu, th = _data(4, 16, seed=14)
    y[:] = np.nan
    pi = _pi((4, 16), 14)
    _, denom = fused_loss.zinb_nll_fwd_reference(_t(y), _t(mu), _t(th), _t(pi), 0.07)
    assert denom.item() == 64.0
    assert fused_loss.nb_nll_fwd_reference(_t(y), _t(mu), _t(th))[1].item() == 1.0
    got, grads = _zinb_port(y, mu, th, pi, 0.07)
    for ref, rgrads in _zinb_jax_refs(y, mu, th, pi, 0.07):
        assert abs(got - ref) / abs(ref) < 1e-4, (got, ref)
        for g, r in zip(grads, rgrads):
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-5)


def test_zinb_theta_zero_guard_gives_the_jax_value():
    """At theta = 0 the zero probability is 1 (power(0, 0)), not the NaN of
    0 * log(0)."""
    y, mu, th = _data(4, 16, seed=15)
    y[0, :4] = 0.0
    th[0, :4] = 0.0
    pi = _pi((4, 16), 15)
    res = fused_loss._elem_terms(_t(y), _t(mu), _t(th), _t(pi), 0.0)[0, :4]
    want = -np.log(pi[0, :4] + (1.0 - pi[0, :4]) * 1.0 + 1e-10)
    np.testing.assert_allclose(res.numpy(), want, rtol=1e-6)
    th[0, :4] = 1e-3  # the zero-case gradient needs theta > 0 (Stirling)
    got, (_, dth, dpi) = _zinb_port(y, mu, th, pi, 0.0)
    (ref, (_, rth, rpi)), _ = _zinb_jax_refs(y, mu, th, pi, 0.0)
    assert np.isfinite(dth).all() and abs(got - ref) / abs(ref) < 1e-4
    np.testing.assert_allclose(dpi, rpi, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("shapes", [((16, 64), (16, 64)), ((1, 64), (16, 1))])
def test_zinb_analytic_grads_match_autograd_of_plain_version(shapes):
    """K2's analytic ZINB gradient against autograd through K1's plain math."""
    y, mu, _ = _data(16, 64, seed=16, nan_frac=0.1)
    th = np.random.RandomState(16).uniform(0.1, 5.0, size=shapes[0]).astype(np.float32)
    pi = _pi(shapes[1], 16)
    _, grads = _zinb_port(y, mu, th, pi, 0.07)
    m, t, p = _t(mu, True), _t(th, True), _t(pi, True)
    refs = torch.autograd.grad(
        fused_loss.zinb_nll_fused_reference(_t(y), m, t, p, 0.07), (m, t, p))
    for g, r in zip(grads, refs):
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("masking", [False, True])
def test_zinb_nll_matches_jax(masking):
    y, mu, th = _data(24, 96, seed=17)
    pi = _pi((24, 96), 17)
    got = losses.zinb_nll(_t(y), _t(mu), _t(th), _t(pi), ridge_lambda=0.07,
                          masking=masking).item()
    ref = float(jlosses.zinb_nll(y, mu, th, pi, ridge_lambda=0.07, masking=masking))
    assert abs(got - ref) / abs(ref) < 1e-5, (got, ref)
    elem = losses.zinb_nll(_t(y), _t(mu), _t(th), _t(pi), masking=masking, mean=False)
    jelem = np.asarray(jlosses.zinb_nll(y, mu, th, pi, masking=masking, mean=False))
    np.testing.assert_allclose(elem.numpy(), jelem, rtol=1e-5, atol=1e-5)


def test_zinb_nll_masking_weights_and_debug_match_jax():
    y, mu, th = _data(24, 96, seed=18, nan_frac=0.1)
    pi = _pi((1, 96), 18)
    got = losses.zinb_nll(_t(y), _t(mu), _t(th), _t(pi), masking=True).item()
    ref = float(jlosses.zinb_nll(y, mu, th, pi, masking=True))
    assert np.isfinite(got) and abs(got - ref) / abs(ref) < 1e-5, (got, ref)
    w = np.random.RandomState(18).uniform(0.0, 2.0, size=24).astype(np.float32)
    w[:3] = 0.0
    got = losses.zinb_nll(_t(y), _t(mu), _t(th), _t(pi), sample_weights=_t(w)).item()
    ref = float(jlosses.zinb_nll(y, mu, th, pi, sample_weights=w))
    assert abs(got - ref) / abs(ref) < 1e-5, (got, ref)
    mu[0, 0] = np.inf
    with pytest.raises(FloatingPointError, match="y_pred"):
        losses.zinb_nll(_t(y), _t(mu), _t(th), _t(pi), debug=True)


@pytest.mark.parametrize("nan_frac", [0.0, 0.1])
@pytest.mark.parametrize("name", ["mse_loss", "poisson_loss"])
def test_mse_and_poisson_match_jax(name, nan_frac):
    y, mu, _ = _data(24, 96, seed=19, nan_frac=nan_frac)
    fn, jfn = getattr(losses, name), getattr(jlosses, name)
    got = fn(_t(y), _t(mu)).item()
    ref = float(jfn(y, mu))
    assert np.isfinite(got) and abs(got - ref) / abs(ref) < 1e-5, (got, ref)
    w = np.random.RandomState(19).uniform(0.0, 2.0, size=24).astype(np.float32)
    got = fn(_t(y), _t(mu), sample_weights=_t(w)).item()
    ref = float(jfn(y, mu, sample_weights=w))
    assert abs(got - ref) / abs(ref) < 1e-5, (got, ref)
    m = _t(mu, True)
    (g,) = torch.autograd.grad(fn(_t(y), m), (m,))
    rg = jax.grad(lambda a: jfn(jnp.asarray(y), a))(jnp.asarray(mu))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-5, atol=1e-8)


def test_zinb_wrappers_refuse_cpu_tensors():
    y, mu, th = (_t(a) for a in _data(4, 8, seed=20))
    pi = _t(_pi((4, 8), 20))
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss.zinb_nll_fwd_kernel(y, mu, th, pi, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss.zinb_nll_bwd_kernel(y, mu, th, pi, 0.0, torch.ones(1))
    with pytest.raises(ValueError, match="pi"):
        fused_loss.zinb_nll_fused(y, mu, th, pi[:, :3].contiguous())
