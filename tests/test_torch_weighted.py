"""The weighted NB/ZINB losses of the PyTorch port (K1w and K2w) against
the JAX package's weighted Pallas kernels in interpret mode.

On the CPU ``nb_nll_fused_w``/``zinb_nll_fused_w`` run their plain
versions, which repeat the CUDA kernels' arithmetic; here they are held
against ``dca_tpu.ops.fused_loss.*_fused_w`` (the counterparts of
``tests/test_pallas.py``'s weighted cases) and against the JAX package's
``losses.*(sample_weights=)``.  The kernels themselves are compared with
the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dca_tpu import losses as jlosses
from dca_tpu.ops import fused_loss as jfused

from dca_tpu_torch.ops import fused_loss

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once


def _data(B, G, seed=0):
    """The inputs of tests/test_pallas.py."""
    rs = np.random.RandomState(seed)
    y = rs.negative_binomial(2, 0.4, size=(B, G)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.3] = 0.0
    mu = rs.uniform(0.1, 8.0, size=(B, G)).astype(np.float32)
    th = rs.uniform(0.1, 5.0, size=(B, G)).astype(np.float32)
    pi = rs.uniform(0.05, 0.7, size=(B, G)).astype(np.float32)
    return y, mu, th, pi


def _t(a, grad=False):
    return torch.tensor(a, dtype=torch.float32, requires_grad=grad)


def _port(y, mu, th, pi, w, ridge=0.0):
    """The port's weighted loss and its gradients (mu, theta[, pi])."""
    ops = [_t(a, True) for a in (mu, th, pi) if a is not None]
    col = _t(w.reshape(-1, 1))
    if pi is None:
        loss = fused_loss.nb_nll_fused_w(_t(y), *ops, col)
    else:
        loss = fused_loss.zinb_nll_fused_w(_t(y), *ops, col, ridge)
    return loss.item(), [g.numpy() for g in torch.autograd.grad(loss, ops)]


def _jax(y, mu, th, pi, w, ridge=0.0):
    """The JAX package's weighted Pallas kernels in interpret mode."""
    col = jnp.asarray(w.reshape(-1, 1))
    yj = jnp.asarray(y)
    if pi is None:
        fn = lambda m, t: jfused.nb_nll_fused_w(yj, m, t, col, True)  # noqa: E731
        args = (mu, th)
    else:
        fn = lambda m, t, p: jfused.zinb_nll_fused_w(yj, m, t, p, col, ridge, True)  # noqa: E731
        args = (mu, th, pi)
    val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    return float(val), [np.asarray(g) for g in grads]


def _jax_losses(y, mu, th, pi, w, ridge=0.0):
    """The JAX package's plain weighted losses."""
    yj, wj = jnp.asarray(y), jnp.asarray(w)
    if pi is None:
        fn = lambda m, t: jlosses.nb_nll(yj, m, t, sample_weights=wj)  # noqa: E731
        args = (mu, th)
    else:
        fn = lambda m, t, p: jlosses.zinb_nll(yj, m, t, p, ridge_lambda=ridge,  # noqa: E731
                                              sample_weights=wj)
        args = (mu, th, pi)
    val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    return float(val), [np.asarray(g) for g in grads]


def _agree(got, ref):
    """The tolerances tests/test_pallas.py holds the weighted kernels to."""
    (val, grads), (rval, rgrads) = got, ref
    assert abs(val - rval) <= 1e-4 * abs(rval), (val, rval)
    for g, r in zip(grads, rgrads):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("family", ["nb", "zinb"])
@pytest.mark.parametrize("shape", [(16, 128), (33, 170), (7, 50)])
def test_weighted_matches_jax_kernels_and_losses(family, shape):
    """Fractional weights, some of them 0."""
    y, mu, th, pi = _data(*shape, seed=11)
    pi = pi if family == "zinb" else None
    rs = np.random.RandomState(11)
    w = rs.uniform(0.2, 2.0, size=(shape[0],)).astype(np.float32)
    w[1] = 0.0
    got = _port(y, mu, th, pi, w, 0.05)
    _agree(got, _jax(y, mu, th, pi, w, 0.05))
    _agree(got, _jax_losses(y, mu, th, pi, w, 0.05))


@pytest.mark.parametrize("family", ["nb", "zinb"])
def test_all_zero_weights_divide_by_one(family):
    y, mu, th, pi = _data(6, 40, seed=12)
    pi = pi if family == "zinb" else None
    w = np.zeros((6,), np.float32)
    val, grads = _port(y, mu, th, pi, w, 0.05)
    assert val == 0.0 and all(np.all(g == 0.0) for g in grads)
    _, denom = fused_loss._fwd_reference(_t(y), _t(mu), _t(th), None if pi is None else _t(pi),
                                         0.05, _t(w.reshape(-1, 1)))
    assert denom.item() == 1.0
    _agree((val, grads), _jax(y, mu, th, pi, w, 0.05))


def test_fractional_total_weight_divides_as_it_is():
    """A total weight below 1 is the denominator as it is (the unweighted
    count is clamped to at least 1, the weighted total only at 0)."""
    y, mu, th, _ = _data(4, 10, seed=13)
    w = np.full((4,), 0.05, np.float32)
    loss, denom = fused_loss.nb_nll_fwd_w_reference(_t(y), _t(mu), _t(th), _t(w.reshape(-1, 1)))
    np.testing.assert_allclose(denom.item(), 0.05 * 40, rtol=1e-6)
    _agree(_port(y, mu, th, None, w), _jax(y, mu, th, None, w))


@pytest.mark.parametrize("th_kind,pi_kind", [("row", "full"), ("col", "col"), ("row", "row"),
                                             ("col", "row"), ("row", None), ("col", None)])
def test_weighted_broadcast_theta_and_pi(th_kind, pi_kind):
    """The (1, G) and (B, 1) operands of the constant-dispersion and
    *-shared architectures, with the weight column."""
    B, G = 16, 96
    y, mu, _, _ = _data(B, G, seed=14)
    rs = np.random.RandomState(14)
    shapes = {"full": (B, G), "row": (1, G), "col": (B, 1)}
    th = rs.uniform(0.2, 4.0, size=shapes[th_kind]).astype(np.float32)
    pi = (None if pi_kind is None
          else rs.uniform(0.05, 0.6, size=shapes[pi_kind]).astype(np.float32))
    w = rs.uniform(0.1, 1.5, size=(B,)).astype(np.float32)
    got = _port(y, mu, th, pi, w, 0.02)
    _agree(got, _jax(y, mu, th, pi, w, 0.02))
    _agree(got, _jax_losses(y, mu, th, pi, w, 0.02))


@pytest.mark.parametrize("family", ["nb", "zinb"])
def test_padding_rows_are_ignored_exactly(family):
    """The data-parallel validation's padding: copies of row 0 at weight 0
    give the unweighted loss over the real rows, and gradients of exactly
    0 on the padded rows."""
    y, mu, th, pi = _data(20, 64, seed=13)
    pi = pi if family == "zinb" else None
    pad = 5

    def padded(a):
        return np.concatenate([a, np.repeat(a[:1], pad, axis=0)])

    w = np.concatenate([np.ones(20, np.float32), np.zeros(pad, np.float32)])
    val, grads = _port(padded(y), padded(mu), padded(th), None if pi is None else padded(pi),
                       w, 0.05)
    if pi is None:
        plain = fused_loss.nb_nll_fused(_t(y), _t(mu), _t(th)).item()
    else:
        plain = fused_loss.zinb_nll_fused(_t(y), _t(mu), _t(th), _t(pi), 0.05).item()
    assert abs(val - plain) < 1e-6 * max(abs(plain), 1.0), (val, plain)
    for g in grads:
        assert np.all(g[20:] == 0.0) and np.any(g[:20] != 0.0)


@pytest.mark.parametrize("family", ["nb", "zinb"])
def test_nan_targets_weigh_zero(family):
    """NaN targets, composed with the weights: left out of the value and
    the total weight, and exactly 0 in the gradients (the unweighted
    kernel gives them their y = 0 gradient)."""
    y, mu, th, pi = _data(20, 64, seed=15)
    pi = pi if family == "zinb" else None
    rs = np.random.RandomState(15)
    y[rs.uniform(size=y.shape) < 0.1] = np.nan
    w = rs.uniform(0.0, 1.5, size=(20,)).astype(np.float32)
    w[:2] = 0.0
    val, grads = _port(y, mu, th, pi, w, 0.05)
    assert np.isfinite(val)
    nan = np.isnan(y)
    for g in grads:
        assert np.all(g[nan] == 0.0)
    _agree((val, grads), _jax(y, mu, th, pi, w, 0.05))
    _agree((val, grads), _jax_losses(y, mu, th, pi, w, 0.05))


@pytest.mark.parametrize("family", ["nb", "zinb"])
def test_analytic_weighted_grads_match_autograd_of_plain_version(family):
    """K2w's analytic gradients against autograd through K1w's plain math."""
    y, mu, th, pi = _data(12, 48, seed=16)
    pi = pi if family == "zinb" else None
    y[2, 3] = np.nan
    w = np.random.RandomState(16).uniform(0.0, 2.0, size=(12,)).astype(np.float32)
    _, grads = _port(y, mu, th, pi, w, 0.05)
    ops = [_t(a, True) for a in (mu, th, pi) if a is not None]
    col = _t(w.reshape(-1, 1))
    ref = (fused_loss.nb_nll_fused_w_reference(_t(y), *ops, col) if pi is None
           else fused_loss.zinb_nll_fused_w_reference(_t(y), *ops, col, 0.05))
    for g, r in zip(grads, torch.autograd.grad(ref, ops)):
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-4, atol=1e-8)


def test_weights_must_be_a_column():
    y, mu, th, _ = (_t(a) for a in _data(8, 16, seed=17))
    with pytest.raises(ValueError, match="w must be"):
        fused_loss.nb_nll_fused_w(y, mu, th, torch.ones(8))
    with pytest.raises(ValueError, match="w must be"):
        fused_loss.nb_nll_fused_w(y, mu, th, torch.ones((1, 16)))


def test_likelihood_loss_routes_sample_weights_like_jax():
    """``likelihood_loss(sample_weights=)`` of zinb-conddisp on bridged
    weights: the weighted kernels' plain version, equal to what the JAX
    package's ``likelihood_loss`` gives through its weighted kernels and
    through its plain losses."""
    import os

    from dca_tpu.models import AE_types as JAE_types

    from dca_tpu_torch.bridge import params_from_jax
    from dca_tpu_torch.models.network import AE_types

    jnet = JAE_types["zinb-conddisp"](input_size=32, hidden_size=(8, 4, 8), seed=0,
                                      ridge=0.03).build()
    net = AE_types["zinb-conddisp"](input_size=32, hidden_size=(8, 4, 8), ridge=0.03,
                                    device="cpu").build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    rs = np.random.RandomState(0)
    x = rs.normal(size=(12, 32)).astype(np.float32)
    sf = np.ones((12,), np.float32)
    t = rs.poisson(2.0, size=(12, 32)).astype(np.float32)
    w = rs.uniform(0.0, 1.0, size=(12,)).astype(np.float32)

    out, _ = net.apply(_t(x), _t(sf))
    got = net.likelihood_loss(out, _t(t), sample_weights=_t(w)).item()
    jout, _ = jnet.apply(jnet.params, jnet.state, x, sf, training=False)
    refs = []
    for fused in ("1", "0"):
        os.environ["DCA_TPU_FUSED_LOSS"] = fused
        try:
            refs.append(float(jnet.likelihood_loss(jout, t, sample_weights=jnp.asarray(w))))
        finally:
            del os.environ["DCA_TPU_FUSED_LOSS"]
    for ref in refs:
        assert abs(got - ref) <= 1e-4 * abs(ref), (got, refs)
    with pytest.raises(ValueError, match="one weight per row"):
        net.likelihood_loss(out, _t(t), sample_weights=_t(w[:5]))


def _weight_case(kind, B, seed=15):
    """None, or a (B,) weight vector: ``padding`` ones with the last row 0,
    ``fractional`` in [0.2, 2) with two rows 0, ``tiny`` 1e-4 everywhere (a
    total below 1), ``zero`` all 0."""
    if kind is None:
        return None
    w = np.ones((B,), np.float32)
    if kind == "padding":
        w[-1] = 0.0
    elif kind == "fractional":
        w = np.random.RandomState(seed).uniform(0.2, 2.0, size=(B,)).astype(np.float32)
        w[[0, B // 2]] = 0.0
    elif kind == "tiny":
        w[:] = 1e-4
    else:
        w[:] = 0.0
    return w


@pytest.mark.parametrize("family", ["nb", "zinb"])
@pytest.mark.parametrize("weights", [None, "padding", "fractional", "tiny", "zero"])
def test_one_launch_quotient_matches_jax_losses(family, weights):
    """What the last block of the one-launch K1 writes, (sum, count, sum /
    denom, denom), formed by ``_with_quotient`` with the kernel's formula:
    the denominator max(count, 1) unweighted and where(total == 0, 1,
    total) weighted (a total below 1 divides as it is, an all-zero one is
    1), the loss one float32 division of the two, and that loss the JAX
    package's ``losses.nb_nll``/``zinb_nll`` (masking, sample weights) at
    rtol 1e-5 (float32 sums in another order)."""
    B, G = 9, 40
    y, mu, th, pi = _data(B, G, seed=14)
    y[2, :7] = np.nan
    pi = pi if family == "zinb" else None
    w = _weight_case(weights, B)
    args = (_t(y), _t(mu), _t(th), None if pi is None else _t(pi), 0.05,
            None if w is None else _t(w.reshape(-1, 1)))
    out = fused_loss._fwd_out_reference(*args)
    s, c = fused_loss._fwd_sums_reference(*args)
    assert torch.equal(out[:2], torch.stack([s, c]))
    if w is None:
        # NB leaves the NaN targets out; ZINB only NaN results, and a NaN
        # target takes the NB case at y = 0
        assert c.item() == (B * G - 7 if pi is None else B * G)
        assert out[3].item() == max(c.item(), 1.0)
    else:
        valid = ~np.isnan(y)
        np.testing.assert_allclose(c.item(), (w[:, None] * valid).sum(), rtol=1e-6)
        assert out[3].item() == (1.0 if weights == "zero" else c.item())
    assert torch.equal(out[2], out[0] / out[3])
    yj = jnp.asarray(y)
    kw = {} if w is None else {"sample_weights": jnp.asarray(w)}
    if pi is None:
        want = float(jlosses.nb_nll(yj, jnp.asarray(mu), jnp.asarray(th), masking=True, **kw))
    else:
        want = float(jlosses.zinb_nll(yj, jnp.asarray(mu), jnp.asarray(th), jnp.asarray(pi),
                                      ridge_lambda=0.05, masking=True, **kw))
    assert abs(out[2].item() - want) <= 1e-5 * abs(want), (out[2].item(), want)
    if weights == "zero":
        assert out[2].item() == 0.0 == want
