"""The CUDA kernels against their plain PyTorch versions, on the card: NB
and ZINB, with full and broadcast theta/pi.

These tests carry the ``gpu`` marker and skip where there is no CUDA
device; they import neither JAX nor the JAX package, so they run on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import COMPARE_SHAPES, _grad_check, _loss_inputs
from dca_tpu_torch.ops import fused_loss


def _data(B, G, seed=0, nan_frac=0.0):
    rs = np.random.RandomState(seed)
    y = rs.negative_binomial(2, 0.4, size=(B, G)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.3] = 0.0
    mu = rs.uniform(0.1, 8.0, size=(B, G)).astype(np.float32)
    th = rs.uniform(0.1, 5.0, size=(B, G)).astype(np.float32)
    if nan_frac:
        y[rs.uniform(size=y.shape) < nan_frac] = np.nan
    th[0, 0] = 2e6  # above the clip: zero gradient
    return y, mu, th


def _t(a):
    return torch.tensor(a, dtype=torch.float32)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,nan_frac", [((32, 3451), 0.0), ((7, 50), 0.1)])
def test_kernels_match_plain_version_on_card(cuda, shape, nan_frac):
    y, mu, th = (_t(a).to(cuda) for a in _data(*shape, seed=11, nan_frac=nan_frac))
    mu.requires_grad_(True)
    th.requires_grad_(True)
    before = dict(fused_loss.launches)
    loss = fused_loss.nb_nll_fused(y, mu, th)
    dmu, dth = torch.autograd.grad(loss, (mu, th))
    assert fused_loss.launches["nb_nll_fwd"] == before["nb_nll_fwd"] + 1
    assert fused_loss.launches["nb_nll_bwd"] == before["nb_nll_bwd"] + 1
    with torch.no_grad():
        ref, denom = fused_loss.nb_nll_fwd_reference(y, mu, th)
        scale = 1.0 / denom
        rmu, rth = fused_loss.nb_nll_bwd_reference(y, mu, th, scale)
        mags = fused_loss.grad_term_magnitudes(y, mu, th)
    # the tolerances chip_smoke.py states; the gradients' on the unscaled
    # values, since the path scales them by 1 / denom
    assert abs(loss.item() - ref.item()) / abs(ref.item()) <= 1e-5
    for got, want, mag in ((dmu, rmu, mags[0]), (dth, rth, mags[1])):
        err = (got - want).abs() / scale
        tol = 1e-6 + 4 * 2.0 ** -23 * mag + 1e-4 * (want / scale).abs()
        assert bool((err <= tol).all()), float((err / tol).max())
    assert dth[0, 0].item() == 0.0
    # no atomics: the same inputs give the same bits
    assert torch.equal(fused_loss.nb_nll_fused(y, mu, th), loss)


@pytest.mark.gpu
def test_kernels_raise_on_what_they_do_not_take(cuda):
    y, mu, th = (_t(a).to(cuda) for a in _data(8, 16, seed=12))
    with pytest.raises(ValueError):
        fused_loss.nb_nll_fused(y, mu, th[:2].contiguous())  # no broadcast rule
    with pytest.raises(TypeError):
        fused_loss.nb_nll_fused(y, mu.double(), th)


@pytest.mark.gpu
@pytest.mark.parametrize("th_kind,pi_kind,ridge", [
    ("full", "full", 0.0), ("full", "full", 0.1), ("row", "full", 0.1),
    ("col", "col", 0.1), ("row", "row", 0.1), ("col", "row", 0.1),
    ("row", None, 0.0), ("col", None, 0.0)])
@pytest.mark.parametrize("shape_index", [0, 3])
def test_zinb_and_broadcast_kernels_match_plain_version_on_card(cuda, shape_index,
                                                               th_kind, pi_kind, ridge):
    """The checks of chip_smoke.py's phase 1, at (32, 3451) and the ragged
    (7, 50) with NaN targets and clipped theta."""
    (B, G), nan_frac, n_clipped = COMPARE_SHAPES[shape_index]
    shapes = {"full": (B, G), "row": (1, G), "col": (B, 1), None: None}
    y, mu, th, pi = (None if a is None else _t(a).to(cuda)
                     for a in _loss_inputs(B, G, 5, nan_frac, n_clipped, shapes[th_kind],
                                           shapes[pi_kind]))
    ops = [t.requires_grad_(True) for t in (mu, th, pi) if t is not None]
    fam = "nb" if pi is None else "zinb"
    before = dict(fused_loss.launches)
    if pi is None:
        loss = fused_loss.nb_nll_fused(y, mu, th)
    else:
        loss = fused_loss.zinb_nll_fused(y, mu, th, pi, ridge)
    grads = torch.autograd.grad(loss, ops)
    assert fused_loss.launches[f"{fam}_nll_fwd"] == before[f"{fam}_nll_fwd"] + 1
    assert fused_loss.launches[f"{fam}_nll_bwd"] == before[f"{fam}_nll_bwd"] + 1
    with torch.no_grad():
        ref, denom = fused_loss._fwd_reference(y, mu, th, pi, ridge)
        scale = 1.0 / denom
        refs = fused_loss._bwd_reference(y, mu, th, pi, ridge, scale.reshape(1))
        fulls = fused_loss._elem_grads(y, mu, th, pi, ridge)
        mags = fused_loss.grad_term_magnitudes(y, mu, th, pi, ridge)
    assert abs(loss.item() - ref.item()) / abs(ref.item()) <= 1e-5
    for name, got, want, full, mag in zip(("mu", "theta", "pi"), grads, refs, fulls, mags):
        assert got.shape == want.shape, name
        _grad_check(name, got, want, full.expand(B, G), mag.expand(B, G), scale)
    again = (fused_loss.nb_nll_fused(y, mu, th) if pi is None
             else fused_loss.zinb_nll_fused(y, mu, th, pi, ridge))
    assert torch.equal(again, loss)  # no atomics: the same bits
