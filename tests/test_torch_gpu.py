"""The CUDA kernels against their plain PyTorch versions, on the card: NB
and ZINB, with full and broadcast theta/pi, their weighted variants
K1w/K2w, and the fused dense block K4 through both tilings of its plan and
every split of its split-K tiling; the one-launch K1 the same bits twice
and under CUDA-graph replay, and one device operation a loss forward.

These tests carry the ``gpu`` marker and skip where there is no CUDA
device; they import neither JAX nor the JAX package, so they run on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import (COMPARE_SHAPES, DENSE_CASES, _grad_check, _loss_inputs, _on, _ulps,
                        _weights, check_dense_case, check_weighted_case, dense_inputs)
from dca_tpu_torch.ops import fused_dense, fused_loss


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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["padding", "fractional", "zero"])
@pytest.mark.parametrize("shape,nan_frac,n_clipped,th_kind,pi_kind", [
    ((7, 50), 0.1, 3, "full", None), ((7, 50), 0.1, 3, "full", "full"),
    ((7, 50), 0.1, 3, "row", "col"), ((137, 3451), 0.0, 0, "full", "full")])
def test_weighted_kernels_match_plain_version_on_card(cuda, shape, nan_frac, n_clipped, th_kind,
                                                      pi_kind, kind):
    """The checks of chip_smoke.py's phase 1 for K1w/K2w: the ragged case
    with NaN targets and clipped theta, and the validation block of one of
    two ranks; zero-weight rows and NaN targets get gradients of exactly
    0, all-zero weights a loss of 0 over a denominator of 1."""
    B, G = shape
    shapes = {"full": (B, G), "row": (1, G), "col": (B, 1), None: None}
    fam = "nb" if pi_kind is None else "zinb"
    before = dict(fused_loss.launches)
    check_weighted_case(cuda, B, G, nan_frac, n_clipped, shapes[th_kind], shapes[pi_kind],
                        0.1, kind, seed=77)
    assert fused_loss.launches[f"{fam}_nll_fwd_w"] > before[f"{fam}_nll_fwd_w"]
    assert fused_loss.launches[f"{fam}_nll_bwd_w"] == before[f"{fam}_nll_bwd_w"] + 1
    assert fused_loss.launches[f"{fam}_nll_fwd"] == before[f"{fam}_nll_fwd"]


@pytest.mark.gpu
def test_weighted_kernels_raise_on_what_they_do_not_take(cuda):
    y, mu, th = (_t(a).to(cuda) for a in _data(8, 16, seed=13))
    with pytest.raises(ValueError, match="w must be"):
        fused_loss.nb_nll_fused_w(y, mu, th, torch.ones((8,), device=cuda))
    with pytest.raises(ValueError):
        fused_loss.nb_nll_fused_w(y, mu, th, torch.ones((8, 1)))  # on the CPU


@pytest.mark.gpu
@pytest.mark.parametrize("case,bf16", [(c, False) for c in DENSE_CASES]
                         + [(c, True) for c in DENSE_CASES if c[5]],
                         ids=lambda v: v[0] if isinstance(v, tuple) else ("bf16" if v else "f32"))
def test_fused_dense_matches_plain_version_on_card(cuda, case, bf16):
    """K4 at the shapes and with the tolerances of chip_smoke.py's phase 1:
    the linear output within the float32 bound of two sums of K products,
    every epilogue within 4 ulps of the plain activation of the kernel's
    linear output, the pre-activation the same bits for every epilogue, a
    NaN row staying NaN."""
    name, shape, bn, acts, with_sf, _ = case
    before = fused_dense.launches["fused_dense"]
    check_dense_case(cuda, name, shape, bn, acts, with_sf, seed=900, bf16=bf16)
    assert fused_dense.launches["fused_dense"] > before


@pytest.mark.gpu
def test_fused_dense_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros((4, 6), device=cuda)
    w = torch.zeros((6, 5), device=cuda)
    b = torch.zeros(5, device=cuda)
    with pytest.raises(ValueError):
        fused_dense.fused_dense_block(x, w, b.cpu())  # operands on two devices
    with pytest.raises(ValueError, match="not fusable"):
        fused_dense.fused_dense_block(x, w, b, activation="softplus")
    assert fused_dense.fused_dense_block(x[:0], w, b).shape == (0, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("shape", [(33, 1000, 70), (17, 200, 5), (130, 3451, 64)], ids=str)
def test_fused_dense_every_split_matches_plain_version_on_card(cuda, shape, splits):
    """The split-K tiling under every cluster size, whatever the plan would
    pick: ragged last slices, empty slices (200 is 7 steps), ragged rows
    and columns; the linear output within chip_smoke.py's tolerance, the
    same bits twice."""
    from dca_tpu_torch.ops.fused_dense import plan

    B, K, N = shape
    x, w, b, stats, _ = _on(cuda, dense_inputs(B, K, N, 40 + splits, bn=True))
    p = plan(B, K, N)._replace(splits=splits, cluster=splits)
    got = fused_dense._kernel(x, w, b, stats, "linear", None, p)
    assert torch.equal(fused_dense._kernel(x, w, b, stats, "linear", None, p), got)
    want = fused_dense.fused_dense_reference(x, w, b, bn=stats, activation="linear")
    tol = (2 * K * 2.0 ** -24 * (x.abs() @ w.abs() + b.abs()) * fused_dense.fold_bn(stats)[0].abs()
           + _ulps(want))
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("family,weighted", [("nb", False), ("zinb", False), ("nb", True),
                                             ("zinb", True)])
def test_one_launch_k1_same_bits_in_graphs_and_one_device_op(cuda, family, weighted):
    """K1's (sum, count, loss, denom) against its plain version, the same
    bits on a second launch and on CUDA-graph replays; one device operation
    a loss forward through _FusedNLL without a group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(cuda)
                     for a in _loss_inputs(32, 3451, 7, pi_shape=(32, 3451)
                                           if family == "zinb" else None))
    w = torch.from_numpy(_weights(32, "fractional", 7)).to(cuda) if weighted else None
    first = fused_loss._fwd_out_kernel(y, mu, th, pi, 0.1, w).clone()
    ref = fused_loss._fwd_out_reference(y, mu, th, pi, 0.1, w)
    assert abs(first[2].item() - ref[2].item()) <= 1e-5 * abs(ref[2].item())
    if not weighted:
        assert first[1].item() == ref[1].item() and first[3].item() == ref[3].item()
    assert torch.equal(first[2], first[0] / first[3])
    assert torch.equal(fused_loss._fwd_out_kernel(y, mu, th, pi, 0.1, w), first)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused_loss._fwd_out_kernel(y, mu, th, pi, 0.1, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fused_loss._fwd_out_kernel(y, mu, th, pi, 0.1, w)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)

    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fused_loss._FusedNLL.apply(y, mu, th, pi, w, 0.1, None)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in ops) == 5, [(e.key, e.count) for e in ops]
