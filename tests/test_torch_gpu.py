"""The CUDA kernels against their plain PyTorch versions, on the card: NB
and ZINB, with full and broadcast theta/pi, their weighted variants
K1w/K2w, and the fused dense block K4 through both tilings of its plan and
every split of its split-K tiling; the one-launch K1 the same bits twice
and under CUDA-graph replay, and one device operation a loss forward; K2
with a non-unit incoming gradient, on fresh tensors and on views at an
odd address, the same bits twice and under CUDA-graph replay, and one
device operation a loss backward; the reciprocal and division of
``csrc/special.cuh`` the same bits as CUDA's IEEE ones; and the training
step replayed from CUDA graphs (``train/graphs.py``) against the eager
loop on the card (``_graphs=False``), for every optimizer and for PReLU,
its launch counts, and a capture that fails raising; the forward's outputs
fetched through a page-locked ring the same bits as pageable copies,
block by block, with nothing page-locked beyond the ring; PReLU
layers kept off K4; and the fit's artefacts: a resumed graph fit the
uninterrupted fit's bits at dropout 0.1, in memory and streamed, a
TensorBoard fit the plain fit's, the TensorBoard gradient's K2 and K2w
against their plain versions, and ``load_weights`` reaching a graph
captured before it (with h5py); two graph fits run at once in two threads
(the hyperparameter search's trials) each giving its solo bits and the
launch counters exact, and K1 at a trial's validation shape; the whole fit
on the device (``compiled=True``): its graph the bits of the same fit from
Python, an epoch after the early stop changing nothing, the launch tally
of the epochs run alone, two such fits in two threads, and the IF node's
kernel against its plain version; RMSprop's one-launch update (K5,
``ops/fused_optim.py``) the plain loop's bits at the configurations'
leaves, at odd sizes on misaligned views, with infinite, NaN and clipped
gradients and under CUDA-graph replay with the rate rewritten, one launch
a step in every fit above.

These tests carry the ``gpu`` marker and skip where there is no CUDA
device; they import neither JAX nor the JAX package, so they run on a GPU
machine that has only PyTorch:

    python -m pytest tests/test_torch_gpu.py -q
"""

import contextlib
import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

from chip_smoke import (COMPARE_SHAPES, DENSE_CASES, LOSS_RTOL, OPTIONS, RMSPROP_CASES,
                        STEP_COUNTED, _big_loss_inputs, _grad_check,
                        _loss_inputs, _on, _placed_leaves, _rmsprop_grads, _small_counts,
                        _steps, _ulps, _want_launches, _warmups, _weights, bits_equal,
                        check_dense_case, check_k2_call, check_rmsprop_case,
                        check_weighted_case, dense_inputs, options_fit, recording_k2,
                        rmsprop_shapes)
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models import network
from dca_tpu_torch.models.network import fetch_to_host, get_ae_type
from dca_tpu_torch.ops import _build, fused_dense, fused_loss, fused_optim
from dca_tpu_torch.parallel.step import StepBuffers, make_sharded_train_step
from dca_tpu_torch.train import optim
from dca_tpu_torch.train.graphs import EagerEpoch, GraphEpoch
from dca_tpu_torch.train.loop import train


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
        rmu, rth = fused_loss.nb_nll_bwd_reference(y, mu, th, torch.ones_like(denom), denom)
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
        refs = fused_loss._bwd_reference(y, mu, th, pi, ridge, torch.ones_like(denom), denom)
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

    with torch.no_grad():
        ops = _device_ops(lambda: fused_loss._FusedNLL.apply(y, mu, th, pi, w, 0.1, None), 5)
    assert sum(e.count for e in ops) == 5, [(e.key, e.count) for e in ops]


def _device_ops(fn, n):
    """The device operations ``torch.profiler`` lists for ``n`` calls of
    ``fn``.  The profiler's first recorded device operation can go missing,
    so one throwaway call runs in a warm-up step of the profiler's schedule
    and only the ``n`` calls of the active step are counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for calls in (1, n):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _placed(a, dev, aligned):
    """``a`` on the card: a fresh tensor (aligned as PyTorch's allocator
    aligns it), or a contiguous view one float past an aligned address."""
    t = torch.from_numpy(a).to(dev)
    if aligned:
        return t
    view = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True], ids=["K2", "K2w"])
@pytest.mark.parametrize("family", ["nb", "zinb"])
@pytest.mark.parametrize("shape,nan_frac,n_clipped,aligned", [
    ((32, 3451), 0.0, 0, True), ((25, 3451), 0.0, 0, True), ((7, 50), 0.1, 3, True),
    ((32, 3451), 0.0, 0, False), ((7, 50), 0.1, 3, False)], ids=str)
def test_k2_matches_plain_version_same_bits_in_graphs(cuda, shape, nan_frac, n_clipped,
                                                      aligned, family, weighted):
    """K2/K2w against the plain version with a non-unit incoming gradient,
    at the step shape, the trailing step and a ragged (7, 50) with NaN
    targets and clipped theta, on fresh tensors and on views one float
    past an aligned address; the same bits on a second launch and on
    CUDA-graph replays."""
    B, G = shape
    y, mu, th, pi = (None if a is None else _placed(a, cuda, aligned)
                     for a in _loss_inputs(B, G, 31, nan_frac, n_clipped,
                                           pi_shape=(B, G) if family == "zinb" else None))
    w = torch.from_numpy(_weights(B, "fractional", 31)).to(cuda) if weighted else None
    g = torch.tensor(0.37, device=cuda)
    _, denom = fused_loss._fwd_kernel(y, mu, th, pi, 0.1, w)

    def k2():
        return fused_loss._bwd_kernel(y, mu, th, pi, 0.1, g, denom, w)

    name = fused_loss._name(pi, w, "bwd")
    before = fused_loss.launches[name]
    got = [t.clone() for t in k2()]
    assert fused_loss.launches[name] == before + 1
    with torch.no_grad():
        refs = fused_loss._bwd_reference(y, mu, th, pi, 0.1, g, denom, w)
        w_eff = 1.0 if w is None else torch.where(torch.isnan(y), 0.0, w)
        fulls = [d * w_eff for d in fused_loss._elem_grads(y, mu, th, pi, 0.1) if d is not None]
        mags = [m * w_eff for m in fused_loss.grad_term_magnitudes(y, mu, th, pi, 0.1)
                if m is not None]
    for name, a, want, full, mag in zip(("mu", "theta", "pi"), got, refs, fulls, mags):
        _grad_check(name, a, want, full, mag, g / denom)
        if weighted:
            assert bool((a[(w_eff == 0.0).expand(B, G)] == 0.0).all()), name
    assert all(torch.equal(a, b) for a, b in zip(got, k2()))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k2()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k2()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, got))


@pytest.mark.gpu
@pytest.mark.parametrize("family,weighted", [("nb", False), ("zinb", False), ("nb", True),
                                             ("zinb", True)])
def test_one_device_op_per_loss_backward(cuda, family, weighted):
    """A loss backward through _FusedNLL without a group is K2 alone: the
    kernel divides the incoming gradient by the denominator itself."""
    y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(cuda)
                     for a in _loss_inputs(32, 3451, 9, pi_shape=(32, 3451)
                                           if family == "zinb" else None))
    w = torch.from_numpy(_weights(32, "padding", 9)).to(cuda) if weighted else None
    ops = [t.requires_grad_(True) for t in (mu, th, pi) if t is not None]
    loss = fused_loss._FusedNLL.apply(y, mu, th, pi, w, 0.1, None)
    g = torch.tensor(0.37, device=cuda)
    torch.autograd.grad(loss, ops, g, retain_graph=True)
    torch.cuda.synchronize()
    items = _device_ops(lambda: torch.autograd.grad(loss, ops, g, retain_graph=True), 5)
    assert sum(e.count for e in items) == 5, [(e.key, e.count) for e in items]
    assert all("nll_bwd_kernel" in e.key for e in items), [e.key for e in items]


@pytest.mark.gpu
def test_k2_refuses_what_it_does_not_take(cuda):
    y, mu, th = (_t(a).to(cuda) for a in _data(8, 16, seed=14))
    denom = torch.tensor(100.0, device=cuda)
    for g in (torch.ones((), dtype=torch.float64, device=cuda), torch.ones(()),
              torch.ones(2, device=cuda)):
        with pytest.raises(ValueError, match="g must be"):
            fused_loss.nb_nll_bwd_kernel(y, mu, th, g, denom)


# dca_rcp_normal and dca_div_normal against CUDA's IEEE __frcp_rn and
# __fdiv_rn, compared bit for bit on the card.  Each kernel counts the
# operands it tested and those that differ, and keeps the bits of one
# that differs (a << 32 | b).
_SPECIAL_PROBE = r"""
#include <cuda_runtime.h>
#include "special.cuh"

__device__ unsigned long long mix(unsigned long long x) {  // splitmix64
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return x ^ (x >> 31);
}

__device__ void tally(unsigned long long* out, unsigned long long tested,
                      unsigned long long bad, unsigned long long example) {
    atomicAdd(out, tested);
    if (bad) {
        atomicAdd(out + 1, bad);
        atomicExch(out + 2, example);
    }
}

// every float z with lo <= bits(|z|) <= hi, both signs
__global__ void rcp_sweep(unsigned lo, unsigned hi, unsigned long long* out) {
    unsigned long long tested = 0, bad = 0, example = 0;
    const unsigned long long count = (unsigned long long)(hi - lo) + 1;
    for (unsigned long long k = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
         k < count; k += (unsigned long long)gridDim.x * blockDim.x) {
        for (int sign = 0; sign < 2; ++sign) {
            const unsigned bits = (lo + (unsigned)k) | (sign ? 0x80000000u : 0u);
            const float z = __uint_as_float(bits);
            ++tested;
            if (__float_as_uint(dca_rcp_normal(z)) != __float_as_uint(__frcp_rn(z))) {
                ++bad;
                example = bits;
            }
        }
    }
    tally(out, tested, bad, example);
}

// n pairs (a, b), bits(|a|) uniform in [a_lo, a_hi], bits(|b|) in [b_lo,
// b_hi], each sign at random (a = +0 where a_hi == 0); only the pairs whose
// exact quotient is a normal float (or 0, for a = +0) are tested
__global__ void div_sample(unsigned a_lo, unsigned a_hi, unsigned b_lo, unsigned b_hi,
                           unsigned long long n, unsigned long long seed,
                           unsigned long long* out) {
    unsigned long long tested = 0, bad = 0, example = 0;
    for (unsigned long long k = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
         k < n; k += (unsigned long long)gridDim.x * blockDim.x) {
        const unsigned long long h = mix(seed ^ mix(k));
        const unsigned long long s = mix(h);
        unsigned ab = a_lo + (unsigned)((h & 0xffffffffull) % ((unsigned long long)(a_hi - a_lo) + 1));
        unsigned bb = b_lo + (unsigned)((h >> 32) % ((unsigned long long)(b_hi - b_lo) + 1));
        if (a_hi != 0 && (s & 1)) ab |= 0x80000000u;
        if (s & 2) bb |= 0x80000000u;
        const float a = __uint_as_float(ab);
        const float b = __uint_as_float(bb);
        const double q = fabs((double)a / (double)b);
        if (a_hi != 0 && (q < 0x1p-126 || q >= 0x1.fffffep127)) continue;
        ++tested;
        const float got = dca_div_normal(a, b, dca_rcp_normal(b));
        if (__float_as_uint(got) != __float_as_uint(__fdiv_rn(a, b))) {
            ++bad;
            example = ((unsigned long long)ab << 32) | bb;
        }
    }
    tally(out, tested, bad, example);
}

extern "C" int probe_rcp(unsigned lo, unsigned hi, unsigned long long* out) {
    rcp_sweep<<<132 * 16, 256>>>(lo, hi, out);
    return (int)cudaDeviceSynchronize();
}

extern "C" int probe_div(unsigned a_lo, unsigned a_hi, unsigned b_lo, unsigned b_hi,
                         unsigned long long n, unsigned long long seed,
                         unsigned long long* out) {
    div_sample<<<132 * 16, 256>>>(a_lo, a_hi, b_lo, b_hi, n, seed, out);
    return (int)cudaDeviceSynchronize();
}
"""


@pytest.fixture(scope="module")
def special_probe(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe runs on the card")
    work = tmp_path_factory.mktemp("special_probe")
    src, lib = work / "probe.cu", work / "probe.so"
    src.write_text(_SPECIAL_PROBE)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", _build.CSRC_DIR,
                    "-o", str(lib), str(src)], check=True, capture_output=True, text=True)
    probe = ctypes.CDLL(str(lib))
    u32, u64, ptr = ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_void_p
    probe.probe_rcp.argtypes = [u32, u32, ptr]
    probe.probe_div.argtypes = [u32, u32, u32, u32, u64, u64, ptr]
    return probe


def _bits(x):
    return int(np.float32(x).view(np.uint32))


def _probe_result(run):
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    assert run(out.data_ptr()) == 0
    tested, bad, example = (int(v) & (2 ** 64 - 1) for v in out.tolist())
    return tested, bad, f"{example >> 32:#010x} / {example & 0xffffffff:#010x}"


@pytest.mark.gpu
def test_rcp_normal_same_bits_as_ieee_reciprocal(cuda, special_probe):
    """dca_rcp_normal(z) and __frcp_rn(z) are the same bits for every float
    of magnitude in [2^-125, 2^125], of either sign: the range its comment
    states, which holds every denominator of the loss (1e-10 and up)."""
    tested, bad, example = _probe_result(
        lambda out: special_probe.probe_rcp(_bits(2.0 ** -125), _bits(2.0 ** 125), out))
    assert tested == 2 * (_bits(2.0 ** 125) - _bits(2.0 ** -125) + 1)
    assert bad == 0, f"{bad} of {tested} differ, e.g. z bits {example}"


@pytest.mark.gpu
@pytest.mark.parametrize("a_range,b_range", [
    # the loss's operands: numerators up to counts and theta near the
    # clip, denominators from 1e-10 (theta + eps, mu + eps, 1 - pi + eps)
    # to theta + mu near 1e7
    ((2.0 ** -100, 1e7), (1e-10, 1e7)),
    # the domain the comment states
    ((2.0 ** -100, 2.0 ** 100), (2.0 ** -100, 2.0 ** 100)),
    # a = +0 (dz/dmu where z underflowed), over every denominator
    # dca_rcp_normal takes
    ((0.0, 0.0), (2.0 ** -125, 2.0 ** 125))], ids=["loss", "wide", "zero"])
def test_div_normal_same_bits_as_ieee_division(cuda, special_probe, a_range, b_range):
    """dca_div_normal(a, b, dca_rcp_normal(b)) and __fdiv_rn(a, b) are the
    same bits over 2^28 pairs of each range whose quotient is normal (or
    a = +0), the signs at random: the domain its comment states.  (With
    |a| log-uniform from 2^-126 instead, one pair in 500 rounds a bit
    apart: the remainder underflows.)"""
    a_lo, a_hi = (_bits(v) for v in a_range)
    b_lo, b_hi = (_bits(v) for v in b_range)
    tested, bad, example = _probe_result(
        lambda out: special_probe.probe_div(a_lo, a_hi, b_lo, b_hi, 2 ** 28, 2024, out))
    assert tested > 2 ** 26, tested
    assert bad == 0, f"{bad} of {tested} differ, e.g. a / b bits {example}"


# ---------------------------------------------------------------------------
# the training step replayed from CUDA graphs
# ---------------------------------------------------------------------------


def _fit(cuda, ae_type, graphs, state=None, epochs=3, dropout=0.0, **kw):
    """A (64, 32, 64) fit on 400 cells x 300 genes; returns (history, the
    loss kernels' launches, the network's initial state)."""
    adata = io.normalize(io.read_dataset(AnnData(_small_counts(400, 300, 5))))
    net = get_ae_type(ae_type)(input_size=300, hidden_size=(64, 32, 64),
                               hidden_dropout=dropout, device=cuda).build()
    if state is None:
        state = {k: v.clone() for k, v in net.model.state_dict().items()}
    net.model.load_state_dict(state)
    fused_loss.reset_launches()
    fused_optim.reset_launches()
    hist = train(adata, net, epochs=epochs, verbose=False, _graphs=graphs, **kw)
    torch.cuda.synchronize()
    return hist, {**fused_loss.launches, **fused_optim.launches}, state


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("validation_split,n_full,rem", [(0.1, 11, 8), (0.2, 10, 0)])
@pytest.mark.parametrize("ae_type", ["nb-conddisp", "zinb-conddisp"])
def test_graph_fit_matches_eager_fit_on_card(cuda, ae_type, validation_split, n_full, rem,
                                             dropout):
    """The fit replayed from CUDA graphs and the eager fit on the card, from
    the same weights and seed: the same histories within rtol 1e-6 (the
    same kernels on the same data; with dropout the registered generator
    draws the eager masks at each replay, and the warm-up restores it); the
    launches those of the eager fit plus one warm-up of each captured step
    (two with a trailing step, one without); RMSprop's K5 once a step."""
    epochs = 3
    graph, graph_launches, state = _fit(cuda, ae_type, True, epochs=epochs, dropout=dropout,
                                        validation_split=validation_split)
    eager, eager_launches, _ = _fit(cuda, ae_type, False, state, epochs=epochs,
                                    dropout=dropout, validation_split=validation_split)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(graph.history[key], eager.history[key], rtol=1e-6,
                                   err_msg=key)
    assert graph.history["lr"] == eager.history["lr"]
    assert graph.capture_s is not None and eager.capture_s is None
    family = "zinb" if ae_type.startswith("zinb") else "nb"
    warm = 1 + (rem > 0)
    steps = n_full + (rem > 0)
    want = dict.fromkeys([*fused_loss.launches, "rmsprop"], 0)
    want[f"{family}_nll_fwd"] = epochs * (steps + 1)  # a K1 a step, one for validation
    want[f"{family}_nll_bwd"] = want["rmsprop"] = epochs * steps
    assert eager_launches == want
    for key in (f"{family}_nll_fwd", f"{family}_nll_bwd", "rmsprop"):
        want[key] += warm
    assert graph_launches == want


@pytest.mark.gpu
def test_graph_nodes_are_the_device_operations_of_a_replay(cuda, tmp_path):
    """The nodes of the full step's graph, as the kernel library counts them
    at its capture (``graphs.nodes``, ``graphs.last_nodes``), are the
    kernels, copies and memsets that one
    profiled replay of that graph runs, RMSprop's update among them as one
    kernel; a replay is counted as one (``graphs.replays``)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from dca_tpu_torch import timeline
    from dca_tpu_torch.train import graphs as G

    adata = io.normalize(io.read_dataset(AnnData(_small_counts(200, 300, 6))))
    X = torch.from_numpy(np.array(adata.X, np.float32)).to(cuda)
    T = torch.from_numpy(np.array(adata.raw.X, np.float32)).to(cuda)
    SF = torch.from_numpy(np.array(adata.obs.size_factors, np.float32)).to(cuda)
    opt = optim.get_optimizer("RMSprop", clipvalue=5.0)
    net = get_ae_type("zinb-conddisp")(input_size=300, hidden_size=(64, 32, 64),
                                       device=cuda).build()
    params = list(net.model.parameters())
    opt_state = opt.init(params)
    bufs = StepBuffers.create(200, 64, 1e-3, cuda)
    train_step = make_sharded_train_step(net, opt)

    def step(trailing=False):
        train_step(X, T, SF, bufs, opt_state, None, trailing)

    written = params + list(net.model.buffers()) + opt_state["a"]
    with timeline.recording() as rec:
        run = GraphEpoch(step, bufs, 8, written, torch.Generator(device=cuda))
        run.start(np.random.RandomState(1).permutation(200))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run.steps.replay(False)
            torch.cuda.synchronize()
    path = str(tmp_path / "replay.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = sum(e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              for e in events)
    # the optimizer's update is one node: K5 over the 15 leaves
    assert sum(e.get("ph") == "X" and e.get("cat") == "kernel"
               and "rmsprop_kernel" in e.get("name", "") for e in events) == 1
    nodes = {c.attrs["kind"]: c for c in rec.counted("graphs.nodes")}
    assert nodes["full"].n > 0 and nodes["full"].n == ops
    assert G.last_nodes["full"] == nodes["full"].n
    assert G.last_nodes["trailing"] == nodes["trailing"].n > 0
    assert nodes["full"].attrs["kernels"] > 0 and nodes["full"].attrs["other"] == 0
    assert [(c.n, c.attrs["key"]) for c in rec.counted("graphs.replays")] == [(1, "False")]


@pytest.mark.gpu
def test_the_whole_epoch_graph_counts_its_nodes(cuda, monkeypatch, tmp_path):
    """``compiled=True`` on the card: the whole-epoch graph's kernel, copy
    and memset nodes, its IF node's body's included, are as many as the
    device operations that its first replay (the condition true: the body
    runs) runs under the profiler, and its other node is the IF node.  The
    card runs the body's copies as kernels, so the profiler's split
    differs from the nodes'.  The sum of its replays' ``dca.fit.replay``
    spans is ``enqueue_s``, its read-back a ``dca.fit.fetch``."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from dca_tpu_torch import timeline
    from dca_tpu_torch.train import compiled
    from dca_tpu_torch.train import graphs as G

    traces = []

    class Profiled(compiled.GraphFit):
        def _replay(self):
            if traces:
                return super()._replay()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                super()._replay()
                torch.cuda.synchronize()
            path = str(tmp_path / "epoch.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                traces.append(json.load(f)["traceEvents"])

    monkeypatch.setattr(compiled, "GraphFit", Profiled)
    adata = io.normalize(io.read_dataset(AnnData(_small_counts(200, 300, 6))))
    net = get_ae_type("nb-conddisp")(input_size=300, hidden_size=(64, 32, 64),
                                     device=cuda).build()
    with timeline.recording() as rec:
        hist = train(adata, net, epochs=3, batch_size=64, verbose=False, compiled=True)
    (epoch,) = [c for c in rec.counted("graphs.nodes") if c.attrs["kind"] == "epoch"]
    assert epoch.n == G.last_nodes["epoch"] > 0
    ops = {cat: sum(e.get("ph") == "X" and e.get("cat") == cat for e in traces[0])
           for cat in ("kernel", "gpu_memcpy", "gpu_memset")}
    counted = {k: epoch.attrs[k] for k in ("kernels", "copies", "memsets", "other")}
    assert sum(ops.values()) == counted["kernels"] + counted["copies"] + counted["memsets"], (
        ops, counted)
    assert counted["kernels"] > 0 and counted["other"] == 1, counted
    assert hist.fit.enqueue_s == sum(s.dur for s in rec.named("dca.fit.replay"))
    assert len(rec.named("dca.fit.replay")) == 3 and len(rec.named("dca.fit.fetch")) == 1
    assert hist.fit.capture_s == rec.named("dca.graphs.capture")[0].dur


@pytest.mark.gpu
def test_the_epoch_is_tiled_and_timed_on_the_card(cuda):
    """The fit replayed from graphs under the recorder: each epoch's leaf
    spans tile it, ``epoch_s`` is its spans' durations, and its device span
    (CUDA events from its first operation to its validation's last) lies
    within it; one replay a step is counted."""
    from dca_tpu_torch import timeline

    adata = io.normalize(io.read_dataset(AnnData(_small_counts(400, 300, 5))))
    net = get_ae_type("nb-conddisp")(input_size=300, hidden_size=(64, 32, 64),
                                     device=cuda).build()
    with timeline.recording() as rec:
        hist = train(adata, net, epochs=3, batch_size=32, verbose=False)
    epochs = rec.named("dca.fit.epoch")
    assert [s.dur for s in epochs] == hist.epoch_s
    device = rec.named("dca.fit.device")
    assert [s.epoch for s in device] == [0, 1, 2]
    for ep, dev in zip(epochs, device):
        leaves = [s for s in rec.spans if s.epoch == ep.epoch and s.name in (
            "dca.fit.perm", "dca.fit.steps", "dca.fit.validation", "dca.fit.fetch")]
        assert leaves[0].t0 == ep.t0 and leaves[-1].t1 == ep.t1
        assert 0 < dev.dur < ep.dur
    replays = [c.n for c in rec.counted("graphs.replays")]
    assert replays == [11, 1] * 3  # 360 training rows: 11 full steps and a trailing one


@pytest.mark.gpu
def test_graph_epoch_with_only_a_trailing_step(cuda):
    """A batch longer than the split: no full step, only the trailing graph
    (``train`` cuts the batch to the split and never forms this).  Its
    replays give the eager epoch's losses and parameters, bit for bit."""
    adata = io.normalize(io.read_dataset(AnnData(_small_counts(40, 300, 6))))
    X = torch.from_numpy(np.array(adata.X, np.float32)).to(cuda)
    T = torch.from_numpy(np.array(adata.raw.X, np.float32)).to(cuda)
    SF = torch.from_numpy(np.array(adata.obs.size_factors, np.float32)).to(cuda)
    opt = optim.get_optimizer("RMSprop", clipvalue=5.0)
    results = []
    state = None
    for graphs in (True, False):
        net = get_ae_type("zinb-conddisp")(input_size=300, hidden_size=(64, 32, 64),
                                           device=cuda).build()
        if state is None:
            state = {k: v.clone() for k, v in net.model.state_dict().items()}
        net.model.load_state_dict(state)
        params = list(net.model.parameters())
        opt_state = opt.init(params)
        bufs = StepBuffers.create(40, 64, 1e-3, cuda)
        train_step = make_sharded_train_step(net, opt)

        def step(trailing=False):
            train_step(X, T, SF, bufs, opt_state, None, trailing)

        if graphs:
            written = params + list(net.model.buffers()) + opt_state["a"]
            run = GraphEpoch(step, bufs, 40, written, torch.Generator(device=cuda))
            assert list(run.graphs) == [True]
        else:
            run = EagerEpoch(step, bufs, 40)
        for seed in (1, 2):
            run(np.random.RandomState(seed).permutation(40))
        torch.cuda.synchronize()
        results.append((bufs.losses.clone(), bufs.step_i.clone(),
                        [p.detach().clone() for p in params]))
    (lg, ig, pg), (le, ie, pe) = results
    assert ig.tolist() == ie.tolist() == [0]
    assert torch.equal(lg, le)
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))


@pytest.mark.gpu
def test_failing_capture_raises_and_does_not_fit_eagerly(cuda, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    fit raises the CUDA error, it does not fall back to the eager loop.  The
    warm-ups ran and were undone: the weights are the initial ones, and
    nothing but the two warm-up steps was launched."""
    adata = io.normalize(io.read_dataset(AnnData(_small_counts(400, 300, 5))))
    net = get_ae_type("nb-conddisp")(input_size=300, hidden_size=(64, 32, 64),
                                     device=cuda).build()
    before = {k: v.clone() for k, v in net.model.state_dict().items()}
    loss_fn = net.loss_fn

    def reads_back(*args, **kwargs):
        loss, new_state = loss_fn(*args, **kwargs)
        loss.item()  # a device-to-host copy and a synchronization
        return loss, new_state

    monkeypatch.setattr(net, "loss_fn", reads_back)
    fused_loss.reset_launches()
    with pytest.raises(RuntimeError):
        train(adata, net, epochs=2, verbose=False)
    torch.cuda.synchronize()
    assert fused_loss.launches["nb_nll_fwd"] == 2 and fused_loss.launches["nb_nll_bwd"] == 2
    for k, v in net.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the card is usable after the failed capture
    assert torch.ones(3, device=cuda).sum().item() == 3.0


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("optimizer,activation", OPTIONS, ids=[f"{o}-{a}" for o, a in OPTIONS])
def test_options_graph_fit_matches_eager_fit_on_card(cuda, optimizer, activation, dropout):
    """Every optimizer, and PReLU, is graph-safe: the fit replayed from CUDA
    graphs gives the eager fit's history bit for bit (its state written in
    place, the step count on the device, the warm-up's two steps undone),
    the step count after the fit is the steps taken, and the launches are
    the eager fit's plus the two warm-ups."""
    epochs, n_cells = 3, 200
    graph, graph_launches, graph_opt, state = options_fit(optimizer, activation, "cuda", True,
                                                          epochs=epochs, dropout=dropout)
    eager, eager_launches, eager_opt, _ = options_fit(optimizer, activation, "cuda", False,
                                                      state, epochs=epochs, dropout=dropout)
    for key in ("loss", "val_loss", "lr"):
        assert graph.history[key] == eager.history[key], key
    steps = _steps(n_cells)
    if optimizer in STEP_COUNTED:
        assert int(graph_opt["t"]) == int(eager_opt["t"]) == epochs * steps
    assert eager_launches == _want_launches("zinb", epochs, steps)
    assert graph_launches == _want_launches("zinb", epochs, steps, _warmups(n_cells))


def _forward_outputs(cuda, activation="relu", n_cells=700, n_genes=300):
    adata = io.normalize(io.read_dataset(AnnData(_small_counts(n_cells, n_genes, 9))))
    net = get_ae_type("zinb-conddisp")(input_size=n_genes, hidden_size=(64, 32, 64),
                                       activation=activation, device=cuda).build()
    return net, np.asarray(adata.X, np.float32), io.size_factors(adata)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [network.FETCH_CHUNK_BYTES, 4098], ids=["ring", "odd-chunks"])
def test_pinned_fetch_same_bits_as_pageable_on_card(cuda, monkeypatch, chunk):
    """fetch_to_host copies every output through the page-locked ring: the
    bits of a pageable copy, in float32 arrays of pageable memory, also
    with chunks that split the outputs and their floats at odd offsets;
    under DCA_TPU_FETCH_DTYPE=bf16 the bits of the downcast pageable copy."""
    monkeypatch.setattr(network, "FETCH_CHUNK_BYTES", chunk)
    net, x, sf = _forward_outputs(cuda)
    with torch.no_grad():
        out, _ = net.apply(torch.tensor(x, device=cuda), torch.tensor(sf, device=cuda))
    got = fetch_to_host(out)
    assert sorted(got) == sorted(out)
    for k, v in out.items():
        if v is None:
            assert got[k] is None
            continue
        want = v.cpu().numpy()
        assert got[k].dtype == np.float32 and got[k].shape == want.shape, k
        assert np.array_equal(got[k].view(np.uint32), want.view(np.uint32)), k
        assert not torch.from_numpy(got[k]).is_pinned(), k
    monkeypatch.setenv("DCA_TPU_FETCH_DTYPE", "bf16")
    low = fetch_to_host({"mean": out["mean"]})["mean"]
    np.testing.assert_array_equal(low, out["mean"].bfloat16().cpu().float().numpy())


@pytest.mark.gpu
def test_pipelined_blocks_keep_their_arrays_on_card(cuda, monkeypatch):
    """The pipelined block forward queues block k+1 while block k is
    fetched: every block's arrays, all held until the end, keep the bits of
    the serial forward's (DCA_TPU_PREFETCH=0), and agree with the forward
    of the whole matrix in one block."""
    net, x, sf = _forward_outputs(cuda)
    held = list(net.iter_forward_blocks(x, sf, chunk_rows=128))
    assert [(lo, hi) for lo, hi, _ in held] == [(i, min(i + 128, 700))
                                                for i in range(0, 700, 128)]
    monkeypatch.setenv("DCA_TPU_PREFETCH", "0")
    serial = list(net.iter_forward_blocks(x, sf, chunk_rows=128))
    for (lo, hi, a), (_, _, b) in zip(held, serial):
        for k, v in b.items():
            if v is not None:
                assert np.array_equal(a[k].view(np.uint32), v.view(np.uint32)), (lo, k)
    whole = net.forward(x, sf)  # one block: the products may round otherwise
    for k, v in whole.items():
        if v is not None:
            np.testing.assert_allclose(np.concatenate([b[k] for _, _, b in held]), v,
                                       rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.gpu
def test_block_forward_pins_no_more_than_the_ring_on_card(cuda):
    """However many blocks the caller holds, the pipelined block forward
    page-locks nothing beyond the fetch ring's two chunks, made at the
    first fetch; the arrays it hands out are pageable."""
    net, x, sf = _forward_outputs(cuda)
    fetch_to_host({"x": torch.zeros(1, device=cuda)})
    ring = network._ring(network.FETCH_CHUNK_BYTES)
    assert [c.numel() for c in ring] == [network.FETCH_CHUNK_BYTES] * 2
    assert all(c.is_pinned() for c in ring)
    torch.cuda.reset_peak_host_memory_stats()
    base = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    held = list(net.iter_forward_blocks(x, sf, chunk_rows=128))
    stats = torch.cuda.host_memory_stats()
    assert len(held) > 2
    assert stats["allocated_bytes.peak"] == stats["allocated_bytes.current"] == base
    for _, _, b in held:
        for a in b.values():
            assert a is None or not torch.from_numpy(a).is_pinned()


@pytest.mark.gpu
@pytest.mark.parametrize("activation,k4,splitk", [("relu", 4, 1), ("PReLU", 3, 0)])
def test_prelu_never_takes_k4_on_card(cuda, monkeypatch, activation, k4, splitk):
    """With K4 switched on, a PReLU network launches it for the dense heads
    alone (no hidden layer: K4 has no epilogue for a trainable alpha); a
    relu one for the encoder too.  The outputs agree with the switch off."""
    net, x, sf = _forward_outputs(cuda, activation)
    off = net.forward(x, sf)
    monkeypatch.setenv("DCA_TPU_FUSED_DENSE", "1")
    fused_dense.reset_launches()
    on = net.forward(x, sf)
    assert fused_dense.launches["fused_dense"] == k4
    assert fused_dense.launches["splitk"] == splitk
    for k, v in off.items():
        if v is not None:
            np.testing.assert_allclose(on[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the streaming trainer on the card
# ---------------------------------------------------------------------------

STREAM_ENV = ("DCA_TPU_DEVICE_DENSIFY", "DCA_TPU_DERIVE_INPUT", "DCA_TPU_PAYLOAD",
              "DCA_TPU_RESIDENT", "DCA_TPU_PREFETCH")
STREAM_TIERS = {"host": {"DCA_TPU_DEVICE_DENSIFY": "0"},
                "flat": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
                         "DCA_TPU_PAYLOAD": "flat"},
                "resident": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_RESIDENT": "1"}}


def _stream_env(monkeypatch, env):
    for k in STREAM_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _lazy_counts(n_cells=200, n_genes=60):
    import scipy.sparse as sp

    return io.normalize(io.read_dataset(AnnData(sp.csr_matrix(_small_counts(n_cells, n_genes,
                                                                             3)))),
                        lazy_scale=True)


def _stream_fit(cuda, state, graphs=True, max_cells=64, epochs=2):
    """zinb-conddisp (16, 8, 16) on 200 x 60, parts of 64 cells: 64, 64
    and 32 full rows and a 20-row trailing part, then the 20 validation
    rows."""
    from chip_smoke import _stream_schedule, _want_stream_launches

    net = get_ae_type("zinb-conddisp")(input_size=60, hidden_size=(16, 8, 16),
                                       hidden_dropout=0.1, device=cuda).build()
    net.model.load_state_dict(state)
    fused_loss.reset_launches()
    hist = train(_lazy_counts(), net, epochs=epochs, verbose=False, _graphs=graphs,
                 max_device_cells=max_cells)
    if max_cells is not None:
        want = _want_stream_launches(epochs, 200, max_cells)
        if not graphs:  # no warm-up steps
            n_graphs = _stream_schedule(200, max_cells)[2]
            want["zinb_nll_fwd"] -= n_graphs
            want["zinb_nll_bwd"] -= n_graphs
        assert dict(fused_loss.launches) == want
    return hist


@pytest.fixture
def stream_state(cuda):
    net = get_ae_type("zinb-conddisp")(input_size=60, hidden_size=(16, 8, 16),
                                       device=cuda).build()
    return {k: v.clone() for k, v in net.model.state_dict().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["padded", "flat", "flat8"])
@pytest.mark.parametrize("scaled", [False, True])
def test_device_scatters_equal_densify_rows_on_card(cuda, kind, scaled):
    """Each device scatter, with and without the fused z-scale, the bits of
    the host tier's ``native.densify_rows`` (then the z-scale in float32)."""
    from dca_tpu_torch import native
    from dca_tpu_torch.data.loader import Flat8Chunk
    from dca_tpu_torch.ops import densify as dz

    adata = _lazy_counts(300, 200)
    M = adata.X if scaled else adata.raw.X
    mean, std = io.scale_stats(adata)
    rows = np.random.RandomState(4).permutation(300)[:150]
    want = native.densify_rows(M.indptr, M.indices, M.data, rows, 200)
    sc = (None, None)
    if scaled:
        want = (want - mean) / std
        sc = (torch.from_numpy(mean).to(cuda), torch.from_numpy(std).to(cuda))
    L = dz.flat_slots_for(M, rows)
    if kind == "padded":
        got = dz.device_densify(*dz.payload_from_csr(M, rows, int_vals=not scaled), 200, *sc,
                                device=cuda)
    elif kind == "flat":
        got = dz.device_densify_flat(*dz.flat_payload_from_csr(M, rows, L, int_vals=not scaled),
                                     150, 200, *sc, device=cuda)
    else:
        got = dz.device_densify_flat8(Flat8Chunk(*dz.flat8_payload_from_csr(M, rows, L, L, L),
                                                 150, 200), *sc, device=cuda)
    assert got.is_cuda
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", list(STREAM_TIERS))
def test_streamed_graph_fit_same_bits_as_eager_on_card(cuda, monkeypatch, stream_state, tier):
    """A streamed fit replayed from the CUDA graphs gives its eager fit's
    history bit for bit, dropout 0.1 included, each with its exact K1/K2
    launches; the host and payload tiers also give the in-memory graph
    fit's history."""
    _stream_env(monkeypatch, STREAM_TIERS[tier])
    graph = _stream_fit(cuda, stream_state)
    eager = _stream_fit(cuda, stream_state, graphs=False)
    assert graph.capture_s is not None and eager.capture_s is None
    assert graph.history == eager.history
    if tier != "resident":
        assert graph.history == _stream_fit(cuda, stream_state, max_cells=None).history


@pytest.mark.gpu
@pytest.mark.parametrize("delay", ["staging", "replays"])
def test_part_buffers_not_overwritten_while_read_on_card(cuda, monkeypatch, stream_state,
                                                         delay):
    """A staged part is never read before its writes end, nor overwritten
    while a replay still reads it: with ~10 ms of device time injected
    before each staging write, or before each replay, on its stream (and
    two parts prefetched), the history keeps the bits of the undelayed
    fit."""
    from dca_tpu_torch.train import graphs as graphs_mod
    from dca_tpu_torch.train import loop

    _stream_env(monkeypatch, {**STREAM_TIERS["flat"], "DCA_TPU_PREFETCH": "2"})
    want = _stream_fit(cuda, stream_state).history
    if delay == "staging":
        real = loop.device_densify_flat

        def slow(*a, **k):
            torch.cuda._sleep(20_000_000)
            return real(*a, **k)

        monkeypatch.setattr(loop, "device_densify_flat", slow)
    else:
        real = graphs_mod.GraphSteps.replay

        def slow(self, key, times=1):
            torch.cuda._sleep(20_000_000)
            return real(self, key, times)

        monkeypatch.setattr(graphs_mod.GraphSteps, "replay", slow)
    assert _stream_fit(cuda, stream_state).history == want


# ---------------------------------------------------------------------------
# the fit's artefacts: checkpoints, TensorBoard, loaded weights
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["in_memory", "streaming"])
def test_resumed_graph_fit_is_the_uninterrupted_fit_on_card(cuda, tmp_path, where):
    """At dropout 0.1, through the CUDA graphs: 2 epochs with checkpoints,
    then resume=True to 4, give the uninterrupted fit's epochs 3-4 and final
    parameters bit for bit: the dropout generator's state, read after
    replays and set before the capture, carries the masks across."""
    adata = io.normalize(io.read_dataset(AnnData(_small_counts(400, 300, 5))))
    kw = dict(verbose=False, max_device_cells=128 if where == "streaming" else None)
    state = None
    nets, hists = [], []
    for epochs, resume, out in ((4, False, None), (2, False, "run"), (4, True, "run")):
        net = get_ae_type("zinb-conddisp")(input_size=300, hidden_size=(64, 32, 64),
                                           hidden_dropout=0.1, device=cuda).build()
        if state is None:
            state = {k: v.clone() for k, v in net.model.state_dict().items()}
        net.model.load_state_dict(state)
        extra = {} if out is None else dict(output_dir=str(tmp_path / out), checkpoint_every=1,
                                            resume=resume)
        hist = train(adata, net, epochs=epochs, **kw, **extra)
        assert hist.capture_s is not None
        nets.append(net)
        hists.append(hist)
    assert hists[2].restore_s is not None
    for key in ("loss", "val_loss", "lr"):
        assert hists[2].history[key] == hists[0].history[key][2:], key
    for k, v in nets[0].model.state_dict().items():
        assert torch.equal(nets[2].model.state_dict()[k], v), k


@pytest.mark.gpu
def test_tb_graph_fit_same_bits_as_plain_fit_on_card(cuda, tmp_path):
    """tensorboard=True trains as the fit without it through the graphs, at
    dropout 0.1; its gradients add one K1 and one K2 an epoch, eagerly."""
    epochs = 3
    plain, plain_launches, state = _fit(cuda, "zinb-conddisp", True, epochs=epochs,
                                        dropout=0.1)
    tb, tb_launches, _ = _fit(cuda, "zinb-conddisp", True, state, epochs=epochs, dropout=0.1,
                              output_dir=str(tmp_path), tensorboard=True)
    assert tb.history == plain.history
    want = dict(plain_launches)
    want["zinb_nll_fwd"] += epochs
    want["zinb_nll_bwd"] += epochs
    assert tb_launches == want
    assert len(tb.tb_s) == epochs


@pytest.mark.gpu
@pytest.mark.parametrize("rows,weighted", [(273, False), (137, True)], ids=["K2", "K2w"])
def test_tb_gradients_through_k2_match_plain_version_on_card(cuda, rows, weighted):
    """The TensorBoard gradient of zinb-conddisp 64-32-64 at the validation
    shapes of phase 4 (273 rows) and of a rank of phase 7 (137 rows, the
    last at weight 0): one K2 or K2w launch, held against its plain version
    on the same tensors at K2's tolerance."""
    from dca_tpu_torch.train.loop import _tb_grads

    G = 3451
    net = get_ae_type("zinb-conddisp")(input_size=G, hidden_size=(64, 32, 64),
                                       device=cuda).build()
    rs = np.random.RandomState(rows)
    y = rs.negative_binomial(2, 0.4, size=(rows, G)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.7] = 0.0
    x = torch.from_numpy(np.log1p(y)).to(cuda)
    sf = torch.from_numpy(rs.uniform(0.5, 2.0, rows).astype(np.float32)).to(cuda)
    w = None
    if weighted:
        w = torch.ones(rows, device=cuda)
        w[-1] = 0.0
    name = "zinb_nll_bwd" + ("_w" if weighted else "")
    before = dict(fused_loss.launches)
    with recording_k2() as calls:
        grads = _tb_grads(net, x, sf, torch.from_numpy(y).to(cuda), w)
    assert fused_loss.launches[name] == before[name] + 1 and len(calls) == 1
    assert check_k2_call(name, *calls[0]) <= 1.0
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


@pytest.mark.gpu
def test_load_weights_reaches_a_graph_captured_before_on_card(cuda, tmp_path):
    """load_weights copies into the parameters in place: a forward captured
    in a CUDA graph before the load replays on the loaded weights, the
    same bits as the saving network's forward."""
    pytest.importorskip("h5py", reason="weights.hdf5 needs h5py, as in the JAX package")
    src = get_ae_type("zinb-conddisp")(input_size=300, hidden_size=(64, 32, 64), seed=1,
                                       device=cuda).build()
    dst = get_ae_type("zinb-conddisp")(input_size=300, hidden_size=(64, 32, 64), seed=2,
                                       device=cuda).build()
    path = str(tmp_path / "weights.hdf5")
    src.save_weights(path)
    x = torch.from_numpy(np.log1p(_small_counts(64, 300, 3))).to(cuda)
    sf = torch.ones(64, device=cuda)
    with torch.no_grad():
        want = src.apply(x, sf)[0]["output"].clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dst.apply(x, sf)  # warm-up: cuBLAS's handle
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = dst.apply(x, sf)[0]["output"]
    dst.load_weights(path)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _solo_or_concurrent_fit(cuda, adata, ae_type, dropout, stream=None, **kw):
    """A 3-epoch graph fit of ``ae_type`` on ``adata`` (``kw``: more of
    ``train``'s keywords); on ``stream`` when given.  Returns its history
    and its final parameters and buffers."""
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        net = get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                   hidden_dropout=dropout, seed=3, device=cuda).build()
        hist = train(adata, net, epochs=3, verbose=False, seed=5, **kw)
        state = {k: v.detach().cpu() for k, v in net.model.state_dict().items()}
    return hist.history, state


def _two_threads(cuda, rounds, **kw):
    """The two fits of the two-thread tests, alone and then ``rounds``
    times at once: each gives its solo bits, and the launch counters the
    sum of the two solo fits' launches."""
    import sys
    import threading

    adata = io.normalize(io.read_dataset(AnnData(_small_counts(1000, 300, 9))))
    cases = [("zinb-conddisp", 0.1), ("nb-conddisp", 0.0)]
    solo, solo_launches = [], []

    def counted():
        return {**fused_loss.launches, **fused_optim.launches}

    for ae_type, dropout in cases:
        fused_loss.reset_launches()
        fused_optim.reset_launches()
        solo.append(_solo_or_concurrent_fit(cuda, adata, ae_type, dropout, **kw))
        torch.cuda.synchronize()
        solo_launches.append(counted())
    want = {k: sum(d[k] for d in solo_launches) for k in counted()}
    assert want["zinb_nll_fwd"] > 0 and want["nb_nll_fwd"] > 0 and want["rmsprop"] > 0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(rounds):
            fused_loss.reset_launches()
            fused_optim.reset_launches()
            results, errors = [None, None], []
            start = threading.Barrier(2)

            def run(i):
                try:
                    start.wait(timeout=60)
                    results[i] = _solo_or_concurrent_fit(cuda, adata, *cases[i],
                                                         stream=torch.cuda.Stream(cuda), **kw)
                except Exception as e:  # reported below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            torch.cuda.synchronize()
            assert counted() == want
            for (hist, state), (s_hist, s_state) in zip(results, solo):
                assert hist == s_hist
                assert all(torch.equal(state[k], s_state[k]) for k in s_state)
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [2])
def test_two_fits_in_two_threads_give_their_solo_bits_on_card(cuda, rounds):
    """Two graph fits (zinb-conddisp at dropout 0.1, nb-conddisp) run at
    once in two threads, each on a stream of its own, as the
    hyperparameter search's trials run: each gives the bits it gives alone,
    and the launch counters the sum of the two solo fits' launches, exactly
    (their K1 workspaces, captures and tallies kept apart).  The switch
    interval is shortened so that the threads interleave finely."""
    _two_threads(cuda, rounds)


@pytest.mark.gpu
def test_two_compiled_fits_in_two_threads_give_their_solo_bits_on_card(cuda):
    """The same with compiled=True: each thread captures its whole-fit
    graph (its IF node's body on a stream of its own) and replays it."""
    _two_threads(cuda, 2, compiled=True)


@pytest.mark.gpu
def test_k1_at_the_trial_validation_shape_matches_plain_version_on_card(cuda):
    """ZINB K1 at (546, 3451), the 20% validation of a hyperparameter
    trial at 2730 cells, with the trial's ridge: loss rel err <= 1e-5 and
    the count exact against the plain version on the same tensors."""
    y, mu, th, pi = _big_loss_inputs(cuda, 546, 3451)
    got = fused_loss._fwd_out_kernel(y, mu, th, pi, 0.01)
    ref = fused_loss._fwd_out_reference(y, mu, th, pi, 0.01)
    assert abs(got[2].item() - ref[2].item()) <= LOSS_RTOL * abs(ref[2].item())
    assert got[1].item() == ref[1].item()


# ---------------------------------------------------------------------------
# the whole fit on the device (compiled=True)
# ---------------------------------------------------------------------------


def _compiled_fit(cuda, ae_type, graphs, state=None, dropout=0.1, epochs=3, **kw):
    """A compiled=True (64, 32, 64) fit on 400 cells x 300 genes; returns
    (History, the launches of the loss kernels and graph_if, the final
    state, the initial state)."""
    from dca_tpu_torch.ops import conditional

    adata = io.normalize(io.read_dataset(AnnData(_small_counts(400, 300, 5))))
    net = get_ae_type(ae_type)(input_size=300, hidden_size=(64, 32, 64),
                               hidden_dropout=dropout, device=cuda).build()
    if state is None:
        state = {k: v.clone() for k, v in net.model.state_dict().items()}
    net.model.load_state_dict(state)
    fused_loss.reset_launches()
    fused_optim.reset_launches()
    conditional.reset_launches()
    hist = train(adata, net, epochs=epochs, verbose=False, compiled=True, _graphs=graphs, **kw)
    torch.cuda.synchronize()
    final = {k: v.detach().clone() for k, v in net.model.state_dict().items()}
    return hist, {**fused_loss.launches, **fused_optim.launches, **conditional.launches}, \
        final, state


def _want_compiled(family, ran, steps, replays):
    """The launches of a whole-fit graph: one warm-up epoch and each epoch
    run (a K1 a step and one for the validation, a K2 and a K5 a step),
    and the IF node's kernel at every replay."""
    want = dict.fromkeys(list(fused_loss.launches) + ["rmsprop", "graph_if"], 0)
    want[f"{family}_nll_fwd"] = (ran + 1) * (steps + 1)
    want[f"{family}_nll_bwd"] = want["rmsprop"] = (ran + 1) * steps
    want["graph_if"] = replays
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("ae_type", ["nb-conddisp", "zinb-conddisp"])
def test_compiled_graph_fit_matches_compiled_eager_fit_on_card(cuda, ae_type, dropout):
    """The whole-fit graph and the same fit from Python on the card
    (``_graphs=False``), from the same weights and seed: the same bits in
    the histories, the epochs run and the final state (the registered
    generator gives each replay the eager epoch's dropout masks); the
    graph's launches one warm-up epoch more than the epochs run, and one
    graph_if a replay."""
    graph, launches, final, state = _compiled_fit(cuda, ae_type, True, dropout=dropout)
    eager, _, e_final, _ = _compiled_fit(cuda, ae_type, False, state, dropout=dropout)
    assert graph.history == eager.history
    assert graph.fit.epochs_run == eager.fit.epochs_run == 3
    assert graph.capture_s is not None and eager.capture_s is None
    assert all(torch.equal(final[k], e_final[k]) for k in final)
    assert launches == _want_compiled(ae_type.split("-")[0], 3, 12, 3)


STOP = dict(epochs=100, early_stop=1, reduce_lr=0, learning_rate=0.05)


@pytest.mark.gpu
def test_an_epoch_after_the_stop_changes_nothing_on_card(cuda, monkeypatch):
    """An early-stopped whole-fit graph: after the fit, three more replays
    (the flag set, each an epoch after the stop) leave every tensor the
    epoch writes as it was, bit for bit; the history is NaN past the stop
    and the fit the same fit from Python's bits."""
    from dca_tpu_torch.train import compiled

    runners = []

    class Recording(compiled.GraphFit):
        def __init__(self, body, state, *args, **kwargs):
            super().__init__(body, state, *args, **kwargs)
            runners.append((self, list(state)))

    monkeypatch.setattr(compiled, "GraphFit", Recording)
    graph, _, final, state = _compiled_fit(cuda, "zinb-conddisp", True, **STOP)
    n_run = graph.fit.epochs_run
    assert n_run < STOP["epochs"] and len(graph.fit.after_stop_s) == STOP["epochs"] - n_run
    assert np.isnan(graph.fit.loss[n_run:]).all() and np.isnan(graph.fit.val_loss[n_run:]).all()
    (runner, written), = runners
    before = [t.detach().clone() for t in written]
    for _ in range(3):
        runner.graph.replay()
    torch.cuda.synchronize()

    def same_bits(a, b):  # NaN histories included
        return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))

    assert all(same_bits(t, b) for t, b in zip(written, before))
    eager, _, e_final, _ = _compiled_fit(cuda, "zinb-conddisp", False, state, **STOP)
    assert graph.history == eager.history and eager.fit.epochs_run == n_run
    assert all(torch.equal(final[k], e_final[k]) for k in final)


@pytest.mark.gpu
def test_the_launch_tally_counts_only_the_epochs_run_on_card(cuda):
    """The whole-fit graph of an early-stopped fit credits the loss
    kernels' launches for the epochs run and the warm-up alone, never for
    a replay after the stop; graph_if once a replay."""
    graph, launches, _, _ = _compiled_fit(cuda, "nb-conddisp", True, dropout=0.0, **STOP)
    n_run = graph.fit.epochs_run
    assert n_run < STOP["epochs"]
    assert launches == _want_compiled("nb", n_run, 12, STOP["epochs"])


@pytest.mark.gpu
def test_graph_if_matches_plain_version_on_card(cuda):
    """The IF node's kernel (csrc/graph_if.cu) against its plain version
    over replays with the flag false and true: each body runs exactly
    where ``conditional.if_reference`` is true."""
    from chip_smoke import graph_if_graph
    from dca_tpu_torch.ops import conditional

    graph, stop, counts = graph_if_graph(cuda, 4)
    want = torch.zeros_like(counts)
    for flag in (True, False, False, True, False):
        stop.fill_(flag)
        graph.replay()
        want += conditional.if_reference(stop).float()
    torch.cuda.synchronize()
    assert torch.equal(counts, want) and float(want[0]) == 3.0
    with pytest.raises(ValueError, match="bool CUDA flag"):
        with conditional.if_body(torch.zeros(1, dtype=torch.bool), None, None, None):
            pass


@pytest.mark.gpu
@pytest.mark.parametrize("case", RMSPROP_CASES, ids=[c[0] for c in RMSPROP_CASES])
def test_rmsprop_kernel_same_bits_as_plain_loop_on_card(cuda, case):
    """K5 and the plain loop (``optim._rmsprop_loop``) from the same state,
    20 updates on the same gradients, the rate cut halfway: the same bits
    after every update, at the 13 and 15 leaves of nb-conddisp and
    zinb-conddisp, at odd sizes (1, 3, 3451, 1725, 862) on fresh tensors
    and on misaligned views into flat buffers, and with gradients of
    +-inf, NaN, exactly +-5 and past it, clipped and not
    (``chip_smoke.check_rmsprop_case``)."""
    name, leaves, layout, specials, clip, lr_kind = case
    assert check_rmsprop_case(cuda, leaves, layout, specials, clip, lr_kind,
                              seed=len(name)) > 0


@pytest.mark.gpu
def test_rmsprop_kernel_in_a_graph_reads_the_rewritten_rate_on_card(cuda):
    """K5 captured in a CUDA graph and replayed on new gradients, the rate
    rewritten in place before each replay (as ReduceLROnPlateau does
    between epochs): each replay the plain loop's bits at that rate."""
    shapes = rmsprop_shapes("zinb-conddisp")
    rs = np.random.RandomState(3)
    p0 = [rs.normal(size=sh).astype(np.float32) for sh in shapes]
    kp, pp = _placed_leaves(cuda, p0), _placed_leaves(cuda, p0)
    ka = _placed_leaves(cuda, [np.zeros(sh, np.float32) for sh in shapes])
    pa = [a.clone() for a in ka]
    grads = _placed_leaves(cuda, _rmsprop_grads(rs, shapes, False))
    lr = torch.tensor(1e-3, device=cuda)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fused_optim.rmsprop(kp, grads, ka, lr, 5.0)
    torch.cuda.synchronize()
    assert all(bits_equal(a, b) for a, b in zip(kp, pp))  # captured, not run
    for rate in (1e-3, 1e-3, 1e-4, 1e-5, 0.0, 1e-2):
        for g, new in zip(grads, _rmsprop_grads(rs, shapes, False)):
            g.copy_(torch.from_numpy(new))
        lr.fill_(rate)
        graph.replay()
        with torch.no_grad():
            optim._rmsprop_loop(pp, grads, pa, lr, 5.0, 0.9, 1e-7)
        torch.cuda.synchronize()
        assert all(bits_equal(a, b) for a, b in zip(kp + ka, pp + pa)), rate


@pytest.mark.gpu
def test_rmsprop_kernel_raises_on_what_it_does_not_take(cuda):
    """A non-contiguous parameter, a float64 leaf, a rate on the CPU, or
    lists of different lengths: ValueError, nothing launched.  A
    non-contiguous gradient is copied and updated from."""
    p = [torch.randn(8, 6, device=cuda)]
    a = [torch.zeros(8, 6, device=cuda)]
    g = [torch.randn(8, 6, device=cuda)]
    fused_optim.reset_launches()
    for args in (([torch.randn(6, 8, device=cuda).t()], g, a, 1e-3),
                 ([p[0].double()], g, a, 1e-3),
                 (p, g, a, torch.tensor(1e-3)),
                 (p, g + g, a, 1e-3)):
        with pytest.raises(ValueError, match="K5"):
            fused_optim.rmsprop(*args)
    assert fused_optim.launches["rmsprop"] == 0
    gt = torch.randn(6, 8, device=cuda).t()
    twin_p, twin_a = [p[0].clone()], [a[0].clone()]
    fused_optim.rmsprop(p, [gt], a, 1e-3, 5.0)
    optim._rmsprop_loop(twin_p, [gt], twin_a, 1e-3, 5.0, 0.9, 1e-7)
    torch.cuda.synchronize()
    assert bits_equal(p[0], twin_p[0]) and bits_equal(a[0], twin_a[0])
    assert fused_optim.launches["rmsprop"] == 1
