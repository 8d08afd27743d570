"""Fused negative binomial NLL: CUDA kernels K1 (forward) and K2 (backward).

``nb_nll_fused(y, mu, theta)`` is the mean NB NLL over (B, G) float32
tensors with the semantics of ``losses.nb_nll(y, mu, theta, masking=True)``:
NaN targets are evaluated at y = 0 for the terms and left out of the
mean's denominator.  Its gradient is a ``torch.autograd.Function`` whose
forward launches K1 and whose backward launches K2
(``csrc/fused_nb_loss.cu``), with the Stirling ``lgamma``/``digamma`` of
``csrc/special.cuh`` inlined in both.

For a tensor on the CPU the same function runs its plain PyTorch version,
which repeats the kernels' arithmetic (``log1p``, the Stirling functions of
``ops/special.py``, the same masks): that is what the CPU tests hold against
the JAX package.  For a CUDA tensor it launches the kernels or raises.

This slice covers the unweighted NB loss with a full (B, G) theta, the
loss of ``nb-conddisp``.  The ZINB, weighted and broadcast-theta variants of
the JAX package's kernels wait for the next slice (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import torch

from .special import digamma, lgamma

EPS = 1e-10
THETA_CLIP = 1e6

# Launches of each kernel, counted by its wrapper where it launches.
launches = {"nb_nll_fwd": 0, "nb_nll_bwd": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _check(y, mu, theta):
    for name, t in (("y", y), ("mu", mu), ("theta", theta)):
        if t.dtype != torch.float32:
            raise TypeError(f"nb_nll_fused: {name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"nb_nll_fused: {name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nb_nll_fused: {name} must be contiguous")
        if t.device != mu.device:
            raise ValueError("nb_nll_fused: y, mu and theta must be on one device")
    if y.shape != mu.shape or theta.shape != mu.shape:
        raise ValueError(
            "nb_nll_fused: y, mu and theta must all be (B, G); got "
            f"{tuple(y.shape)}, {tuple(mu.shape)}, {tuple(theta.shape)} (a "
            "broadcast theta waits for a later slice, see ROADMAP.md)"
        )
    if mu.numel() == 0:
        raise ValueError("nb_nll_fused: empty input")
    if mu.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nb_nll_fused: unsupported device {mu.device}")


# ---------------------------------------------------------------------------
# plain PyTorch versions: the kernels' arithmetic, elementwise
# ---------------------------------------------------------------------------


def _elem_terms(y, mu, th_raw):
    y0 = torch.where(torch.isnan(y), 0.0, y)
    th = torch.clamp(th_raw, max=THETA_CLIP)
    t1 = lgamma(th + EPS) + lgamma(y0 + 1.0) - lgamma(y0 + th + EPS)
    t2 = (th + y0) * torch.log1p(mu / (th + EPS)) + y0 * (
        torch.log(th + EPS) - torch.log(mu + EPS)
    )
    return t1 + t2


def _elem_grads(y, mu, th_raw):
    y0 = torch.where(torch.isnan(y), 0.0, y)
    th = torch.clamp(th_raw, max=THETA_CLIP)
    th_e = th + EPS
    mu_e = mu + EPS
    thmu = th_e + mu
    dmu = (th + y0) / thmu - y0 / mu_e
    dth = (
        digamma(th_e)
        - digamma(y0 + th_e)
        + torch.log1p(mu / th_e)
        + (th + y0) * (1.0 / thmu - 1.0 / th_e)
        + y0 / th_e
    )
    dth = torch.where(th_raw > THETA_CLIP, 0.0, dth)
    return dmu, dth


def grad_term_magnitudes(y, mu, th_raw):
    """Per element, the sum of the magnitudes of the terms that d mu and
    d theta add up (unscaled).  A float32 evaluation of either formula
    carries a rounding error of a few ulps of it: where y is large and theta
    small, (theta + y) / theta and y / theta nearly cancel.  The checks of
    K2 against its plain version state their tolerance with it."""
    y0 = torch.where(torch.isnan(y), 0.0, y)
    th = torch.clamp(th_raw, max=THETA_CLIP)
    th_e = th + EPS
    thmu = th_e + mu
    mag_mu = (th + y0) / thmu + y0 / (mu + EPS)
    mag_th = (digamma(th_e).abs() + digamma(y0 + th_e).abs() + torch.log1p(mu / th_e)
              + (th + y0) / thmu + (th + y0) / th_e + y0 / th_e)
    return mag_mu, mag_th


def nb_nll_fwd_reference(y, mu, theta):
    """Plain version of K1 and its wrapper: (loss, denom), on any device."""
    total = torch.sum(_elem_terms(y, mu, theta))
    denom = torch.clamp(torch.sum((~torch.isnan(y)).to(torch.float32)), min=1.0)
    return total / denom, denom


def nb_nll_bwd_reference(y, mu, theta, scale):
    """Plain version of K2: (d mu, d theta), each times ``scale``."""
    dmu, dth = _elem_grads(y, mu, theta)
    return dmu * scale, dth * scale


def nb_nll_fused_reference(y, mu, theta):
    """The loss in plain PyTorch with the kernels' math; differentiable by
    autograd, which gives a gradient independent of the analytic one."""
    return nb_nll_fwd_reference(y, mu, theta)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.dca_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def nb_nll_fwd_kernel(y, mu, theta):
    """Launch K1; return (loss, denom) as device scalars.

    Replaces the Pallas kernel ``dca_tpu/ops/fused_loss.py::_fwd_kernel``
    (driven by ``_pallas_fwd``).  Bound on the H100 by memory: it reads y, mu
    and theta once, 3 x 441,728 B = 1.33 MB at the training step's
    (32, 3451), at least 0.40 us at 3.35 TB/s, and 11.3 MB (3.4 us) for the
    (273, 3451) validation split; at these sizes the launch itself is
    likely to dominate.  Design: one pass, a grid-stride loop over a block
    count fixed by n, coalesced loads, the elementwise NLL summed in
    registers, then across the warp by shuffles and across the block
    through shared memory; each block writes one partial sum and one count
    of non-NaN targets, and one torch reduction sums the (2, blocks)
    buffer.  No atomics, so the loss is bit-identical from run to run.  The
    ragged edge is masked by index (i < n); nothing is padded."""
    from ._build import library

    _check(y, mu, theta)
    if not mu.is_cuda:
        raise ValueError("nb_nll_fwd_kernel needs CUDA tensors")
    lib = library()
    n = mu.numel()
    with torch.cuda.device(mu.device):
        partials = torch.empty((2, lib.dca_nb_nll_fwd_grid(n)),
                               device=mu.device, dtype=torch.float32)
        err = lib.dca_nb_nll_fwd(
            y.data_ptr(), mu.data_ptr(), theta.data_ptr(), partials.data_ptr(),
            n, torch.cuda.current_stream(mu.device).cuda_stream,
        )
    _raise_on(lib, err, "nb_nll_fwd_kernel (K1)")
    launches["nb_nll_fwd"] += 1
    sums = partials.sum(dim=1)
    denom = torch.clamp(sums[1], min=1.0)
    return sums[0] / denom, denom


def nb_nll_bwd_kernel(y, mu, theta, scale):
    """Launch K2; return (d mu, d theta), each times ``scale``.

    ``scale`` is a one-element float32 tensor on the device (g / denom),
    passed by pointer as the JAX package passes it in SMEM: nothing is read
    back to the host.  Replaces the Pallas kernel
    ``dca_tpu/ops/fused_loss.py::_bwd_kernel`` (driven by ``_pallas_bwd``).
    Bound on the H100 by memory: it reads y, mu, theta and writes two
    outputs, 5 x 441,728 B = 2.21 MB at (32, 3451), at least 0.66 us at
    3.35 TB/s.  Design: one thread per element, coalesced loads and stores,
    the analytic gradients in registers; no intermediate touches memory."""
    from ._build import library

    _check(y, mu, theta)
    if not mu.is_cuda:
        raise ValueError("nb_nll_bwd_kernel needs CUDA tensors")
    if (scale.dtype != torch.float32 or scale.numel() != 1
            or scale.device != mu.device):
        raise ValueError("nb_nll_bwd_kernel: scale must be one float32 on mu's device")
    lib = library()
    dmu = torch.empty_like(mu)
    dth = torch.empty_like(mu)
    with torch.cuda.device(mu.device):
        err = lib.dca_nb_nll_bwd(
            y.data_ptr(), mu.data_ptr(), theta.data_ptr(), scale.data_ptr(),
            dmu.data_ptr(), dth.data_ptr(), mu.numel(),
            torch.cuda.current_stream(mu.device).cuda_stream,
        )
    _raise_on(lib, err, "nb_nll_bwd_kernel (K2)")
    launches["nb_nll_bwd"] += 1
    return dmu, dth


class _NBNLLFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mu, theta):
        _check(y, mu, theta)
        fwd = nb_nll_fwd_kernel if mu.is_cuda else nb_nll_fwd_reference
        loss, denom = fwd(y, mu, theta)
        ctx.save_for_backward(y, mu, theta, denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        y, mu, theta, denom = ctx.saved_tensors
        scale = (g / denom).to(torch.float32).reshape(1)
        bwd = nb_nll_bwd_kernel if mu.is_cuda else nb_nll_bwd_reference
        dmu, dth = bwd(y, mu, theta, scale)
        return None, dmu, dth


def nb_nll_fused(y, mu, theta):
    """Mean NB NLL over (B, G) float32 tensors, kernels forward and back."""
    return _NBNLLFused.apply(y, mu, theta)
