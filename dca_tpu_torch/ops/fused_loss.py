"""Fused NB and ZINB negative log-likelihood: CUDA kernels K1 (forward) and
K2 (backward), and their weighted variants K1w and K2w.

``nb_nll_fused(y, mu, theta)`` is the mean NB NLL with the semantics of
``losses.nb_nll(y, mu, theta, masking=True)``: NaN targets are evaluated at
y = 0 for the terms and left out of the mean's denominator.
``zinb_nll_fused(y, mu, theta, pi, ridge)`` is the mean ZINB NLL of
``losses.zinb_nll(..., ridge_lambda=ridge, masking=True)``: the zero branch
tests the original y, so a NaN target takes the NB case at y = 0, and the
denominator counts the non-NaN results.  y and mu are (B, G) float32;
theta and pi may each be (B, G), (1, G) (constant dispersion), (B, 1) (the
``*-shared`` heads) or (1, 1), the shapes the JAX package's ``_bcastable``
accepts.  Each is a ``torch.autograd.Function`` whose forward launches K1
and whose backward launches K2 (``csrc/fused_nll.cu``), with the Stirling
``lgamma``/``digamma`` of ``csrc/special.cuh`` inlined in both; a broadcast
operand is read in place by the kernels, and its gradient is K2's full
(B, G) cotangent summed over the broadcast axes, as the JAX package's
``_reduce_to`` does.  y gets no gradient.

``nb_nll_fused_w(y, mu, theta, w)`` and ``zinb_nll_fused_w(y, mu, theta,
pi, w, ridge)`` are the per-row weighted means of
``losses.*(sample_weights=w)``: w is a (B, 1) float32 column, a NaN target
weighs 0, and the mean divides by the total weight, with a total of exactly
0 taken as 1 (fractional totals divide as they are).  A row of weight 0
adds exactly nothing to the value or the gradients: the data-parallel
trainer pads its validation split with such rows.  They launch K1w and K2w,
the same kernels templated on WITH_W; w and y get no gradient.

Every entry point takes ``group``: under a ``torch.distributed`` process
group the (sum, count) pair is summed over the ranks before the division,
and the function returns this rank's share of the mean over the whole
batch, its own sum over the global count.  The shares add up to the mean,
and each rank's backward scales its own gradients by g over the global
count.  A rank with an empty share joins the sum with (0, 0) and launches
nothing.

For a tensor on the CPU the same functions run their plain PyTorch
versions, which repeat the kernels' arithmetic (``log1p``, the Stirling
functions of ``ops/special.py``, exp/log for the zero probability, the same
masks): that is what the CPU tests hold against the JAX package.  For a
CUDA tensor they launch the kernels or raise.
"""

from __future__ import annotations

import torch

from .special import digamma, lgamma

EPS = 1e-10
THETA_CLIP = 1e6
ZERO_THRESHOLD = 1e-8

# Launches of each kernel, counted by its wrapper where it launches; the
# _w names count the weighted variants.
launches = {f"{fam}_nll_{kind}{w}": 0 for fam in ("nb", "zinb")
            for kind in ("fwd", "bwd") for w in ("", "_w")}

# broadcast modes, as csrc/fused_nll.cu numbers them
_FULL, _ROW, _COLUMN, _SCALAR = 0, 1, 2, 3


def reset_launches():
    for k in launches:
        launches[k] = 0


def _check(y, mu, theta, pi=None, w=None, allow_empty=False):
    """Raise on what the kernels do not take: anything but float32,
    2-D, contiguous tensors on one CPU or CUDA device, y of mu's shape,
    theta/pi of a shape ``_bcastable`` accepts, w a (B, 1) column, and
    (unless ``allow_empty``) an empty input."""
    named = [("y", y), ("mu", mu), ("theta", theta)] + ([("pi", pi)] if pi is not None else [])
    named += [("w", w)] if w is not None else []
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"fused NLL: {name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"fused NLL: {name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused NLL: {name} must be contiguous")
        if t.device != mu.device:
            raise ValueError("fused NLL: y, mu, theta and pi must be on one device")
    B, G = mu.shape
    if y.shape != mu.shape:
        raise ValueError(f"fused NLL: y {tuple(y.shape)} and mu {tuple(mu.shape)} differ")
    for name, t in named[2:]:
        r, c = t.shape
        if name == "w" and (r, c) != (B, 1):
            raise ValueError(f"fused NLL: w must be (B, 1) = {(B, 1)}; got {tuple(t.shape)}")
        if r not in (B, 1) or c not in (G, 1):
            raise ValueError(
                f"fused NLL: {name} must be (B, G), (1, G), (B, 1) or (1, 1) "
                f"against mu {(B, G)}; got {tuple(t.shape)}")
    if mu.numel() == 0 and not allow_empty:
        raise ValueError("fused NLL: empty input")
    if mu.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused NLL: unsupported device {mu.device}")


def _mode(t, shape):
    """The kernels' broadcast mode of operand ``t`` against (B, G)."""
    B, G = shape
    r, c = t.shape
    if r == B and c == G:
        return _FULL
    if c == G:
        return _ROW
    if r == B:
        return _COLUMN
    return _SCALAR


def _reduce_to(g, shape):
    """Sum a full (B, G) cotangent down to a broadcast operand's shape."""
    dims = tuple(a for a in range(2) if shape[a] == 1 and g.shape[a] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


# ---------------------------------------------------------------------------
# plain PyTorch versions: the kernels' arithmetic, elementwise
# ---------------------------------------------------------------------------


def _zero_prob(th, mu):
    """(theta / (theta + mu + eps))^theta through exp/log, 1 at theta = 0."""
    safe = torch.clamp(th, min=EPS)
    return torch.where(th > 0.0, torch.exp(th * (torch.log(safe) - torch.log(th + mu + EPS))),
                       1.0)


def _elem_terms(y, mu, th_raw, pi=None, ridge=0.0):
    y0 = torch.where(torch.isnan(y), 0.0, y)
    th = torch.clamp(th_raw, max=THETA_CLIP)
    t1 = lgamma(th + EPS) + lgamma(y0 + 1.0) - lgamma(y0 + th + EPS)
    t2 = (th + y0) * torch.log1p(mu / (th + EPS)) + y0 * (
        torch.log(th + EPS) - torch.log(mu + EPS)
    )
    nb = t1 + t2
    if pi is None:
        return nb
    nb_case = nb - torch.log(1.0 - pi + EPS)
    zero_case = -torch.log(pi + (1.0 - pi) * _zero_prob(th, mu) + EPS)
    # the original y: a NaN target takes the NB case
    res = torch.where(y < ZERO_THRESHOLD, zero_case, nb_case)
    return res + ridge * pi * pi


def _elem_grads(y, mu, th_raw, pi=None, ridge=0.0):
    """Full (B, G) d mu, d theta and d pi (None for NB), unscaled."""
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
    dpi = None
    if pi is not None:
        safe = torch.clamp(th, min=EPS)
        tme = th + mu + EPS
        z = _zero_prob(th, mu)
        denom = pi + (1.0 - pi) * z + EPS
        dz_dmu = -z * th / tme
        dz_dth = z * (torch.log(safe) - torch.log(tme) + 1.0 - th / tme)
        is_zero = y < ZERO_THRESHOLD
        dmu = torch.where(is_zero, -(1.0 - pi) * dz_dmu / denom, dmu)
        dth = torch.where(is_zero, -(1.0 - pi) * dz_dth / denom, dth)
        dpi = torch.where(is_zero, -(1.0 - z) / denom, 1.0 / (1.0 - pi + EPS)) + 2.0 * ridge * pi
    dth = torch.where(th_raw > THETA_CLIP, 0.0, dth)
    return dmu, dth, dpi


def grad_term_magnitudes(y, mu, th_raw, pi=None, ridge=0.0):
    """Per element, (B, G), the sum of the magnitudes of the terms that
    d mu, d theta and d pi (None for NB) add up (unscaled).  A float32
    evaluation of either formula carries a rounding error of a few ulps of
    it: where y is large and theta small, (theta + y) / theta and y / theta
    nearly cancel; in the zero case, dz/dtheta adds log terms that cancel
    where theta is large, and d pi subtracts z from 1.  The checks of K2
    against its plain version state their tolerance with it."""
    y0 = torch.where(torch.isnan(y), 0.0, y)
    th = torch.clamp(th_raw, max=THETA_CLIP)
    th_e = th + EPS
    thmu = th_e + mu
    mag_mu = (th + y0) / thmu + y0 / (mu + EPS)
    mag_th = (digamma(th_e).abs() + digamma(y0 + th_e).abs() + torch.log1p(mu / th_e)
              + (th + y0) / thmu + (th + y0) / th_e + y0 / th_e)
    if pi is None:
        return mag_mu, mag_th, None
    lsafe = torch.log(torch.clamp(th, min=EPS))
    tme = th + mu + EPS
    ltme = torch.log(tme)
    z = _zero_prob(th, mu)
    denom = pi + (1.0 - pi) * z + EPS
    # z = exp(theta (log theta - log(theta + mu))): the rounding of the
    # argument's two terms, times theta, is a relative error of z
    z_mag = z * (1.0 + th * (lsafe.abs() + ltme.abs()))
    # the terms of denom, relative to it, and of 1 - pi
    d_rel = (pi + (1.0 + pi) * z_mag) / denom
    f = (1.0 + pi) / denom * (1.0 + d_rel)
    is_zero = y < ZERO_THRESHOLD
    mag_mu = torch.where(is_zero, f * z_mag * th / tme, mag_mu)
    mag_th = torch.where(is_zero, f * z_mag * (lsafe.abs() + ltme.abs() + 1.0 + th / tme),
                         mag_th)
    mag_pi = torch.where(is_zero, (1.0 + z_mag) / denom * (1.0 + d_rel),
                         (1.0 + pi) / (1.0 - pi + EPS) ** 2) + 2.0 * ridge * pi
    return mag_mu, mag_th, mag_pi


def _fwd_sums_reference(y, mu, theta, pi, ridge, w=None):
    """Plain version of K1 (NB when ``pi`` is None; K1w with ``w``): the
    (sum, count) pair, a (2,) tensor."""
    res = _elem_terms(y, mu, theta, pi, ridge)
    if w is not None:
        valid = ~torch.isnan(y)
        return torch.stack([torch.sum(torch.where(valid, res * w, 0.0)),
                            torch.sum(torch.where(valid, w, 0.0))])
    counted = torch.isnan(res) if pi is not None else torch.isnan(y)
    return torch.stack([torch.sum(res), torch.sum((~counted).to(torch.float32))])


def _denominator(count, weighted):
    """The mean's denominator from the count: at least 1, or, weighted,
    the total weight with only an exact 0 taken as 1 (the JAX wrapper's
    ``where(total == 0, 1, total)``)."""
    if weighted:
        return torch.where(count == 0.0, torch.ones_like(count), count)
    return torch.clamp(count, min=1.0)


def _with_quotient(sums, weighted):
    """(sum, count, sum / denom, denom), a (4,) tensor, from the (sum,
    count) pair: what the last block of K1 writes, with its formula."""
    denom = _denominator(sums[1], weighted)
    return torch.stack([sums[0], sums[1], sums[0] / denom, denom])


def _fwd_out_reference(y, mu, theta, pi, ridge, w=None):
    """Plain version of K1 (NB when ``pi`` is None; K1w with ``w``): its
    (sum, count, loss, denom) output."""
    return _with_quotient(_fwd_sums_reference(y, mu, theta, pi, ridge, w), w is not None)


def _fwd_reference(y, mu, theta, pi, ridge, w=None):
    """Plain version of K1 and its wrapper (NB when ``pi`` is None;
    weighted with ``w``): (loss, denom)."""
    out = _fwd_out_reference(y, mu, theta, pi, ridge, w)
    return out[2], out[3]


def _bwd_reference(y, mu, theta, pi, ridge, scale, w=None):
    """Plain version of K2 and its wrapper: the gradients times ``scale``
    (weighted: times ``w * scale``, and exactly 0 at NaN targets), each
    summed to its operand's shape."""
    grads = _elem_grads(y, mu, theta, pi, ridge)
    if w is None:
        grads = [None if d is None else d * scale for d in grads]
    else:
        sel = ~torch.isnan(y)
        f = w * scale
        grads = [None if d is None else torch.where(sel, d * f, 0.0) for d in grads]
    dmu, dth, dpi = grads
    dth = _reduce_to(dth, theta.shape)
    if pi is None:
        return dmu, dth
    return dmu, dth, _reduce_to(dpi, pi.shape)


def nb_nll_fwd_reference(y, mu, theta):
    """Plain version of the NB K1 and its wrapper: (loss, denom)."""
    return _fwd_reference(y, mu, theta, None, 0.0)


def nb_nll_bwd_reference(y, mu, theta, scale):
    """Plain version of the NB K2 and its wrapper: (d mu, d theta), each
    times ``scale`` and of its operand's shape."""
    return _bwd_reference(y, mu, theta, None, 0.0, scale)


def zinb_nll_fwd_reference(y, mu, theta, pi, ridge=0.0):
    """Plain version of the ZINB K1 and its wrapper: (loss, denom)."""
    return _fwd_reference(y, mu, theta, pi, float(ridge))


def nb_nll_fwd_w_reference(y, mu, theta, w):
    """Plain version of the NB K1w and its wrapper: (loss, denom)."""
    return _fwd_reference(y, mu, theta, None, 0.0, w)


def nb_nll_bwd_w_reference(y, mu, theta, w, scale):
    """Plain version of the NB K2w and its wrapper: (d mu, d theta), each
    times ``w * scale``, 0 at NaN targets, and of its operand's shape."""
    return _bwd_reference(y, mu, theta, None, 0.0, scale, w)


def zinb_nll_fwd_w_reference(y, mu, theta, pi, w, ridge=0.0):
    """Plain version of the ZINB K1w and its wrapper: (loss, denom)."""
    return _fwd_reference(y, mu, theta, pi, float(ridge), w)


def nb_nll_fused_reference(y, mu, theta):
    """The NB loss in plain PyTorch with the kernels' math; differentiable
    by autograd, which gives a gradient independent of the analytic one."""
    return nb_nll_fwd_reference(y, mu, theta)[0]


def zinb_nll_fused_reference(y, mu, theta, pi, ridge=0.0):
    """The ZINB loss in plain PyTorch with the kernels' math, for autograd."""
    return zinb_nll_fwd_reference(y, mu, theta, pi, ridge)[0]


def nb_nll_fused_w_reference(y, mu, theta, w):
    """The weighted NB loss in plain PyTorch with the kernels' math, for
    autograd."""
    return nb_nll_fwd_w_reference(y, mu, theta, w)[0]


def zinb_nll_fused_w_reference(y, mu, theta, pi, w, ridge=0.0):
    """The weighted ZINB loss in plain PyTorch with the kernels' math, for
    autograd."""
    return zinb_nll_fwd_w_reference(y, mu, theta, pi, w, ridge)[0]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _raise_on(lib, err, what):
    if err != 0:
        msg = lib.dca_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _name(pi, w, kind):
    return f"{'nb' if pi is None else 'zinb'}_nll_{kind}{'' if w is None else '_w'}"


# K1's workspace on each device: the per-block partials and the ticket
# counter, zeroed once and never freed (csrc/fused_nll.cu)
_workspaces = {}


def _fwd_workspace(lib, device):
    """K1's workspace on ``device``, allocated and zeroed at its first call,
    which must come before any CUDA-graph capture that launches K1."""
    work = _workspaces.get(device)
    if work is None:
        work = torch.zeros(lib.dca_nll_fwd_workspace_floats(), device=device,
                           dtype=torch.float32)
        torch.cuda.synchronize(device)  # zeroed before any stream uses it
        _workspaces[device] = work
    return work


def _fwd_out_kernel(y, mu, theta, pi, ridge, w=None):
    """Launch K1 (NB when ``pi`` is None; K1w with ``w``); return its (sum,
    count, loss, denom) output, a (4,) device tensor.  See
    ``nb_nll_fwd_kernel``."""
    from ._build import library

    _check(y, mu, theta, pi, w)
    if not mu.is_cuda:
        raise ValueError("the K1 wrapper needs CUDA tensors")
    lib = library()
    with torch.cuda.device(mu.device):
        work = _fwd_workspace(lib, mu.device)
        out = torch.empty(4, device=mu.device, dtype=torch.float32)
        err = lib.dca_nll_fwd(
            y.data_ptr(), mu.data_ptr(), theta.data_ptr(),
            None if pi is None else pi.data_ptr(), None if w is None else w.data_ptr(),
            work.data_ptr(), out.data_ptr(), mu.numel(), mu.shape[1],
            _mode(theta, mu.shape), 0 if pi is None else _mode(pi, mu.shape),
            float(ridge), pi is not None, w is not None,
            torch.cuda.current_stream(mu.device).cuda_stream,
        )
    name = _name(pi, w, "fwd")
    _raise_on(lib, err, f"{name} (K1{'' if w is None else 'w'})")
    launches[name] += 1
    return out


def _fwd_kernel(y, mu, theta, pi, ridge, w=None):
    """Launch K1 (K1w with ``w``); return (loss, denom) as device
    scalars."""
    out = _fwd_out_kernel(y, mu, theta, pi, ridge, w)
    return out[2], out[3]


def _bwd_kernel(y, mu, theta, pi, ridge, scale, w=None):
    """Launch K2 (NB when ``pi`` is None; K2w with ``w``); see
    ``nb_nll_bwd_kernel``."""
    from ._build import library

    _check(y, mu, theta, pi, w)
    if not mu.is_cuda:
        raise ValueError("the K2 wrapper needs CUDA tensors")
    if (scale.dtype != torch.float32 or scale.numel() != 1
            or scale.device != mu.device):
        raise ValueError("the K2 wrapper: scale must be one float32 on mu's device")
    lib = library()
    dmu = torch.empty_like(mu)
    dth = torch.empty_like(mu)
    dpi = None if pi is None else torch.empty_like(mu)
    with torch.cuda.device(mu.device):
        err = lib.dca_nll_bwd(
            y.data_ptr(), mu.data_ptr(), theta.data_ptr(),
            None if pi is None else pi.data_ptr(), None if w is None else w.data_ptr(),
            scale.data_ptr(),
            dmu.data_ptr(), dth.data_ptr(), None if dpi is None else dpi.data_ptr(),
            mu.numel(), mu.shape[1],
            _mode(theta, mu.shape), 0 if pi is None else _mode(pi, mu.shape),
            float(ridge), pi is not None, w is not None,
            torch.cuda.current_stream(mu.device).cuda_stream,
        )
    name = _name(pi, w, "bwd")
    _raise_on(lib, err, f"{name} (K2{'' if w is None else 'w'})")
    launches[name] += 1
    # the broadcast operands' cotangents, summed outside the kernel as the
    # JAX package's _reduce_to sums them outside its Pallas kernel
    dth = _reduce_to(dth, theta.shape)
    if pi is None:
        return dmu, dth
    return dmu, dth, _reduce_to(dpi, pi.shape)


def nb_nll_fwd_kernel(y, mu, theta):
    """Launch the NB K1; return (loss, denom) as device scalars.

    Replaces the Pallas kernel ``dca_tpu/ops/fused_loss.py::_fwd_kernel``
    (driven by ``_pallas_fwd``) with ``with_pi=False``, and the host's
    division after it.  Bound on the H100 by memory: it reads y, mu and
    theta once, 3 x 441,728 B = 1.33 MB at the training step's (32, 3451),
    at least 0.40 us at 3.35 TB/s (less with a broadcast theta); at these
    sizes the launch and the accurate ``logf`` of the Stirling recurrence
    take longer.  Design: one launch.  A grid-stride loop over a block
    count fixed by n, coalesced loads of y and mu, theta read through its
    broadcast index (never expanded), the elementwise NLL summed in
    registers, then across the warp by shuffles and across the block
    through shared memory; each block writes its (sum, count) pair to a
    workspace kept on the device and draws a ticket, and the block that
    draws the last one sums the pairs in a fixed order, forms the
    denominator max(count, 1) and writes (sum, count, loss, denom).  The
    ticket is the only atomic and orders nothing in the sum, so the loss is
    bit-identical from run to run, and the wrapper launches nothing else
    (no sum over the partials, no clamp, no division on the host's
    stream).  The ragged edge is masked by index (i < n); nothing is
    padded."""
    return _fwd_kernel(y, mu, theta, None, 0.0)


def nb_nll_bwd_kernel(y, mu, theta, scale):
    """Launch the NB K2; return (d mu, d theta), each times ``scale``.

    ``scale`` is a one-element float32 tensor on the device (g / denom),
    passed by pointer as the JAX package passes it in SMEM: nothing is read
    back to the host.  Replaces the Pallas kernel
    ``dca_tpu/ops/fused_loss.py::_bwd_kernel`` (driven by ``_pallas_bwd``)
    with ``with_pi=False``, which writes no d pi.  Bound on the H100 by
    memory: it reads y, mu, theta and writes two (B, G) outputs, 5 x
    441,728 B = 2.21 MB at (32, 3451), at least 0.66 us at 3.35 TB/s.
    Design: one thread per element, coalesced loads and stores, the
    analytic gradients in registers; a broadcast theta's (B, G) cotangent
    is summed to its shape by one torch reduction."""
    return _bwd_kernel(y, mu, theta, None, 0.0, scale)


def zinb_nll_fwd_kernel(y, mu, theta, pi, ridge=0.0):
    """Launch the ZINB K1; return (loss, denom) as device scalars.

    Replaces ``dca_tpu/ops/fused_loss.py::_fwd_kernel`` with
    ``with_pi=True``: the same one-pass design as the NB K1, templated on
    WITH_PI, with pi read through its own broadcast index, and the count
    of non-NaN results (not targets) for the denominator.  Bound on the
    H100 by memory: 4 x 441,728 B = 1.77 MB at (32, 3451) with full theta
    and pi, at least 0.53 us at 3.35 TB/s."""
    return _fwd_kernel(y, mu, theta, pi, ridge)


def zinb_nll_bwd_kernel(y, mu, theta, pi, ridge, scale):
    """Launch the ZINB K2; return (d mu, d theta, d pi), each times
    ``scale`` and summed to its operand's shape.

    Replaces ``dca_tpu/ops/fused_loss.py::_bwd_kernel`` with
    ``with_pi=True``: one thread per element, writing the full (B, G)
    d mu, d theta and d pi.  Bound on the H100 by memory: it reads 4 and
    writes 3 (B, G) arrays, 7 x 441,728 B = 3.09 MB at (32, 3451), at
    least 0.92 us at 3.35 TB/s."""
    return _bwd_kernel(y, mu, theta, pi, ridge, scale)


class _FusedNLL(torch.autograd.Function):
    """K1 forward, K2 backward; NB when ``pi`` is None, else ZINB; K1w and
    K2w with a weight column ``w``.  Under ``group`` the (sum, count) pair
    is summed over its ranks first (the module docstring)."""

    @staticmethod
    def forward(ctx, y, mu, theta, pi, w, ridge, group):
        _check(y, mu, theta, pi, w, allow_empty=True)
        if mu.numel() == 0:
            # an empty share of the batch: (0, 0), nothing launched
            out = _with_quotient(torch.zeros(2, device=mu.device), w is not None)
        else:
            fwd = _fwd_out_kernel if mu.is_cuda else _fwd_out_reference
            out = fwd(y, mu, theta, pi, ridge, w)
        if group is None:
            # one device: K1's own quotient, one launch in all
            loss, denom = out[2], out[3]
        else:
            total = out[:2].clone()
            torch.distributed.all_reduce(total, group=group)
            denom = _denominator(total[1], w is not None)
            loss = out[0] / denom
        ctx.ridge = ridge
        ctx.save_for_backward(y, mu, theta, pi, w, denom)
        return loss

    @staticmethod
    def backward(ctx, g):
        y, mu, theta, pi, w, denom = ctx.saved_tensors
        if mu.numel() == 0:
            grads = [torch.zeros_like(t) for t in (mu, theta, pi) if t is not None]
        else:
            scale = (g / denom).to(torch.float32).reshape(1)
            bwd = _bwd_kernel if mu.is_cuda else _bwd_reference
            grads = bwd(y, mu, theta, pi, ctx.ridge, scale, w)
        dpi = grads[2] if pi is not None else None
        return None, grads[0], grads[1], dpi, None, None, None


def nb_nll_fused(y, mu, theta, group=None):
    """Mean NB NLL, kernels forward and back.  y, mu (B, G) float32; theta
    (B, G), (1, G), (B, 1) or (1, 1).  ``group``: see the module
    docstring."""
    return _FusedNLL.apply(y, mu, theta, None, None, 0.0, group)


def zinb_nll_fused(y, mu, theta, pi, ridge=0.0, group=None):
    """Mean ZINB NLL with ridge * pi^2, kernels forward and back.  y, mu
    (B, G) float32; theta and pi each (B, G), (1, G), (B, 1) or (1, 1)."""
    return _FusedNLL.apply(y, mu, theta, pi, None, float(ridge), group)


def nb_nll_fused_w(y, mu, theta, w, group=None):
    """Weighted mean NB NLL, ``losses.nb_nll(..., sample_weights=w)``: K1w
    forward, K2w back; w is the (B, 1) float32 column of row weights.

    Replaces ``dca_tpu/ops/fused_loss.py::_fwd_kernel`` and ``::_bwd_kernel``
    with ``with_w=True``, ``with_pi=False`` (``nb_nll_fused_w``).  The
    same one-pass design as K1 and K2, templated on WITH_W: w is read in
    place through the (B, 1) column index i / G, never expanded.  Bound
    on the H100 by memory as K1 and K2 are: K1w reads y, mu, theta and the
    column, 3 x 1,891,148 B = 5.67 MB at the validation block (137, 3451)
    of a 2-rank run, at least 1.69 us at 3.35 TB/s; K2w as K2, 2.21 MB at
    (32, 3451)."""
    return _FusedNLL.apply(y, mu, theta, None, w, 0.0, group)


def zinb_nll_fused_w(y, mu, theta, pi, w, ridge=0.0, group=None):
    """Weighted mean ZINB NLL with ridge * pi^2,
    ``losses.zinb_nll(..., sample_weights=w)``: K1w forward, K2w back.

    Replaces the JAX package's ``zinb_nll_fused_w`` (its two Pallas
    kernels with ``with_w=True``, ``with_pi=True``).  Bound by memory: K1w
    reads 4 (B, G) arrays, 7.56 MB at (137, 3451), at least 2.26 us at
    3.35 TB/s; K2w as K2, 3.09 MB at (32, 3451)."""
    return _FusedNLL.apply(y, mu, theta, pi, w, float(ridge), group)
