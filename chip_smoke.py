#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dca_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. Build and launch: build the CUDA kernels from ``dca_tpu_torch/csrc``
   and hold each one against its plain PyTorch version, on the same CUDA
   tensors, at the shapes of the main paths: the full and trailing training
   batches (32, 3451) and (25, 3451), the validation split (273, 3451), and
   a ragged (7, 50) with 10% NaN targets and clipped theta.  K1/K2: at each shape:
   NB with theta (B, G), (1, G) and (B, 1); ZINB with theta/pi (B, G)/(B, G)
   at ridge 0 and 0.1, and the broadcast pairs (1, G)/(B, G), (B, 1)/(B, 1),
   (1, G)/(1, G), (B, 1)/(1, G) at ridge 0.1.  Tolerances: loss relative
   error <= 1e-5 (the kernel sums in another order than torch.sum) and the
   denominator's count exact; gradients elementwise, stated on the
   unscaled gradient (the path's gradients carry g / denom, about 1e-6 at
   (273, 3451)): rtol 1e-4, atol 1e-6 plus 4 float32 ulps of the sum of the
   magnitudes of the terms the formula adds
   (``fused_loss.grad_term_magnitudes``), since both sides round those
   terms in float32 and, where they cancel, the result is far smaller.  A
   broadcast operand's gradient is a sum of n such elements: its tolerance
   is the sum of theirs plus 2 ceil(log2 n) ulps of the summed magnitudes
   for the two reductions' rounding.  K1 must give the same bits twice.
   K1w/K2w (the weighted variants) at the validation block of one of two
   ranks (137, 3451), the batch (32, 3451) and the ragged (7, 50), with
   the same theta/pi cases, each with padding weights (ones, the last row
   0), fractional weights (two rows 0) and all-zero weights (denominator
   1): the same tolerances, the total weight exact for 0/1 weights, each
   element's gradient tolerance times its weight, and gradients of
   exactly 0 on zero-weight rows and at NaN targets.
   K4 (the fused dense block) at the shapes of the denoise path
   (``DENSE_CASES``), through both tilings of its plan
   (``fused_dense.plan``: whole K in shared memory for K <= 64, split-K
   across a cluster above): the encoder (2730, 3451) -> 64 with BN and
   relu (split-K), the heads (2730, 64) -> 3451 with the mean, disp and
   sigmoid epilogues (whole K), the decoder layer 32 -> 64 at 2730 and 64
   rows, a ragged (33, 200) -> 70 with BN, size factors and all 8
   epilogues, (16, 1500) -> 96, a ragged last slice (33, 1000) -> 70, K =
   65 in 3 one-step slices, K = 20 with all 8 epilogues, a head of N = 200,
   and the encoder, heads, ragged case and small head again under
   DCA_TPU_MATMUL=bf16.
   Tolerances: the ``linear`` output against the plain version within
   2 K 2^-24 (|x| @ |W| + |b|) elementwise, times |s| with BN, plus 4
   ulps (two float32 sums of K products in different orders); each
   activated output within 4 ulps of the plain activation applied to the
   kernel's own linear output (times sf); the pre-activation the same bits
   for every epilogue (relu, elu and linear outputs equal to the linear
   output where it is positive); a NaN in a row of x gives a NaN row
   under every epilogue and leaves the other rows' bits as they were; two
   runs give the same bits.  K1 and K1w also give (sum, count, loss,
   denom) in one launch: the loss and denominator come from the kernel.
2. Kernel timings at (32, 3451), NB and ZINB: median device time of 50
   launches after a warm-up, each launch a CUDA graph replay between CUDA
   events (see ``_device_ms``); beside them the plain version's time and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 67 TFLOP/s float32).  K1 also at the validation split (273, 3451).
   K1w at (137, 3451) and K2w at (32, 3451), NB and ZINB, likewise.
   K4 at the encoder and head shapes, with its plan, its bound, the plain
   version's time and, for the ``linear`` epilogue, ``torch.addmm``'s,
   timed in turns with K4 on the same inputs (x warm in the 50 MB L2 for
   both).
3. Zoo: every architecture of ``AE_types``, and zinb-elempi with
   sharedpi, trains 2 epochs at 200 cells x 60 genes, (16, 8, 16), on the
   CPU and on the card from the same weights; the losses must agree epoch
   by epoch within rtol 1e-3 (matrix products and sums run in another order
   on the two devices, and the difference grows over the RMSprop steps),
   and the card run must launch the kernel family of its likelihood and no
   other (normal and poisson launch none).
4. API runs: ``dca_tpu_torch.dca`` on a 2730 x 3451 Paul15-shaped matrix,
   64-32-64, batch 32, on the card: zinb-conddisp for 5 epochs (the main
   path; its per-epoch time is printed), then nb-conddisp for 2; outputs
   finite and of the right shapes, and the kernels' launch counters, set
   to 0 just before each run, equal to what that run must launch.
5. CLI runs: ``python -m dca_tpu_torch counts.tsv out/ -e 2`` on the card
   with the default nb-conddisp, ``--type zinb-conddisp`` and ``--type
   zinb``, and the output contract (mean, mean_norm, latent, reduced,
   dispersion, and for ZINB dropout and pi TSVs, and model.pickle, all
   values finite); then zinb-conddisp again through the streaming write
   (DCA_TPU_HOST_DENSE_BYTES=1) with K4 on (DCA_TPU_FUSED_DENSE=1).
6. The denoise tier on phase 4's trained zinb-conddisp network at
   2730 x 3451: ``forward`` with K4 off and on (outputs within the error
   bound propagated through the layers, ``_forward_tolerance``; 4 K4
   launches: encoder, mean, dispersion and pi heads; both times printed),
   then ``write_streaming(mode="full", return_info=True,
   chunk_rows=1024)`` with DCA_TPU_WRITE_ALIASES=0 in 3 blocks (12 K4
   launches; file shapes; the first genes of mean.tsv equal to the
   in-memory output of the same blocks printed to 6 decimals; its time);
   and phase 4's nb-conddisp network's ``predict(return_info=True)``
   (4 K4 launches: encoder and mean head for the denoise, encoder and
   dispersion head for the dispersion after it).
7. The data-parallel fit: 2 ranks, spawned, both on the one card over
   gloo (asked for explicitly; NCCL refuses ranks that share a device),
   each running ``dca(devices="all")`` on phase 4's matrix and seed:
   zinb-conddisp for 2 epochs, then nb-conddisp for 1.  Loss and val_loss
   the same on both ranks and within rtol 1e-3 of phase 4's first two
   epochs; per-rank launches 154 / 154 K1/K2 and 2 K1w (the padded
   validation, 273 rows to 274) for zinb-conddisp, 77 / 77 and 1 for
   nb-conddisp, no K2w (nothing differentiates the weighted validation);
   the denoised matrices equal on both ranks and finite; rank 0 alone
   writes (its model.pickle).  A rank that fails or outlives its time
   limit fails the phase.  The data-parallel epoch time is printed: two
   ranks sharing one card measure no scaling.

Prints the card's name and power limit, then one ``{"kernels": [...]}``
line, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero, with no result line, when there is no CUDA device or a phase
fails.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chip_smoke_out")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # on the unscaled gradient
GRAD_ULPS = 4  # float32 ulps of the gradient's summed term magnitudes
F32_EPS = 2.0 ** -23
N_TIMED = 50


class SmokeFailure(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_paul15_like(n_cells=2730, n_genes=3451, seed=42):
    """Synthetic counts at the Paul15 scale and sparsity (~75% zeros), the
    shape of the reference's Figure 9 workload; the same generator as the
    JAX package's bench.py."""
    rs = np.random.RandomState(seed)
    base = rs.gamma(0.5, 1.0, size=(1, n_genes))
    depth = rs.lognormal(0.0, 0.5, size=(n_cells, 1))
    mu = base * depth * 1.2
    counts = rs.negative_binomial(0.7, 0.7 / (0.7 + mu)).astype(np.float32)
    counts[:, counts.sum(0) == 0] += 1.0
    counts[counts.sum(1) == 0, 0] += 1.0
    return counts


def _loss_inputs(B, G, seed, nan_frac=0.0, n_clipped=0, th_shape=None,
                 pi_shape=None):
    """y, mu, theta and pi as the main paths give them: NB counts with
    dropout, means, dispersions and dropout probabilities inside the output
    heads' clips; theta of ``th_shape`` and pi of ``pi_shape`` (None: no
    pi), each (B, G) by default."""
    rs = np.random.RandomState(seed)
    mu = rs.lognormal(0.0, 1.0, size=(B, G)).clip(1e-5, 1e6).astype(np.float32)
    th = rs.lognormal(0.5, 1.0, size=th_shape or (B, G)).clip(1e-4, 1e4).astype(np.float32)
    y = rs.negative_binomial(th, th / (th + mu)).astype(np.float32)
    y[rs.uniform(size=y.shape) < 0.2] = 0.0
    if nan_frac:
        y[rs.uniform(size=y.shape) < nan_frac] = np.nan
    if n_clipped:
        flat = th.reshape(-1)
        flat[rs.choice(flat.size, min(n_clipped, flat.size - 1), replace=False)] = 2e6
    pi = None
    if pi_shape is not None:
        pi = (1.0 / (1.0 + np.exp(-rs.normal(-1.0, 1.5, size=pi_shape)))).astype(np.float32)
    return y, mu, th, pi


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------


def _pushes(x):
    """Recurrence steps the Stirling functions take at x (z < 8 tests)."""
    import torch

    return torch.clamp(torch.ceil(8.0 - x), 0.0, 8.0)


def _k1_ops(y, mu, th, with_pi=False):
    """Operations of K1 on these inputs, counted from the kernel source
    with a transcendental as one: 22 + 3 k per log Gamma (k recurrence
    steps), 27 around them, and 25 more for the ZINB terms."""
    import torch

    y0 = torch.nan_to_num(y, nan=0.0)
    t = torch.clamp(th, max=1e6).expand(y.shape)
    k = _pushes(t + 1e-10) + _pushes(y0 + 1.0) + _pushes(y0 + t + 1e-10)
    return float(y.numel() * (27 + 3 * 22 + (25 if with_pi else 0)) + 3 * k.sum().item())


def _k2_ops(y, mu, th, with_pi=False):
    """Operations of K2: 21 + 3 k per digamma, 28 around the two, and 43
    more for the ZINB terms."""
    import torch

    y0 = torch.nan_to_num(y, nan=0.0)
    t = torch.clamp(th, max=1e6).expand(y.shape) + 1e-10
    k = _pushes(t) + _pushes(y0 + t)
    return float(y.numel() * (28 + 2 * 21 + (43 if with_pi else 0)) + 3 * k.sum().item())


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# operations of K4's epilogue per output beyond the bias: the activation
# (a transcendental counted as one), as csrc/fused_dense.cu computes it
K4_ACT_OPS = {"mean": 3, "disp": 8, "sigmoid": 4, "relu": 1, "selu": 4, "elu": 2,
              "tanh": 1, "linear": 0}


def k4_bound(rows, k, n, bn=False, activation="linear", sf=False):
    """The bound of K4 (``dca_tpu/ops/fused_dense.py::_kernel``) for
    act((x @ W + b) s + t) sf on (rows, k) @ (k, n).  Bytes: x, W, b, the
    folded BN's s and t, sf read once, the (rows, n) output written once;
    operations: 2 per multiply-add of the product, 1 for the bias, 2 for
    the BN affine, the activation's, 1 for sf, per output.  Returns (bound
    ms, bound by, bytes, operations)."""
    n_bytes = 4 * (rows * k + k * n + n + (2 * n if bn else 0) + (rows if sf else 0)
                   + rows * n)
    n_ops = 2.0 * rows * k * n + rows * n * (1 + (2 if bn else 0) + K4_ACT_OPS[activation]
                                             + (1 if sf else 0))
    ms, by = _bound_ms(n_bytes, n_ops)
    return ms, by, n_bytes, n_ops


def _device_ms(fn, n=N_TIMED, warmup=10):
    """Median device time of ``n`` calls of ``fn``.  One call is captured
    in a CUDA graph, so its launches run back to back on the device; each
    replay is timed with CUDA events, and a sleep kernel holds the device
    while the host queues the replays, so host enqueue time is not
    counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from dca_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"phase 1: kernels built and loaded in {secs:.2f} s: {lib_path}")
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        for line in f:
            if ("ptxas info" in line and ("registers" in line or "Compiling" in line)
                    or "spill" in line):
                print("  " + line.strip())


def _grad_check(name, got, want, want_full, mag, scale):
    """Hold a K2 gradient against its plain version on the unscaled values
    (see the module docstring); return (max abs error, max error / tol).
    ``want_full`` (unscaled) and ``mag`` are (B, G); ``want`` may be
    reduced to a broadcast operand's shape, and the elements' tolerances
    are then summed alike, plus the rounding of two float32 sums of n
    terms."""
    import torch

    from dca_tpu_torch.ops.fused_loss import _reduce_to

    _check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    _check(bool(torch.isfinite(got).all()), f"{name} not finite")
    err = (got - want).abs() / scale
    elem = GRAD_ATOL + GRAD_ULPS * F32_EPS * mag + GRAD_RTOL * want_full.abs()
    tol = _reduce_to(elem, want.shape)
    summed = mag.numel() // want.numel()
    if summed > 1:
        tol = tol + (2 * int(np.ceil(np.log2(summed))) * F32_EPS
                     * _reduce_to(want_full.abs(), want.shape))
    bad = err > tol
    _check(not bool(bad.any()),
           f"{name}: {int(bad.sum())} elements outside rtol {GRAD_RTOL}, atol "
           f"{GRAD_ATOL} + {GRAD_ULPS} ulps of the terms (summed over {summed}); max "
           f"unscaled error {err.max().item():.3e}")
    return err.max().item(), (err / tol).max().item()


COMPARE_SHAPES = [((32, 3451), 0.0, 0), ((25, 3451), 0.0, 0), ((273, 3451), 0.0, 0),
                  ((7, 50), 0.1, 3)]


def _compare_cases(B, G):
    """(theta shape, pi shape or None, ridge) of each check at (B, G)."""
    full, row, col = (B, G), (1, G), (B, 1)
    return ([(full, None, 0.0), (row, None, 0.0), (col, None, 0.0),
             (full, full, 0.0), (full, full, 0.1)]
            + [(th, pi, 0.1) for th, pi in ((row, full), (col, col), (row, row), (col, row))])


def phase_compare(dev):
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    worst = {k: {"fwd_abs": 0.0, "fwd_rel": 0.0, "bwd_abs": 0.0, "bwd_tol": 0.0}
             for k in ("nb", "zinb")}
    n_checks = 0
    for seed, ((B, G), nan_frac, n_clipped) in enumerate(COMPARE_SHAPES):
        for case, (th_shape, pi_shape, ridge) in enumerate(_compare_cases(B, G)):
            y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                             for a in _loss_inputs(B, G, 100 * seed + case, nan_frac,
                                                   n_clipped, th_shape, pi_shape))
            fam = "nb" if pi is None else "zinb"
            what = f"{fam} K1/K2 at {(B, G)}, theta {th_shape}, pi {pi_shape}, ridge {ridge}"
            ops = (mu, th) if pi is None else (mu, th, pi)
            for t in ops:
                t.requires_grad_(True)
            if pi is None:
                loss = fl.nb_nll_fused(y, mu, th)  # K1
                again = fl.nb_nll_fused(y, mu, th)
                _, denom = fl.nb_nll_fwd_kernel(y, mu, th)
            else:
                loss = fl.zinb_nll_fused(y, mu, th, pi, ridge)
                again = fl.zinb_nll_fused(y, mu, th, pi, ridge)
                _, denom = fl.zinb_nll_fwd_kernel(y, mu, th, pi, ridge)
            grads = torch.autograd.grad(loss, ops)  # K2
            _check(torch.equal(loss, again), f"{what}: K1 is not deterministic")
            with torch.no_grad():
                ref, rdenom = fl._fwd_reference(y, mu, th, pi, ridge)
                scale = 1.0 / rdenom  # what the path multiplies the gradients by
                refs = fl._bwd_reference(y, mu, th, pi, ridge, scale.reshape(1))
                fulls = fl._elem_grads(y, mu, th, pi, ridge)
                mags = fl.grad_term_magnitudes(y, mu, th, pi, ridge)
            _check(torch.equal(denom, rdenom),
                   f"{what}: K1 count {denom.item()} vs plain {rdenom.item()}")
            fwd_abs = abs(loss.item() - ref.item())
            fwd_rel = fwd_abs / abs(ref.item())
            _check(np.isfinite(loss.item()), f"{what}: loss not finite")
            _check(fwd_rel <= LOSS_RTOL,
                   f"{what}: loss {loss.item()!r} vs plain {ref.item()!r}, relative "
                   f"error {fwd_rel:.3e} > {LOSS_RTOL}")
            w = worst[fam]
            for gname, got, want, full, mag in zip(("d mu", "d theta", "d pi"), grads,
                                                   refs, fulls, mags):
                e_abs, e_tol = _grad_check(f"{what}: {gname}", got, want,
                                           full.expand(B, G), mag.expand(B, G), scale)
                w["bwd_abs"] = max(w["bwd_abs"], e_abs)
                w["bwd_tol"] = max(w["bwd_tol"], e_tol)
            w["fwd_abs"] = max(w["fwd_abs"], fwd_abs)
            w["fwd_rel"] = max(w["fwd_rel"], fwd_rel)
            n_checks += 1
        print(f"phase 1: {(B, G)}: {len(_compare_cases(B, G))} NB/ZINB cases agree")
    for fam, w in worst.items():
        print(f"phase 1: {fam}: worst K1 loss error {w['fwd_abs']:.3e} abs, "
              f"{w['fwd_rel']:.3e} rel; worst K2 unscaled gradient error "
              f"{w['bwd_abs']:.3e} abs, {w['bwd_tol']:.3f} of its tolerance "
              f"({n_checks} cases in all)")
    return worst


# K1w/K2w: the validation block of one of 2 ranks (273 rows padded to 274),
# the training batch, and the ragged case with NaN targets and clipped theta
WEIGHTED_SHAPES = [((137, 3451), 0.0, 0), ((32, 3451), 0.0, 0), ((7, 50), 0.1, 3)]
WEIGHT_KINDS = ("padding", "fractional", "zero")


def _weights(B, kind, seed):
    """A (B, 1) weight column: ``padding`` ones with the last row at 0 (a
    padded validation block), ``fractional`` in [0.2, 2) with two rows at
    0, ``zero`` all 0 (the denominator is then 1)."""
    w = np.ones((B, 1), np.float32)
    if kind == "padding":
        w[-1] = 0.0
    elif kind == "fractional":
        w = np.random.RandomState(seed).uniform(0.2, 2.0, size=(B, 1)).astype(np.float32)
        w[[0, B // 2]] = 0.0
    else:
        w[:] = 0.0
    return w


def check_weighted_case(dev, B, G, nan_frac, n_clipped, th_shape, pi_shape, ridge, kind,
                        seed):
    """Hold K1w/K2w against their plain versions on one case: the loss
    within LOSS_RTOL (exactly 0 for all-zero weights), the total weight
    exact where the weights are 0 and 1 and within LOSS_RTOL otherwise,
    the unscaled gradients as K2's (``_grad_check``, with each element's
    terms times its weight), and exactly 0 on zero-weight rows and at NaN
    targets; K1w the same bits twice.  Returns (loss abs error, loss rel
    error, max unscaled gradient error, worst gradient error over its
    tolerance)."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                     for a in _loss_inputs(B, G, seed, nan_frac, n_clipped, th_shape, pi_shape))
    w = torch.from_numpy(_weights(B, kind, seed)).to(dev)
    what = (f"{'nb' if pi is None else 'zinb'} K1w/K2w at {(B, G)}, theta {th_shape}, pi "
            f"{pi_shape}, ridge {ridge}, {kind} weights")
    ops = [t.requires_grad_(True) for t in (mu, th, pi) if t is not None]
    if pi is None:
        loss = fl.nb_nll_fused_w(y, mu, th, w)
        again = fl.nb_nll_fused_w(y, mu, th, w)
    else:
        loss = fl.zinb_nll_fused_w(y, mu, th, pi, w, ridge)
        again = fl.zinb_nll_fused_w(y, mu, th, pi, w, ridge)
    grads = torch.autograd.grad(loss, ops)
    _, denom = fl._fwd_kernel(y, mu, th, pi, ridge, w)
    _check(torch.equal(loss, again), f"{what}: K1w is not deterministic")
    with torch.no_grad():
        ref, rdenom = fl._fwd_reference(y, mu, th, pi, ridge, w)
        scale = 1.0 / rdenom
        refs = fl._bwd_reference(y, mu, th, pi, ridge, scale.reshape(1), w)
        w_eff = torch.where(torch.isnan(y), 0.0, w)  # what each element weighs
        fulls = [g * w_eff for g in fl._elem_grads(y, mu, th, pi, ridge) if g is not None]
        mags = [m * w_eff for m in fl.grad_term_magnitudes(y, mu, th, pi, ridge)
                if m is not None]
    _check(np.isfinite(loss.item()), f"{what}: loss not finite")
    if kind == "zero":
        _check(loss.item() == 0.0 and denom.item() == 1.0 and ref.item() == 0.0,
               f"{what}: loss {loss.item()!r}, total weight {denom.item()!r}, expected 0 and 1")
        fwd_abs = fwd_rel = 0.0
    else:
        fwd_abs = abs(loss.item() - ref.item())
        fwd_rel = fwd_abs / abs(ref.item())
        _check(fwd_rel <= LOSS_RTOL, f"{what}: loss {loss.item()!r} vs plain {ref.item()!r}, "
               f"relative error {fwd_rel:.3e} > {LOSS_RTOL}")
        if kind == "padding":
            _check(torch.equal(denom, rdenom),
                   f"{what}: total weight {denom.item()} vs plain {rdenom.item()}")
        else:
            _check(abs(denom.item() - rdenom.item()) <= LOSS_RTOL * rdenom.item(),
                   f"{what}: total weight {denom.item()} vs plain {rdenom.item()}")
    zero = (w_eff == 0.0).expand(B, G)
    e_abs = e_tol = 0.0
    for gname, got, want, full, mag in zip(("d mu", "d theta", "d pi"), grads, refs, fulls,
                                           mags):
        if got.shape == (B, G):
            _check(bool((got[zero] == 0.0).all()),
                   f"{what}: {gname} not exactly 0 on zero-weight rows or NaN targets")
        a, t = _grad_check(f"{what}: {gname}", got, want, full.expand(B, G),
                           mag.expand(B, G), scale)
        e_abs, e_tol = max(e_abs, a), max(e_tol, t)
    return fwd_abs, fwd_rel, e_abs, e_tol


def phase_weighted_compare(dev):
    """K1w/K2w against their plain versions at every shape of
    WEIGHTED_SHAPES, every theta/pi case of ``_compare_cases`` and every
    kind of weights."""
    worst = {k: {"fwd_abs": 0.0, "fwd_rel": 0.0, "bwd_abs": 0.0, "bwd_tol": 0.0}
             for k in ("nb", "zinb")}
    n = 0
    for s_i, ((B, G), nan_frac, n_clipped) in enumerate(WEIGHTED_SHAPES):
        for case, (th_shape, pi_shape, ridge) in enumerate(_compare_cases(B, G)):
            for k_i, kind in enumerate(WEIGHT_KINDS):
                r = check_weighted_case(dev, B, G, nan_frac, n_clipped, th_shape, pi_shape,
                                        ridge, kind, 3000 + 100 * s_i + 10 * case + k_i)
                w = worst["nb" if pi_shape is None else "zinb"]
                for key, v in zip(("fwd_abs", "fwd_rel", "bwd_abs", "bwd_tol"), r):
                    w[key] = max(w[key], v)
                n += 1
        print(f"phase 1: K1w/K2w at {(B, G)}: {len(_compare_cases(B, G)) * len(WEIGHT_KINDS)} "
              "NB/ZINB cases agree")
    for fam, w in worst.items():
        print(f"phase 1: weighted {fam}: worst K1w loss error {w['fwd_abs']:.3e} abs, "
              f"{w['fwd_rel']:.3e} rel; worst K2w unscaled gradient error {w['bwd_abs']:.3e} "
              f"abs, {w['bwd_tol']:.3f} of its tolerance ({n} cases in all); zero-weight rows "
              "and NaN targets exactly 0")
    return worst


ALL_ACTS = ("mean", "disp", "sigmoid", "relu", "selu", "elu", "tanh", "linear")
# name, (rows, K, N), BN, epilogues, size factors, checked again in bf16
# mode; the plan (fused_dense.plan) takes K <= 64 through the whole-K tiling
# and longer K through split-K
DENSE_CASES = [
    ("encoder", (2730, 3451, 64), True, ("relu",), False, True),  # split-K, 6 splits
    ("heads", (2730, 64, 3451), False, ("mean", "disp", "sigmoid"), False, True),  # whole K
    ("decoder", (2730, 32, 64), True, ("relu",), False, False),
    ("decoder rows 64", (64, 32, 64), True, ("relu",), False, False),
    ("ragged", (33, 200, 70), True, ALL_ACTS, True, True),  # 7 splits of one step
    ("long K", (16, 1500, 96), True, ("relu",), False, False),
    # the last step of the last slice 8 deep (1000 = 31 x 32 + 8), 8 splits
    ("ragged last slice", (33, 1000, 70), True, ("linear",), True, False),
    # 3 steps in 3 splits, the last 1 deep; and K shorter than one step
    ("K 65", (100, 65, 64), False, ("relu",), False, False),
    ("K 20", (40, 20, 300), True, ALL_ACTS, True, False),
    ("head N 200", (300, 64, 200), False, ("mean",), True, True),  # N not a multiple of 128
]


def dense_inputs(B, K, N, seed, bn=True, sf=False, nonneg=False):
    """x, W, b, (moving_mean, moving_var, beta) or None, sf or None as the
    denoise path gives them: z-scaled inputs (or relu outputs with
    ``nonneg``), Glorot-sized weights, moving statistics of O(1)."""
    rs = np.random.RandomState(seed)
    x = rs.normal(size=(B, K)).astype(np.float32)
    if nonneg:
        x = np.abs(x)
    w = (rs.normal(size=(K, N)) * np.sqrt(2.0 / (K + N))).astype(np.float32)
    b = (rs.normal(size=(N,)) * 0.1).astype(np.float32)
    stats = None
    if bn:
        stats = ((rs.normal(size=(N,)) * 0.1).astype(np.float32),
                 rs.uniform(0.5, 2.0, size=(N,)).astype(np.float32),
                 (rs.normal(size=(N,)) * 0.1).astype(np.float32))
    sfv = rs.uniform(0.5, 2.0, size=(B,)).astype(np.float32) if sf else None
    return x, w, b, stats, sfv


def _on(dev, arrays):
    """The numpy arrays (or tuples of them, or None) as tensors on ``dev``."""
    import torch

    return [None if a is None else tuple(_on(dev, a)) if isinstance(a, tuple)
            else torch.from_numpy(a).to(dev) for a in arrays]


def _ulps(v, n=4):
    """n float32 ulps at |v|, elementwise."""
    import torch

    a = v.abs()
    return n * (torch.nextafter(a, torch.full_like(a, float("inf"))) - a)


def check_dense_case(dev, name, shape, bn, acts, with_sf, seed, bf16=False):
    """Hold K4 against its plain version on one case (see the module
    docstring's tolerances).  Returns (max abs error of the activated
    outputs against the whole plain version, the worst error over its
    tolerance)."""
    import torch

    from dca_tpu_torch.ops import fused_dense as fd

    B, K, N = shape
    what = f"K4 {name} {shape}{' bf16' if bf16 else ''}"
    x, w, b, stats, sf = _on(dev, dense_inputs(B, K, N, seed, bn, with_sf,
                                               nonneg=name == "heads"))
    prev = os.environ.get("DCA_TPU_MATMUL")
    os.environ["DCA_TPU_MATMUL"] = "bf16" if bf16 else "f32"
    try:
        lin = fd.fused_dense_block(x, w, b, bn=stats, activation="linear")
        want_lin = fd.fused_dense_reference(x, w, b, bn=stats, activation="linear")
        xr, wr = (x.bfloat16().float(), w.bfloat16().float()) if bf16 else (x, w)
        tol = 2 * K * 2.0 ** -24 * (xr.abs() @ wr.abs() + b.abs())
        if stats is not None:
            tol = tol * fd.fold_bn(stats)[0].abs()
        tol = tol + _ulps(want_lin)
        err = (lin - want_lin).abs()
        _check(bool(torch.isfinite(lin).all()), f"{what}: linear output not finite")
        _check(torch.equal(fd.fused_dense_block(x, w, b, bn=stats, activation="linear"), lin),
               f"{what}: two runs gave other bits")
        _check(bool((err <= tol).all()),
               f"{what}: linear output off by {err.max().item():.3e}, "
               f"{(err / tol).max().item():.3f} of its tolerance")
        worst = (err / tol).max().item()
        max_err = err.max().item()
        sfc = 1.0 if sf is None else sf.reshape(-1, 1)
        for act in acts:
            got = fd.fused_dense_block(x, w, b, bn=stats, activation=act, size_factors=sf)
            want = fd.EPILOGUES[act](lin) * sfc
            nan = torch.isnan(want)
            _check(torch.equal(torch.isnan(got), nan), f"{what} {act}: NaN where the plain "
                   "activation of the linear output has none, or the reverse")
            e = (got - want).abs()[~nan]
            t = _ulps(want)[~nan]
            _check(bool((e <= t).all()), f"{what} {act}: {int((e > t).sum())} outputs more "
                   f"than 4 ulps from the plain activation of the kernel's linear output")
            if act in ("relu", "elu", "linear"):
                # identity where positive: the pre-activation is the same bits
                pos = lin > 0
                _check(torch.equal(got[pos], (lin * sfc)[pos] if sf is not None else lin[pos]),
                       f"{what} {act}: pre-activation bits differ from the linear epilogue's")
            full = fd.fused_dense_reference(x, w, b, bn=stats, activation=act, size_factors=sf)
            max_err = max(max_err, (got - full).abs()[~nan].max().item())
        # a NaN in one row of x: that row NaN under every epilogue, the other
        # rows' bits unchanged
        xn = x.clone()
        xn[3, 10] = float("nan")
        for act in acts:
            clean = fd.fused_dense_block(x, w, b, bn=stats, activation=act, size_factors=sf)
            got = fd.fused_dense_block(xn, w, b, bn=stats, activation=act, size_factors=sf)
            _check(bool(torch.isnan(got[3]).all()), f"{what} {act}: NaN row not NaN")
            rest = torch.arange(B, device=dev) != 3
            _check(torch.equal(got[rest], clean[rest]),
                   f"{what} {act}: a NaN in row 3 changed other rows")
    finally:
        if prev is None:
            os.environ.pop("DCA_TPU_MATMUL", None)
        else:
            os.environ["DCA_TPU_MATMUL"] = prev
    return max_err, worst


def _plan_text(B, K, N):
    """K4's plan on the card at (B, K) @ (K, N), in words."""
    import torch

    from dca_tpu_torch.ops import fused_dense as fd

    p = fd.device_plan(B, K, N, torch.device("cuda"))
    if p.kind == fd.WIDE:
        return f"whole K in shared memory, {p.bm} x {p.bn} tiles"
    return f"split-K, {p.bm} x {p.bn} tiles, {p.splits} splits a cluster"


def phase_dense_compare(dev):
    """K4 against its plain version at every case of DENSE_CASES."""
    max_err = worst = 0.0
    n = 0
    for seed, (name, shape, bn, acts, with_sf, also_bf16) in enumerate(DENSE_CASES):
        for bf16 in (False, True) if also_bf16 else (False,):
            e, r = check_dense_case(dev, name, shape, bn, acts, with_sf, 500 + seed, bf16)
            max_err, worst = max(max_err, e), max(worst, r)
            n += 1
            print(f"phase 1: K4 {name} {shape}{' bf16' if bf16 else ''}, BN {bn}, sf "
                  f"{with_sf}, {', '.join(acts)}, {_plan_text(*shape)}: agrees (max abs "
                  f"error {e:.3e}, linear {r:.3f} of its tolerance; the same bits twice, for "
                  "every epilogue, and beside a NaN row)")
    print(f"phase 1: K4: {n} cases agree; worst linear error {worst:.3f} of its tolerance, "
          f"max abs error against the whole plain version {max_err:.3e}")
    return max_err


K4_TIMED = [  # name, (rows, K, N), BN, epilogue: the denoise path's layers
    ("encoder", (2730, 3451, 64), True, "relu"),
    ("encoder", (2730, 3451, 64), False, "linear"),
    ("head", (2730, 64, 3451), False, "mean"),
    ("head", (2730, 64, 3451), False, "disp"),
    ("head", (2730, 64, 3451), False, "sigmoid"),
    ("head", (2730, 64, 3451), False, "linear"),
]


def dense_timings(dev):
    """K4, its plain version and (linear, no BN) torch.addmm at the denoise
    path's shapes; {(name, activation): (ms, plain ms, bound ms, bound by,
    library ms or None, plan)}.  K4 and addmm are timed in turns, K4,
    addmm, addmm, K4, each a median of graph replays, and each time is the
    mean of its two medians.  The replays run back to back on the same
    inputs, so x (37.7 MB at the encoder, the heads' output as large) stays
    warm in the 50 MB L2 for K4 and addmm alike; the denoise path meets x
    fresh from its upload."""
    import torch

    from dca_tpu_torch.ops import fused_dense as fd

    print("phase 2: K4 and addmm are graph replays on the same inputs: x stays warm in the "
          "50 MB L2 for both")
    out = {}
    for i, (name, (B, K, N), bn, act) in enumerate(K4_TIMED):
        x, w, b, stats, _ = _on(dev, dense_inputs(B, K, N, 700 + i, bn, nonneg=name == "head"))

        def kernel():
            return fd._kernel(x, w, b, stats, act, None)

        plain_ms = _device_ms(lambda: fd.fused_dense_reference(x, w, b, bn=stats,
                                                               activation=act))
        lib_ms = None
        if act == "linear" and not bn:
            k1 = _device_ms(kernel)
            l1 = _device_ms(lambda: torch.addmm(b, x, w))
            l2 = _device_ms(lambda: torch.addmm(b, x, w))
            k2 = _device_ms(kernel)
            ms, lib_ms = (k1 + k2) / 2, (l1 + l2) / 2
            turns = (f" (in turns: K4 {k1 * 1e3:.2f}, addmm {l1 * 1e3:.2f}, "
                     f"{l2 * 1e3:.2f}, K4 {k2 * 1e3:.2f} us)")
        else:
            ms = _device_ms(kernel)
            turns = ""
        bound, by, n_bytes, n_ops = k4_bound(B, K, N, bn, act)
        plan = fd.device_plan(B, K, N, dev)
        out[(name, act)] = (ms, plain_ms, bound, by, lib_ms, plan)
        lib = "no single PyTorch call" if lib_ms is None else f"addmm {lib_ms * 1e3:.2f} us"
        print(f"phase 2: K4 {name} ({B}, {K}) x ({K}, {N}), BN {bn}, {act}, "
              f"{_plan_text(B, K, N)}: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, "
              f"{lib}; bound {bound * 1e3:.2f} us by {by}: {n_bytes / 1e6:.1f} MB, "
              f"{n_ops / 1e9:.3f} GFLOP){turns}")
    return out


def phase_timings(dev):
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    B, G = 32, 3451
    n = B * G
    scale = torch.full((1,), 1.0 / n, device=dev)
    out = {}
    for fam, seed in (("nb", 11), ("zinb", 13)):
        y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                         for a in _loss_inputs(B, G, seed,
                                               pi_shape=(B, G) if fam == "zinb" else None))
        yv, muv, thv, piv = (None if a is None else torch.from_numpy(a).to(dev)
                             for a in _loss_inputs(273, G, seed + 1,
                                                   pi_shape=(273, G) if fam == "zinb" else None))
        with_pi = pi is not None
        n_in = 4 if with_pi else 3  # y, mu, theta and pi, each read once
        k1_ms = _device_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1))
        k1_plain_ms = _device_ms(lambda: fl._fwd_reference(y, mu, th, pi, 0.1))
        k2_ms = _device_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, scale))
        k2_plain_ms = _device_ms(lambda: fl._bwd_reference(y, mu, th, pi, 0.1, scale))
        # K1 on the validation split, once per epoch on the main path
        k1_val_ms = _device_ms(lambda: fl._fwd_kernel(yv, muv, thv, piv, 0.1))
        # each input read once, each output written once: K1's sum, count,
        # loss and denominator; K2 also reads the scale and writes 2 or 3
        # (B, G) gradients
        k1_bound, k1_by = _bound_ms(n_in * 4 * n + 4 * 4, _k1_ops(y, mu, th, with_pi))
        k2_bound, k2_by = _bound_ms(n_in * 4 * n + 4 + (n_in - 1) * 4 * n,
                                    _k2_ops(y, mu, th, with_pi))
        k1_val_bound, _ = _bound_ms(n_in * 4 * yv.numel() + 4 * 4,
                                    _k1_ops(yv, muv, thv, with_pi))
        print(f"phase 2: {fam} K1 {k1_ms * 1e3:.2f} us, one launch, loss and denominator "
              f"included (plain "
              f"{k1_plain_ms * 1e3:.2f} us, bound {k1_bound * 1e3:.2f} us by {k1_by}); "
              f"K2 {k2_ms * 1e3:.2f} us (plain {k2_plain_ms * 1e3:.2f} us, bound "
              f"{k2_bound * 1e3:.2f} us by {k2_by}); K1 at (273, {G}) "
              f"{k1_val_ms * 1e3:.2f} us (bound {k1_val_bound * 1e3:.2f} us); no single "
              "PyTorch call computes either function")
        out[f"{fam}_fwd"] = (k1_ms, k1_plain_ms, k1_bound, k1_by,
                             {"val_ms": k1_val_ms, "val_bound_ms": k1_val_bound})
        out[f"{fam}_bwd"] = (k2_ms, k2_plain_ms, k2_bound, k2_by, {})
    return out


def weighted_timings(dev):
    """K1w at the validation block of one of 2 ranks (137, 3451) and K2w at
    the training batch (32, 3451), NB and ZINB, padding weights, with the
    plain versions' times and the bounds; {name: (ms, plain ms, bound ms,
    bound by, extra)}."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    G = 3451
    out = {}
    for fam, seed in (("nb", 21), ("zinb", 23)):
        with_pi = fam == "zinb"
        n_in = 4 if with_pi else 3  # y, mu, theta and pi, each read once
        for kind, B in (("fwd", 137), ("bwd", 32)):
            n = B * G
            y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                             for a in _loss_inputs(B, G, seed, pi_shape=(B, G) if with_pi
                                                   else None))
            w = torch.from_numpy(_weights(B, "padding", seed)).to(dev)
            if kind == "fwd":
                ms = _device_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1, w))
                plain_ms = _device_ms(lambda: fl._fwd_reference(y, mu, th, pi, 0.1, w))
                # the inputs and the weight column read once, the sum, the
                # total weight, the loss and the denominator written; one
                # more multiply per element
                bound, by = _bound_ms(n_in * 4 * n + 4 * B + 4 * 4,
                                      _k1_ops(y, mu, th, with_pi) + n)
            else:
                scale = torch.full((1,), 1.0 / n, device=dev)
                ms = _device_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, scale, w))
                plain_ms = _device_ms(lambda: fl._bwd_reference(y, mu, th, pi, 0.1, scale, w))
                # also the scale read and 2 or 3 (B, G) gradients written;
                # w * scale once more per element
                bound, by = _bound_ms(n_in * 4 * n + 4 * B + 4 + (n_in - 1) * 4 * n,
                                      _k2_ops(y, mu, th, with_pi) + n)
            out[f"{fam}_{kind}_w"] = (ms, plain_ms, bound, by, {"timed_shape": [B, G]})
            print(f"phase 2: {fam} K{1 if kind == 'fwd' else 2}w at {(B, G)}: "
                  f"{ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} "
                  f"us by {by}); no single PyTorch call computes it")
    return out


def _small_counts(n_cells, n_genes, seed):
    rs = np.random.RandomState(seed)
    mu = rs.gamma(2.0, 1.0, size=(1, n_genes)) * rs.lognormal(0.0, 0.3, (n_cells, 1)) * 5
    counts = rs.negative_binomial(2.0, 2.0 / (2.0 + mu)).astype(np.float32)
    counts[rs.uniform(size=counts.shape) < 0.3] = 0.0
    counts[0, :] += 1
    counts[:, 0] += 1
    return counts


LAUNCH_NAMES = [f"{fam}_nll_{kind}{w}" for fam in ("nb", "zinb") for kind in ("fwd", "bwd")
                for w in ("", "_w")]


def _want_launches(likelihood, epochs, steps):
    """What train() on one device launches: per epoch one K1 per step and
    one for the validation split, one K2 per step (train/loop.py), of the
    likelihood's kernel family, and no weighted kernel; normal and poisson
    launch none."""
    want = dict.fromkeys(LAUNCH_NAMES, 0)
    if likelihood in ("nb", "zinb"):
        want[f"{likelihood}_nll_fwd"] = epochs * (steps + 1)
        want[f"{likelihood}_nll_bwd"] = epochs * steps
    return want


def _steps(n_cells, batch=32, val_split=0.1):
    n_full, rem = divmod(int(n_cells * (1.0 - val_split)), batch)
    return n_full + (rem > 0)


ZOO = ["normal", "poisson", "nb", "nb-conddisp", "nb-shared", "nb-fork", "zinb",
       "zinb-conddisp", "zinb-shared", "zinb-fork", "zinb-elempi", "zinb-elempi/sharedpi"]


def phase_zoo():
    """Every architecture: a small fit on the CPU (the kernels' plain
    versions) and on the card (the kernels) from the same weights."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models import core
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.train.loop import train

    epochs, n_cells = 2, 200
    for arch in ZOO:
        name, _, variant = arch.partition("/")
        kw = {"sharedpi": True} if variant == "sharedpi" else {}
        hist = {}
        state = None
        for dev in ("cpu", "cuda"):
            adata = io.normalize(io.read_dataset(AnnData(_small_counts(n_cells, 60, 3))))
            net = AE_types[name](input_size=60, hidden_size=(16, 8, 16), ridge=0.05,
                                 device=dev, **kw).build()
            if state is None:
                state = {k: v.clone() for k, v in net.model.state_dict().items()}
            else:
                net.model.load_state_dict(state)
            fl.reset_launches()
            hist[dev] = train(adata, net, epochs=epochs, verbose=False).history
        launches = dict(fl.launches)
        want = _want_launches(core.LIKELIHOODS[name], epochs, _steps(n_cells))
        _check(launches == want, f"zoo {arch}: launches {launches}, expected {want}")
        for key in ("loss", "val_loss"):
            _check(np.allclose(hist["cuda"][key], hist["cpu"][key], rtol=1e-3, atol=0.0),
                   f"zoo {arch}: {key} on the card {hist['cuda'][key]} vs the CPU "
                   f"{hist['cpu'][key]}, beyond rtol 1e-3")
        print(f"phase 3: zoo {arch}: card loss {hist['cuda']['loss']} vs CPU "
              f"{hist['cpu']['loss']}; launches {launches}")


def phase_api(ae_type, epochs, timed):
    """One dca() run of ``ae_type`` at 2730 x 3451; returns (launches,
    per-epoch seconds or None, the trained network, its loss history)."""
    import torch

    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models import core
    from dca_tpu_torch.ops import fused_loss as fl

    counts = make_paul15_like()
    n_cells, n_genes = counts.shape
    kw = dict(ae_type=ae_type, hidden_size=(64, 32, 64), batch_size=32, copy=True,
              return_info=True)
    t_zero = None
    if timed:
        # warm-up, in latent mode: the denoise run below computes no latent
        lat = dca_tpu_torch.dca(AnnData(counts.copy()), mode="latent", epochs=1, **kw)
        _check(lat.obsm["X_dca"].shape == (n_cells, 32),
               f"X_dca has shape {lat.obsm['X_dca'].shape}, not {(n_cells, 32)}")
        _check(bool(np.isfinite(lat.obsm["X_dca"]).all()), "X_dca is not finite")
        t0 = time.perf_counter()
        dca_tpu_torch.dca(AnnData(counts.copy()), epochs=0, **kw)
        torch.cuda.synchronize()
        t_zero = time.perf_counter() - t0

    fl.reset_launches()
    t0 = time.perf_counter()
    ret, net = dca_tpu_torch.dca(AnnData(counts.copy()), epochs=epochs, verbose=True,
                                 return_model=True, **kw)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(fl.launches)

    hist = ret.uns["dca_loss_history"]
    _check(len(hist["loss"]) == epochs, f"ran {len(hist['loss'])} epochs, not {epochs}")
    _check(np.all(np.isfinite(hist["loss"])) and np.all(np.isfinite(hist["val_loss"])),
           f"loss history not finite: {hist}")
    outputs = [("X", ret.X), ("X_dca_dispersion", ret.obsm["X_dca_dispersion"])]
    if core.LIKELIHOODS[ae_type] == "zinb":
        outputs.append(("X_dca_dropout", ret.obsm["X_dca_dropout"]))
    for name, arr in outputs:
        _check(arr.shape == (n_cells, n_genes),
               f"{ae_type} {name} has shape {arr.shape}, not {(n_cells, n_genes)}")
        _check(bool(np.isfinite(arr).all()), f"{ae_type} {name} is not finite")

    steps = _steps(n_cells)
    want = _want_launches(core.LIKELIHOODS[ae_type], epochs, steps)
    _check(launches == want, f"{ae_type}: kernel launches {launches}, expected {want}")
    per_epoch = None if t_zero is None else (t_run - t_zero) / epochs
    timing = "" if per_epoch is None else (
        f" (predict-only run {t_zero:.3f} s): {per_epoch * 1e3:.1f} ms per epoch")
    print(f"phase 4: dca() {ae_type} {n_cells} x {n_genes}, {epochs} epochs in "
          f"{t_run:.3f} s{timing}, {steps} steps each; launches {launches}")
    return launches, per_epoch, net, hist


def _prepped_paul15():
    """The 2730 x 3451 matrix preprocessed as dca() preprocesses it."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    return io.normalize(io.read_dataset(AnnData(make_paul15_like())),
                        filter_min_counts=False)


def _forward_tolerance(net, x, sf):
    """Elementwise bound on |forward with K4 - forward without| for a
    network of dense relu layers and dense heads (zinb-conddisp): each
    product of K terms is off by at most 2 K 2^-24 (|x| @ |W| + |b|) on the
    two paths together, the error carried in from the layer before goes
    through |W|, the BN scale multiplies both, each elementwise step adds
    4 ulps; relu passes the error on, MeanAct multiplies it by
    mean (e^dz - 1), DispAct's softplus by at most 1, sigmoid by 1/4, and
    the output is mean times sf.  Returns {output key: tolerance}."""
    import torch

    from dca_tpu_torch.models import core

    u = 2.0 ** -24
    d, m = net.definition, net.model
    with torch.no_grad():
        h = torch.tensor(np.asarray(x, np.float32), device=net.device)
        sfc = torch.tensor(sf, device=net.device).reshape(-1, 1)
        err = torch.zeros_like(h)
        tol, val = {}, {}
        for layer in d.shared:
            p = m.trunk[layer.name]
            aw = p.kernel.abs()
            z = h @ p.kernel + p.bias
            dz = err @ aw + 2 * p.kernel.shape[0] * u * (h.abs() @ aw + p.bias.abs())
            if layer.name == "center":
                tol["latent"] = dz + _ulps(z)
            if layer.batchnorm:
                s = torch.rsqrt(p.moving_var + core.BN_EPS)
                dz = dz * s + _ulps(z * s) + _ulps(p.moving_mean * s) + _ulps(p.bn_beta)
                z = (z - p.moving_mean) * s + p.bn_beta
            h, err = torch.relu(z), dz
        for head, key in (("mean", "mean_norm"), ("dispersion", "disp"), ("pi", "pi")):
            p = m.heads[head]
            aw = p.kernel.abs()
            z = h @ p.kernel + p.bias
            dz = err @ aw + 2 * p.kernel.shape[0] * u * (h.abs() @ aw + p.bias.abs()) + _ulps(z)
            v = val[key] = core._HEAD_ACTS[d.heads[head].activation](z)
            gain = {"mean": v * torch.expm1(dz), "disp": dz, "sigmoid": 0.25 * dz}
            tol[key] = gain[d.heads[head].activation] + _ulps(v)
        tol["output"] = tol["mean_norm"] * sfc + _ulps(val["mean_norm"] * sfc)
    return {k: t.cpu().numpy() for k, t in tol.items()}


def phase_denoise(zinb_net, nb_net):
    """The denoise tier at 2730 x 3451 (module docstring, phase 6)."""
    import pandas as pd
    import torch

    from dca_tpu_torch.data import io
    from dca_tpu_torch.ops import fused_dense as fd

    saved = {k: os.environ.get(k) for k in ("DCA_TPU_FUSED_DENSE", "DCA_TPU_WRITE_ALIASES")}
    res = {}
    try:
        adata = _prepped_paul15()
        x, sf = adata.X, io.size_factors(adata)
        n_cells, n_genes = x.shape
        outs = {}
        for mode in ("0", "1"):
            os.environ["DCA_TPU_FUSED_DENSE"] = mode
            zinb_net.forward(x, sf)  # warm-up
            torch.cuda.synchronize()
            fd.reset_launches()
            outs[mode] = zinb_net.forward(x, sf)  # the main path: counted
            res[f"forward_launches_{mode}"] = fd.launches["fused_dense"]
            res["forward_wide"], res["forward_splitk"] = fd.launches["wide"], fd.launches["splitk"]
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                zinb_net.forward(x, sf)
                secs.append(time.perf_counter() - t0)
            res[f"forward_s_{mode}"] = float(np.median(secs))
        _check(res["forward_launches_0"] == 0 and res["forward_launches_1"] == 4
               and (res["forward_splitk"], res["forward_wide"]) == (1, 3),
               f"forward: K4 launches {res['forward_launches_0']} with the switch off "
               f"and {res['forward_launches_1']} on ({res['forward_splitk']} split-K, "
               f"{res['forward_wide']} whole-K), expected 0 and 4 (the encoder split-K; "
               "the mean, dispersion and pi heads whole-K)")
        tol = _forward_tolerance(zinb_net, x, sf)
        worst = 0.0
        for key, t in tol.items():
            on, off = outs["1"][key], outs["0"][key]
            _check(on.shape == off.shape and bool(np.isfinite(on).all()),
                   f"forward with K4: {key} of shape {on.shape} or not finite")
            err = np.abs(on - off)
            _check(bool((err <= t).all()), f"forward with K4: {key} off by {err.max():.3e}, "
                   f"{(err / t).max():.3f} of the propagated tolerance")
            worst = max(worst, float((err / t).max()))
        res["forward_worst"] = worst
        print(f"phase 6: forward zinb-conddisp {n_cells} x {n_genes}: K4 off "
              f"{res['forward_s_0'] * 1e3:.1f} ms, on {res['forward_s_1'] * 1e3:.1f} ms "
              f"(median of 3); K4 launches {res['forward_launches_1']}; outputs agree, worst "
              f"{worst:.3f} of the propagated tolerance")

        # the streaming write, in 3 blocks of at most 1024 rows, with K4
        os.environ["DCA_TPU_WRITE_ALIASES"] = "0"
        out_dir = os.path.join(OUT_DIR, "stream")
        shutil.rmtree(out_dir, ignore_errors=True)
        ad = _prepped_paul15()
        fd.reset_launches()
        t0 = time.perf_counter()
        zinb_net.write_streaming(ad, out_dir, mode="full", return_info=True, chunk_rows=1024)
        res["stream_s"] = time.perf_counter() - t0
        res["stream_launches"] = fd.launches["fused_dense"]
        res["stream_wide"], res["stream_splitk"] = fd.launches["wide"], fd.launches["splitk"]
        _check(res["stream_launches"] == 12
               and (res["stream_splitk"], res["stream_wide"]) == (3, 9),
               f"write_streaming: K4 launches {res['stream_launches']} "
               f"({res['stream_splitk']} split-K), expected 12 (3 blocks x encoder, mean, "
               "dispersion, pi; 3 split-K)")
        files = [("mean.tsv", 0, (n_genes, n_cells)), ("dispersion.tsv", None, (n_genes, n_cells)),
                 ("dropout.tsv", None, (n_genes, n_cells)), ("latent.tsv", None, (n_cells, 32))]
        _check(sorted(os.listdir(out_dir)) == sorted(f for f, _, _ in files),
               f"write_streaming wrote {sorted(os.listdir(out_dir))}")
        for fname, header, shape in files:
            df = pd.read_csv(os.path.join(out_dir, fname), sep="\t", index_col=0, header=header)
            _check(df.shape == shape and bool(np.isfinite(df.to_numpy()).all()),
                   f"write_streaming {fname}: shape {df.shape}, expected {shape}, or not finite")
        # the first genes of mean.tsv: the in-memory output of the same
        # blocks, printed to 6 decimals
        ref = zinb_net.forward(x, sf, chunk_rows=1024, keys=("output",))["output"]
        with open(os.path.join(out_dir, "mean.tsv")) as f:
            f.readline()
            for g in range(5):
                fields = f.readline().rstrip("\n").split("\t")
                _check(fields[0] == ad.var_names[g]
                       and fields[1:] == ["%.6f" % v for v in ref[:, g]],
                       f"mean.tsv gene {g} differs from the in-memory output")
        print(f"phase 6: write_streaming zinb-conddisp full, 3 blocks of <= 1024 rows, "
              f"no aliases: {res['stream_s']:.2f} s; K4 launches {res['stream_launches']}; "
              f"{', '.join(f for f, _, _ in files)} of the right shapes, finite, and the "
              "first 5 genes of mean.tsv equal to the in-memory output to 6 decimals")
        shutil.rmtree(out_dir)

        # nb-conddisp predict: the denoise, then the dispersion from it
        os.environ["DCA_TPU_FUSED_DENSE"] = "1"
        ad = _prepped_paul15()
        fd.reset_launches()
        nb_net.predict(ad, mode="denoise", return_info=True)
        res["nb_predict_launches"] = fd.launches["fused_dense"]
        res["nb_predict_wide"] = fd.launches["wide"]
        res["nb_predict_splitk"] = fd.launches["splitk"]
        _check(res["nb_predict_launches"] == 4 and res["nb_predict_splitk"] == 2,
               f"nb-conddisp predict: K4 launches {res['nb_predict_launches']}, expected 4 "
               "(encoder and mean head, then encoder and dispersion head)")
        for name, arr in (("X", ad.X), ("X_dca_dispersion", ad.obsm["X_dca_dispersion"])):
            _check(arr.shape == (n_cells, n_genes) and bool(np.isfinite(arr).all()),
                   f"nb-conddisp predict {name}: shape {arr.shape} or not finite")
        print(f"phase 6: nb-conddisp predict(return_info=True) with K4: launches "
              f"{res['nb_predict_launches']}, outputs finite")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return res


def phase_cli():
    import pandas as pd

    work = os.path.join(OUT_DIR, "cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    counts = _small_counts(300, 120, 5)  # cells x genes
    tsv = os.path.join(work, "counts.tsv")
    pd.DataFrame(counts.T.astype(int), index=[f"gene{i}" for i in range(120)],
                 columns=[f"cell{i}" for i in range(300)]).to_csv(tsv, sep="\t")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the last run goes through the streaming write, with K4
    stream_env = {"DCA_TPU_HOST_DENSE_BYTES": "1", "DCA_TPU_FUSED_DENSE": "1"}
    for ae_type, label, extra in (("nb-conddisp", "nb-conddisp", {}),
                                  ("zinb-conddisp", "zinb-conddisp", {}),
                                  ("zinb", "zinb", {}),
                                  ("zinb-conddisp", "zinb-conddisp-stream", stream_env)):
        out = os.path.join(work, label)
        proc = subprocess.run([sys.executable, "-m", "dca_tpu_torch", tsv, out, "-e", "2",
                               "--type", ae_type],
                              cwd=REPO, env=dict(env, **extra), capture_output=True,
                              text=True, timeout=600)
        _check(proc.returncode == 0, f"CLI {label} exited {proc.returncode}:\n"
               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        _check(("[streaming]" in proc.stdout) == bool(extra),
               f"CLI {label}: the streaming write ran where it should not, or the reverse")
        files = [("mean.tsv", 0, (120, 300)), ("mean_norm.tsv", 0, (120, 300)),
                 ("dispersion.tsv", None, (120, 1 if ae_type == "zinb" else 300)),
                 ("latent.tsv", None, (300, 32)), ("reduced.tsv", None, (300, 32))]
        if ae_type != "nb-conddisp":
            files += [("dropout.tsv", None, (120, 300)), ("pi.tsv", None, (120, 300))]
        for fname, header, shape in files:
            df = pd.read_csv(os.path.join(out, fname), sep="\t", index_col=0, header=header)
            _check(df.shape == shape, f"CLI {label} {fname} has shape {df.shape}, "
                   f"not {shape}")
            _check(bool(np.isfinite(df.to_numpy()).all()),
                   f"CLI {label} {fname} is not finite")
        _check(os.path.exists(os.path.join(out, "model.pickle")),
               f"CLI {label}: no model.pickle")
        print(f"phase 5: CLI {label}{' ' + str(extra) if extra else ''} on the card wrote "
              f"{', '.join(f for f, _, _ in files)} and model.pickle, all finite")
    shutil.rmtree(work)


DP_RANKS = 2
DP_TIMEOUT = 480  # seconds for both ranks, start-up included
DP_RUNS = (("zinb-conddisp", 2), ("nb-conddisp", 1))


def _dp_rank(rank, world, port, out_dir, backend):
    """One rank of phase 7, in a process of its own: join the group (gloo
    on the one card, or NCCL with a card a rank), run
    ``dca(devices="all")`` for each of DP_RUNS
    (zinb-conddisp after an untimed warm-up fit and a timed epochs=0 run), save
    the model on rank 0, and leave the history, launches, times and the
    denoised matrix in ``out_dir``."""
    import torch

    sys.path.insert(0, REPO)
    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend=backend)
    counts = make_paul15_like()
    kw = dict(hidden_size=(64, 32, 64), batch_size=32, copy=True, return_info=True,
              return_model=True, devices="all")
    res = {}
    for ae_type, epochs in DP_RUNS:
        files = os.path.join(out_dir, f"{ae_type}-rank{rank}")
        t_zero = None
        if ae_type == "zinb-conddisp":
            # a warm-up fit first: the collectives' and the libraries' set-up
            # is paid there, not in the epochs=0 run that is subtracted
            dca_tpu_torch.dca(AnnData(counts.copy()), ae_type=ae_type, epochs=1, **kw)
            t0 = time.perf_counter()
            dca_tpu_torch.dca(AnnData(counts.copy()), ae_type=ae_type, epochs=0, **kw)
            torch.cuda.synchronize()
            t_zero = time.perf_counter() - t0
        fl.reset_launches()
        t0 = time.perf_counter()
        ret, net = dca_tpu_torch.dca(AnnData(counts.copy()), ae_type=ae_type, epochs=epochs,
                                     network_kwds={"file_path": files}, **kw)
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        launches = dict(fl.launches)
        net.save()  # with the trained parameters: rank 0 alone writes
        np.save(os.path.join(out_dir, f"denoised-{ae_type}-rank{rank}.npy"), ret.X)
        res[ae_type] = {"history": ret.uns["dca_loss_history"], "launches": launches,
                        "t_run": t_run, "t_zero": t_zero}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_data_parallel(single_hist, n_ranks=DP_RANKS, backend="gloo", val_rtol=1e-3):
    """Phase 7: the data-parallel fit, by default 2 ranks on the one card
    over gloo (module docstring; ``chip_dp.py`` runs it with a card a rank
    over NCCL).  ``single_hist``: phase 4's zinb-conddisp history, which
    the loss must match within rtol 1e-3 and val_loss within
    ``val_rtol``.  Returns each run's per-rank launches and the per-epoch
    time."""
    import multiprocessing

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"phase 7: compute mode {mode!r}; {n_ranks} ranks, backend {backend}")
    out_dir = os.path.join(OUT_DIR, "dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context("spawn")  # CUDA does not survive fork
    port = _free_port()
    procs = [ctx.Process(target=_dp_rank, args=(r, n_ranks, port, out_dir, backend))
             for r in range(n_ranks)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        _check(not hung, f"phase 7: ranks {hung} still running after {DP_TIMEOUT} s")
        codes = [p.exitcode for p in procs]
        _check(codes == [0] * n_ranks, f"phase 7: ranks exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # every rank has rows in every step (the trailing 25 rows split 13/12,
    # or 7/7/7/4 on 4 ranks); 273 validation rows need padding for 2 or 4
    want = {"zinb-conddisp": {"zinb_nll_fwd": 154, "zinb_nll_bwd": 154, "zinb_nll_fwd_w": 2},
            "nb-conddisp": {"nb_nll_fwd": 77, "nb_nll_bwd": 77, "nb_nll_fwd_w": 1}}
    out = {}
    for ae_type, epochs in DP_RUNS:
        runs = [rk[ae_type] for rk in ranks]
        hist = runs[0]["history"]
        for rk, run in enumerate(runs[1:], 1):
            _check(run["history"] == hist,
                   f"phase 7 {ae_type}: rank {rk}'s history {run['history']} differs from rank "
                   f"0's {hist}")
        expect = dict(dict.fromkeys(LAUNCH_NAMES, 0), **want[ae_type])
        for rk, run in enumerate(runs):
            _check(run["launches"] == expect, f"phase 7 {ae_type}: rank {rk} launched "
                   f"{run['launches']}, expected {expect}")
        _check(len(hist["loss"]) == epochs and np.all(np.isfinite(hist["loss"]))
               and np.all(np.isfinite(hist["val_loss"])), f"phase 7 {ae_type}: history {hist}")
        if ae_type == "zinb-conddisp":
            # same seed and initial weights as phase 4; the sums run in
            # another order over the ranks, and the difference grows over
            # the RMSprop steps
            rel = {}
            for key, rtol in (("loss", 1e-3), ("val_loss", val_rtol)):
                ref = np.asarray(single_hist[key][:epochs])
                rel[key] = float(np.max(np.abs(np.asarray(hist[key]) - ref) / np.abs(ref)))
                _check(rel[key] <= rtol, f"phase 7: {key} {hist[key]} vs phase 4's "
                       f"{ref.tolist()}, relative difference {rel[key]:.3e} > {rtol}")
            print(f"phase 7: zinb-conddisp against phase 4's first {epochs} epochs "
                  f"{single_hist['loss'][:epochs]} / {single_hist['val_loss'][:epochs]}: largest "
                  f"relative difference {rel['loss']:.3e} (loss), {rel['val_loss']:.3e} (val_loss)")
        den = [np.load(os.path.join(out_dir, f"denoised-{ae_type}-rank{r}.npy"))
               for r in range(n_ranks)]
        _check(den[0].shape == (2730, 3451) and bool(np.isfinite(den[0]).all()),
               f"phase 7 {ae_type}: denoised matrix of shape {den[0].shape} or not finite")
        _check(all(np.array_equal(d, den[0]) for d in den[1:]),
               f"phase 7 {ae_type}: the ranks' denoised matrices differ")
        written = [os.path.exists(os.path.join(out_dir, f"{ae_type}-rank{r}"))
                   for r in range(n_ranks)]
        _check(os.path.exists(os.path.join(out_dir, f"{ae_type}-rank0", "model.pickle"))
               and not any(written[1:]), f"phase 7 {ae_type}: written by ranks {written}")
        out[ae_type] = [run["launches"] for run in runs]
        print(f"phase 7: {ae_type} {epochs} epochs on {n_ranks} ranks: loss {hist['loss']}, "
              f"val_loss {hist['val_loss']}, the same on every rank; per-rank launches "
              f"{runs[0]['launches']}; denoised matrices equal and finite; rank 0 alone wrote")
    zinb = ranks[0]["zinb-conddisp"]
    out["per_epoch_s"] = (zinb["t_run"] - zinb["t_zero"]) / DP_RUNS[0][1]
    print(f"phase 7: data-parallel zinb-conddisp epoch {out['per_epoch_s'] * 1e3:.1f} ms on "
          f"rank 0 ({n_ranks} ranks over {backend}"
          f"{': sharing one card, this measures no scaling' if backend == 'gloo' else ''})")
    shutil.rmtree(out_dir)
    return out


def _card():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    _check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import dca_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    try:
        phase_build()
        worst = phase_compare(dev)
        worst_w = phase_weighted_compare(dev)
        dense_err = phase_dense_compare(dev)
        times = phase_timings(dev)
        times.update(weighted_timings(dev))
        dense_times = dense_timings(dev)
        phase_zoo()
        launches, per_epoch, zinb_net, zinb_hist = phase_api("zinb-conddisp", 5, timed=True)
        nb_launches, _, nb_net, _ = phase_api("nb-conddisp", 2, timed=False)
        launches.update({k: v for k, v in nb_launches.items() if k.startswith("nb_")})
        phase_cli()
        den = phase_denoise(zinb_net, nb_net)
        dp = phase_data_parallel(zinb_hist)
        card = _card()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    shapes = ", ".join(str(s) for s, _, _ in COMPARE_SHAPES)
    kernels = []
    for fam in ("nb", "zinb"):
        cases = ("theta (B, G), (1, G), (B, 1)" if fam == "nb" else
                 "theta/pi (B, G)/(B, G) at ridge 0 and 0.1, (1, G)/(B, G), "
                 "(B, 1)/(B, 1), (1, G)/(1, G), (B, 1)/(1, G) at ridge 0.1")
        for kind, line, err, tol in (
            ("fwd", 143, worst[fam]["fwd_abs"], f"loss rel err <= {LOSS_RTOL}, count exact"),
            ("bwd", 177, worst[fam]["bwd_abs"],
             f"unscaled grads rtol {GRAD_RTOL}, atol {GRAD_ATOL} + {GRAD_ULPS} ulps "
             "of the terms, summed for broadcast operands"),
        ):
            ms, plain_ms, bound_ms, bound_by, extra = times[f"{fam}_{kind}"]
            name = f"{fam}_nll_{kind}"
            kernels.append({
                "name": name, "route": "cuda",
                "source": "dca_tpu_torch/csrc/fused_nll.cu",
                "replaces": f"dca_tpu/ops/fused_loss.py:{line}",
                "launches": launches[name], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "timed_shape": [32, 3451],
                "checked_shapes": f"{shapes}; {cases}", "tolerance": tol, "card": card,
                **extra,
            })
    for fam in ("nb", "zinb"):
        dp_launches = dp[f"{fam}-conddisp"]
        for kind, line, err, tol in (
            ("fwd", 158, worst_w[fam]["fwd_abs"],
             f"loss rel err <= {LOSS_RTOL}; total weight exact for 0/1 weights, rel err <= "
             f"{LOSS_RTOL} for fractional ones, 1 for all-zero weights"),
            ("bwd", 191, worst_w[fam]["bwd_abs"],
             f"unscaled grads rtol {GRAD_RTOL}, atol {GRAD_ATOL} + {GRAD_ULPS} ulps of the "
             "weighted terms; exactly 0 on zero-weight rows and at NaN targets"),
        ):
            ms, plain_ms, bound_ms, bound_by, extra = times[f"{fam}_{kind}_w"]
            name = f"{fam}_nll_{kind}_w"
            per_rank = [rk[name] for rk in dp_launches]
            entry = {
                "name": name, "route": "cuda", "source": "dca_tpu_torch/csrc/fused_nll.cu",
                "replaces": f"dca_tpu/ops/fused_loss.py:{line}",
                "launches": sum(per_rank), "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "launches_per_rank": per_rank,
                "main_path": f"phase 7: {fam}-conddisp data parallel on {DP_RANKS} ranks",
                "checked_shapes": f"{', '.join(str(sh) for sh, _, _ in WEIGHTED_SHAPES)}; the "
                                  f"theta/pi cases of K1/K2; weights {', '.join(WEIGHT_KINDS)}",
                "tolerance": tol, "card": card, **extra,
            }
            if kind == "bwd":
                entry["not_launched_because"] = (
                    "no path of the fit differentiates a weighted loss: the weighted "
                    "validation is evaluated without gradients, as in the JAX package, "
                    "where only TensorBoard's gradients of a padded run launch it (not ported)")
            kernels.append(entry)
    timings = {f"{name} {act}": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms"), t[:5]), plan=t[5]._asdict())
               for (name, act), t in dense_times.items()}
    for name, entry, shape, kind in (("fused_dense", "head", [2730, 64, 3451], "wide"),
                                     ("fused_dense_encoder", "encoder", [2730, 3451, 64],
                                      "splitk")):
        ms, plain_ms, bound_ms, bound_by, library_ms, plan = dense_times[(entry, "linear")]
        kernels.append({
            "name": name, "route": "cuda", "source": "dca_tpu_torch/csrc/fused_dense.cu",
            "replaces": "dca_tpu/ops/fused_dense.py:63",
            "launches": den[f"forward_{kind}"] + den[f"stream_{kind}"],
            "max_abs_err": dense_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "timed_shape": shape, "timed_epilogue": "linear (library: torch.addmm)",
            "plan": plan._asdict(), "timings": timings,
            "launches_by_run": {"forward": den[f"forward_{kind}"],
                                "write_streaming": den[f"stream_{kind}"],
                                "nb_predict": den[f"nb_predict_{kind}"]},
            "checked_shapes": "; ".join(f"{n} {sh}" for n, sh, *_ in DENSE_CASES),
            "tolerance": "linear: 2 K 2^-24 (|x|@|W| + |b|) |s| + 4 ulps; activations: 4 "
                         "ulps of the plain activation of the kernel's linear output",
            "card": card,
        })
    print(f"per-epoch time {per_epoch * 1e3:.1f} ms (dca() 2730 x 3451, zinb-conddisp "
          f"64-32-64, batch 32) on {card}")
    print(f"data-parallel per-epoch time {dp['per_epoch_s'] * 1e3:.1f} ms on rank 0 (the same "
          f"fit on {DP_RANKS} ranks sharing the one card through gloo: no scaling measured) "
          f"on {card}")
    print(f"denoise tier (2730 x 3451, zinb-conddisp) on {card}: forward "
          f"{den['forward_s_0'] * 1e3:.1f} ms without K4, {den['forward_s_1'] * 1e3:.1f} ms "
          f"with; write_streaming {den['stream_s']:.2f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
