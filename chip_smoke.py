#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dca_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. Build and launch: build the CUDA kernels from ``dca_tpu_torch/csrc``
   and hold each one against its plain PyTorch version, on the same CUDA
   tensors, at the shapes of the main paths: the full and trailing training
   batches (32, 3451) and (25, 3451), the validation split (273, 3451), and
   a ragged (7, 50) with 10% NaN targets and clipped theta.  At each shape:
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
2. Kernel timings at (32, 3451), NB and ZINB: median device time of 50
   launches after a warm-up, each launch a CUDA graph replay between CUDA
   events (see ``_device_ms``); beside them the plain version's time and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 67 TFLOP/s float32).  K1 also at the validation split (273, 3451).
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
   values finite).

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


def k4_bound():
    """The bound of K4 (``dca_tpu/ops/fused_dense.py::_kernel``, not ported:
    opt-in in the JAX package and off at every width) at the main path's
    predict: the 64 -> 3451 mean head over 2730 rows, act(x @ W + b) * sf.
    Bytes: x, W, b, the folded BN's s and t, sf read once, the (2730, 3451)
    output written once; operations: 2 per multiply-add of the product.
    Returns (bound ms, bound by, bytes, operations)."""
    rows, k, n = 2730, 64, 3451
    n_bytes = 4 * (rows * k + k * n + 3 * n + rows + rows * n)
    n_ops = 2.0 * rows * k * n
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
            if "ptxas info" in line and ("registers" in line or "Compiling" in line):
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
        # each input read once, each output written once: the loss and its
        # count; K2 also reads the scale and writes 2 or 3 (B, G) gradients
        k1_bound, k1_by = _bound_ms(n_in * 4 * n + 2 * 4, _k1_ops(y, mu, th, with_pi))
        k2_bound, k2_by = _bound_ms(n_in * 4 * n + 4 + (n_in - 1) * 4 * n,
                                    _k2_ops(y, mu, th, with_pi))
        k1_val_bound, _ = _bound_ms(n_in * 4 * yv.numel() + 2 * 4,
                                    _k1_ops(yv, muv, thv, with_pi))
        print(f"phase 2: {fam} K1 {k1_ms * 1e3:.2f} us with its partial sum (plain "
              f"{k1_plain_ms * 1e3:.2f} us, bound {k1_bound * 1e3:.2f} us by {k1_by}); "
              f"K2 {k2_ms * 1e3:.2f} us (plain {k2_plain_ms * 1e3:.2f} us, bound "
              f"{k2_bound * 1e3:.2f} us by {k2_by}); K1 at (273, {G}) "
              f"{k1_val_ms * 1e3:.2f} us (bound {k1_val_bound * 1e3:.2f} us); no single "
              "PyTorch call computes either function")
        out[f"{fam}_fwd"] = (k1_ms, k1_plain_ms, k1_bound, k1_by,
                             {"val_ms": k1_val_ms, "val_bound_ms": k1_val_bound})
        out[f"{fam}_bwd"] = (k2_ms, k2_plain_ms, k2_bound, k2_by, {})
    k4_ms, k4_by, k4_bytes, k4_ops = k4_bound()
    print(f"phase 2: K4 (fused dense, not ported) at the predict head (2730, 64) x "
          f"(64, 3451): {k4_bytes / 1e6:.1f} MB, {k4_ops / 1e9:.3f} GFLOP, bound "
          f"{k4_ms * 1e3:.2f} us by {k4_by}")
    return out


def _small_counts(n_cells, n_genes, seed):
    rs = np.random.RandomState(seed)
    mu = rs.gamma(2.0, 1.0, size=(1, n_genes)) * rs.lognormal(0.0, 0.3, (n_cells, 1)) * 5
    counts = rs.negative_binomial(2.0, 2.0 / (2.0 + mu)).astype(np.float32)
    counts[rs.uniform(size=counts.shape) < 0.3] = 0.0
    counts[0, :] += 1
    counts[:, 0] += 1
    return counts


def _want_launches(likelihood, epochs, steps):
    """What train() launches: per epoch one K1 per step and one for the
    validation split, one K2 per step (train/loop.py), of the likelihood's
    kernel family; normal and poisson launch none."""
    want = {"nb_nll_fwd": 0, "nb_nll_bwd": 0, "zinb_nll_fwd": 0, "zinb_nll_bwd": 0}
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
    per-epoch seconds or None)."""
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
    ret = dca_tpu_torch.dca(AnnData(counts.copy()), epochs=epochs, verbose=True, **kw)
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
    return launches, per_epoch


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
    for ae_type in ("nb-conddisp", "zinb-conddisp", "zinb"):
        out = os.path.join(work, ae_type)
        proc = subprocess.run([sys.executable, "-m", "dca_tpu_torch", tsv, out, "-e", "2",
                               "--type", ae_type],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        _check(proc.returncode == 0, f"CLI --type {ae_type} exited {proc.returncode}:\n"
               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        files = [("mean.tsv", 0, (120, 300)), ("mean_norm.tsv", 0, (120, 300)),
                 ("dispersion.tsv", None, (120, 1 if ae_type == "zinb" else 300)),
                 ("latent.tsv", None, (300, 32)), ("reduced.tsv", None, (300, 32))]
        if ae_type != "nb-conddisp":
            files += [("dropout.tsv", None, (120, 300)), ("pi.tsv", None, (120, 300))]
        for fname, header, shape in files:
            df = pd.read_csv(os.path.join(out, fname), sep="\t", index_col=0, header=header)
            _check(df.shape == shape, f"--type {ae_type} {fname} has shape {df.shape}, "
                   f"not {shape}")
            _check(bool(np.isfinite(df.to_numpy()).all()),
                   f"--type {ae_type} {fname} is not finite")
        _check(os.path.exists(os.path.join(out, "model.pickle")),
               f"--type {ae_type}: no model.pickle")
        print(f"phase 5: CLI --type {ae_type} on the card wrote "
              f"{', '.join(f for f, _, _ in files)} and model.pickle, all finite")
    shutil.rmtree(work)


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
        times = phase_timings(dev)
        phase_zoo()
        launches, per_epoch = phase_api("zinb-conddisp", 5, timed=True)
        nb_launches, _ = phase_api("nb-conddisp", 2, timed=False)
        launches.update({k: v for k, v in nb_launches.items() if k.startswith("nb_")})
        phase_cli()
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
    print(f"per-epoch time {per_epoch * 1e3:.1f} ms (dca() 2730 x 3451, zinb-conddisp "
          f"64-32-64, batch 32) on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
