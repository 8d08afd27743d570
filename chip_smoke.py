#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dca_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which must pass:

1. Build and launch: build the CUDA kernels from ``dca_tpu_torch/csrc``
   and hold each one against its plain PyTorch version, on the same CUDA
   tensors, at the shapes of the main path: the full and trailing training
   batches (32, 3451) and (25, 3451), the validation split (273, 3451), and
   a ragged (7, 50) with 10% NaN targets and clipped theta.  Tolerances:
   loss relative error <= 1e-5 (the kernel sums in another order than
   torch.sum); gradients elementwise, stated on the unscaled gradient (the
   path's gradients carry g / denom, about 1e-6 at (273, 3451)): rtol 1e-4,
   atol 1e-6 plus 4 float32 ulps of the sum of the magnitudes of the terms
   the formula adds (``fused_loss.grad_term_magnitudes``), since both sides
   round those terms in float32 and, where y is large and theta small, they
   cancel to a far smaller result.
2. Kernel timings at (32, 3451): median device time of 50 launches after a
   warm-up, each launch a CUDA graph replay between CUDA events (see
   ``_device_ms``); beside them the plain version's time and the least time
   the card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s
   float32).
3. API run: ``dca_tpu_torch.dca`` on a 2730 x 3451 Paul15-shaped matrix,
   nb-conddisp 64-32-64, batch 32, 5 epochs, on the card; outputs finite
   and of the right shapes, and the kernels' launch counters equal to what
   the main path must launch.  Before it, a small training run on the CPU
   and on the card from the same weights must agree epoch by epoch.
4. CLI run: ``python -m dca_tpu_torch counts.tsv out/ -e 2`` on the card,
   and the output contract (mean, mean_norm, latent, reduced, dispersion
   TSVs and model.pickle, all values finite).

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


def _loss_inputs(B, G, seed, nan_frac=0.0, n_clipped=0):
    """y, mu, theta as the main path gives them: NB counts, means and
    dispersions inside the output heads' clips."""
    rs = np.random.RandomState(seed)
    mu = rs.lognormal(0.0, 1.0, size=(B, G)).clip(1e-5, 1e6).astype(np.float32)
    th = rs.lognormal(0.5, 1.0, size=(B, G)).clip(1e-4, 1e4).astype(np.float32)
    y = rs.negative_binomial(th, th / (th + mu)).astype(np.float32)
    if nan_frac:
        y[rs.uniform(size=y.shape) < nan_frac] = np.nan
    if n_clipped:
        flat = th.reshape(-1)
        flat[rs.choice(flat.size, n_clipped, replace=False)] = 2e6
    return y, mu, th


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------


def _pushes(x):
    """Recurrence steps the Stirling functions take at x (z < 8 tests)."""
    import torch

    return torch.clamp(torch.ceil(8.0 - x), 0.0, 8.0)


def _k1_ops(y, mu, th):
    """Operations of K1 on these inputs, counted from the kernel source
    with a transcendental as one: 22 + 3 k per log Gamma (k recurrence
    steps), 27 around them."""
    import torch

    y0 = torch.nan_to_num(y, nan=0.0)
    t = torch.clamp(th, max=1e6)
    k = _pushes(t + 1e-10) + _pushes(y0 + 1.0) + _pushes(y0 + t + 1e-10)
    return float(y.numel() * (27 + 3 * 22) + 3 * k.sum().item())


def _k2_ops(y, mu, th):
    """Operations of K2: 21 + 3 k per digamma, 28 around the two."""
    import torch

    y0 = torch.nan_to_num(y, nan=0.0)
    t = torch.clamp(th, max=1e6) + 1e-10
    k = _pushes(t) + _pushes(y0 + t)
    return float(y.numel() * (28 + 2 * 21) + 3 * k.sum().item())


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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


def phase_compare(dev):
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    shapes = [((32, 3451), 0.0, 0), ((25, 3451), 0.0, 0), ((273, 3451), 0.0, 0),
              ((7, 50), 0.1, 3)]
    worst = {"fwd_abs": 0.0, "fwd_rel": 0.0, "bwd_abs": 0.0, "bwd_tol": 0.0}
    for seed, ((B, G), nan_frac, n_clipped) in enumerate(shapes):
        y, mu, th = (torch.from_numpy(a).to(dev)
                     for a in _loss_inputs(B, G, seed, nan_frac, n_clipped))
        mu.requires_grad_(True)
        th.requires_grad_(True)
        loss = fl.nb_nll_fused(y, mu, th)  # K1
        dmu, dth = torch.autograd.grad(loss, (mu, th))  # K2
        again = fl.nb_nll_fused(y, mu, th)
        _check(torch.equal(loss, again), f"K1 is not deterministic at {(B, G)}")
        with torch.no_grad():
            ref, denom = fl.nb_nll_fwd_reference(y, mu, th)
            scale = 1.0 / denom  # what the path multiplies the gradients by
            rmu, rth = fl.nb_nll_bwd_reference(y, mu, th, scale)
            mag_mu, mag_th = fl.grad_term_magnitudes(y, mu, th)
        fwd_abs = abs(loss.item() - ref.item())
        fwd_rel = fwd_abs / abs(ref.item())
        _check(np.isfinite(loss.item()), f"K1 loss not finite at {(B, G)}")
        _check(fwd_rel <= LOSS_RTOL,
               f"K1 at {(B, G)}: loss {loss.item()!r} vs plain {ref.item()!r}, "
               f"relative error {fwd_rel:.3e} > {LOSS_RTOL}")
        for name, got, want, mag in (("d mu", dmu, rmu, mag_mu),
                                     ("d theta", dth, rth, mag_th)):
            _check(bool(torch.isfinite(got).all()), f"K2 {name} not finite at {(B, G)}")
            err = (got - want).abs() / scale  # unscaled
            tol = GRAD_ATOL + GRAD_ULPS * F32_EPS * mag + GRAD_RTOL * (want / scale).abs()
            bad = err > tol
            _check(not bool(bad.any()),
                   f"K2 {name} at {(B, G)}: {int(bad.sum())} elements outside "
                   f"rtol {GRAD_RTOL}, atol {GRAD_ATOL} + {GRAD_ULPS} ulps of the "
                   f"terms; max unscaled error {err.max().item():.3e}")
            worst["bwd_abs"] = max(worst["bwd_abs"], err.max().item())
            worst["bwd_tol"] = max(worst["bwd_tol"], (err / tol).max().item())
        worst["fwd_abs"] = max(worst["fwd_abs"], fwd_abs)
        worst["fwd_rel"] = max(worst["fwd_rel"], fwd_rel)
        print(f"phase 1: {(B, G)} loss {loss.item():.6f} (plain {ref.item():.6f}, "
              f"rel err {fwd_rel:.2e})")
    print(f"phase 1: worst K1 loss error {worst['fwd_abs']:.3e} abs, "
          f"{worst['fwd_rel']:.3e} rel; worst K2 unscaled gradient error "
          f"{worst['bwd_abs']:.3e} abs, {worst['bwd_tol']:.3f} of its tolerance")
    return worst


def phase_timings(dev):
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    B, G = 32, 3451
    y, mu, th = (torch.from_numpy(a).to(dev) for a in _loss_inputs(B, G, 11))
    n = B * G
    scale = torch.full((1,), 1.0 / n, device=dev)
    k1_ms = _device_ms(lambda: fl.nb_nll_fwd_kernel(y, mu, th))
    k1_plain_ms = _device_ms(lambda: fl.nb_nll_fwd_reference(y, mu, th))
    k2_ms = _device_ms(lambda: fl.nb_nll_bwd_kernel(y, mu, th, scale))
    k2_plain_ms = _device_ms(lambda: fl.nb_nll_bwd_reference(y, mu, th, scale))
    # K1 on the validation split, once per epoch on the main path
    yv, muv, thv = (torch.from_numpy(a).to(dev) for a in _loss_inputs(273, G, 12))
    k1_val_ms = _device_ms(lambda: fl.nb_nll_fwd_kernel(yv, muv, thv))
    # each input read once, each output written once
    k1_bound, k1_by = _bound_ms(3 * 4 * n + 2 * 4, _k1_ops(y, mu, th))
    k2_bound, k2_by = _bound_ms(3 * 4 * n + 4 + 2 * 4 * n, _k2_ops(y, mu, th))
    k1_val_bound, _ = _bound_ms(3 * 4 * yv.numel() + 2 * 4, _k1_ops(yv, muv, thv))
    print(f"phase 2: K1 {k1_ms * 1e3:.2f} us with its partial sum "
          f"(plain {k1_plain_ms * 1e3:.2f} us, bound {k1_bound * 1e3:.2f} us by {k1_by}); K2 {k2_ms * 1e3:.2f} us "
          f"(plain {k2_plain_ms * 1e3:.2f} us, bound {k2_bound * 1e3:.2f} us by "
          f"{k2_by}); K1 at (273, {G}) {k1_val_ms * 1e3:.2f} us (bound "
          f"{k1_val_bound * 1e3:.2f} us); no single PyTorch call computes either "
          "function")
    return {"fwd": (k1_ms, k1_plain_ms, k1_bound, k1_by),
            "bwd": (k2_ms, k2_plain_ms, k2_bound, k2_by),
            "fwd_extra": {"val_ms": k1_val_ms, "val_bound_ms": k1_val_bound}}


def _small_counts(n_cells, n_genes, seed):
    rs = np.random.RandomState(seed)
    mu = rs.gamma(2.0, 1.0, size=(1, n_genes)) * rs.lognormal(0.0, 0.3, (n_cells, 1)) * 5
    counts = rs.negative_binomial(2.0, 2.0 / (2.0 + mu)).astype(np.float32)
    counts[rs.uniform(size=counts.shape) < 0.3] = 0.0
    counts[0, :] += 1
    counts[:, 0] += 1
    return counts


def phase_cpu_reference():
    """A small fit on the CPU (the kernels' plain versions) and on the card
    (the kernels) from the same weights: losses must agree epoch by epoch
    within rtol 1e-3 (matrix products and sums run in another order on the
    two devices, and the difference grows over the RMSprop steps)."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import NBAutoencoder
    from dca_tpu_torch.train.loop import train

    hist = {}
    state = None
    for dev in ("cpu", "cuda"):
        adata = io.normalize(io.read_dataset(AnnData(_small_counts(200, 60, 3))))
        net = NBAutoencoder(input_size=60, hidden_size=(16, 8, 16), device=dev).build()
        if state is None:
            state = {k: v.clone() for k, v in net.model.state_dict().items()}
        else:
            net.model.load_state_dict(state)
        hist[dev] = train(adata, net, epochs=3, verbose=False).history
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key], rtol=1e-3,
                                   err_msg=f"{key}: card vs CPU")
    print(f"phase 3: small fit, card vs CPU: loss {hist['cuda']['loss']} vs "
          f"{hist['cpu']['loss']}")


def phase_api():
    import torch

    import dca_tpu_torch
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.ops import fused_loss as fl

    counts = make_paul15_like()
    n_cells, n_genes = counts.shape
    epochs, batch, val_split = 5, 32, 0.1
    kw = dict(hidden_size=(64, 32, 64), batch_size=batch, copy=True,
              return_info=True)

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
    for name, arr, shape in (("X", ret.X, (n_cells, n_genes)),
                             ("X_dca_dispersion", ret.obsm["X_dca_dispersion"],
                              (n_cells, n_genes))):
        _check(arr.shape == shape, f"{name} has shape {arr.shape}, not {shape}")
        _check(bool(np.isfinite(arr).all()), f"{name} is not finite")

    # what train() launches: per epoch one K1 per step and one for the
    # validation split, one K2 per step (train/loop.py)
    n_train = int(n_cells * (1.0 - val_split))
    n_full, rem = divmod(n_train, batch)
    steps = n_full + (rem > 0)
    want = {"nb_nll_fwd": epochs * (steps + 1), "nb_nll_bwd": epochs * steps}
    _check(launches == want, f"kernel launches {launches}, expected {want}")
    per_epoch = (t_run - t_zero) / epochs
    print(f"phase 3: dca() {n_cells} x {n_genes}, {epochs} epochs in {t_run:.3f} s "
          f"(predict-only run {t_zero:.3f} s): {per_epoch * 1e3:.1f} ms per epoch, "
          f"{steps} steps each; launches {launches}")
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
    out = os.path.join(work, "out")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "dca_tpu_torch", tsv, out, "-e", "2"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0,
           f"CLI exited {proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for fname, header, shape in (("mean.tsv", 0, (120, 300)),
                                 ("mean_norm.tsv", 0, (120, 300)),
                                 ("dispersion.tsv", None, (120, 300)),
                                 ("latent.tsv", None, (300, 32)),
                                 ("reduced.tsv", None, (300, 32))):
        df = pd.read_csv(os.path.join(out, fname), sep="\t", index_col=0, header=header)
        _check(df.shape == shape, f"{fname} has shape {df.shape}, not {shape}")
        _check(bool(np.isfinite(df.to_numpy()).all()), f"{fname} is not finite")
    _check(os.path.exists(os.path.join(out, "model.pickle")), "no model.pickle")
    shutil.rmtree(work)
    print("phase 4: CLI on the card wrote mean, mean_norm, dispersion, latent, "
          "reduced and model.pickle, all finite")


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
        phase_cpu_reference()
        launches, per_epoch = phase_api()
        phase_cli()
        card = _card()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    shapes = "(32, 3451), (25, 3451), (273, 3451), (7, 50)"
    kernels = []
    for key, name, line, err, tol in (
        ("fwd", "nb_nll_fwd", 143, worst["fwd_abs"], f"loss rel err <= {LOSS_RTOL}"),
        ("bwd", "nb_nll_bwd", 177, worst["bwd_abs"],
         f"unscaled grads rtol {GRAD_RTOL}, atol {GRAD_ATOL} + {GRAD_ULPS} ulps "
         "of the terms"),
    ):
        ms, plain_ms, bound_ms, bound_by = times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dca_tpu_torch/csrc/fused_nb_loss.cu",
            "replaces": f"dca_tpu/ops/fused_loss.py:{line}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "timed_shape": [32, 3451],
            "checked_shapes": shapes, "tolerance": tol, "card": card,
            **times.get(f"{key}_extra", {}),
        })
    print(f"per-epoch time {per_epoch * 1e3:.1f} ms (dca() 2730 x 3451, nb-conddisp "
          f"64-32-64, batch 32) on {card}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
