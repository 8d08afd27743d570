#!/usr/bin/env python3
"""Where the port's time goes on one NVIDIA GPU: a profile of one training
epoch of the main path, and the loss kernels' own device time.

    python3 chip_profile.py [ae_type]

1. One epoch of ``train()`` on the 2730 x 3451 Paul15-shaped matrix,
   ``ae_type`` (default zinb-conddisp, the slice's main path) 64-32-64,
   batch 32, after a warm-up epoch, under torch.profiler: the wall time,
   the device's busy time (the sum of its kernels' durations) and idle
   share, the kernel launches per step, and the kernels that take the most
   device time.  The profiler's own cost lengthens the wall time.  The
   whole table goes to ``chiprun_out/profile.txt``.
2. K1, K1w and K2 alone at the training step's (32, 3451), NB and ZINB:
   the kernels' mean device time from torch.profiler's trace, and the
   device operations one loss forward through ``_FusedNLL`` makes without
   a process group (1: K1 writes the loss itself).  Then K4 at the encoder
   shape under every split of its split-K tiling, against torch.addmm.
3. The denoise forward: ``forward`` of ``ae_type`` over the 2730 x 3451
   matrix in one block, with the fused dense kernel K4 off and on
   (DCA_TPU_FUSED_DENSE), after a warm-up, under torch.profiler: wall
   time, device busy time and idle share, the host-device copies' share,
   and the device items that take the most time; the tables go to
   ``chiprun_out/profile_forward_0.txt`` (off) and ``_1.txt`` (on).

Prints the card's name and power limit first.  Nothing here imports JAX
or the JAX package.
"""

from __future__ import annotations

import os
import sys
import time

from chip_smoke import REPO, _card, _device_ms, _loss_inputs, make_paul15_like

OUT_DIR = os.path.join(REPO, "chiprun_out")
N_PROFILED = 50


def _profiled_ms(fn, name, n=N_PROFILED):
    """Mean device time of the kernels whose name holds ``name`` over ``n``
    calls of ``fn``, from torch.profiler's CUDA trace; None when the trace
    holds no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for event in prof.key_averages():
        total_us = getattr(event, "device_time_total", 0.0)
        if name in event.key and event.count and total_us:
            return total_us / event.count / 1e3
    return None


def profile_epoch(ae_type):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train.loop import train

    adata = io.normalize(io.read_dataset(AnnData(make_paul15_like())))
    net = get_ae_type(ae_type)(input_size=adata.n_vars, device="cuda").build()
    train(adata, net, epochs=1, verbose=False)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train(adata, net, epochs=1, verbose=False)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(adata, net, epochs=1, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages()
    kernels = [e for e in table if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    steps = -(-int(adata.n_obs * 0.9) // 32)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(table.table(sort_by="device_time_total", row_limit=40))
    print(f"{ae_type}: epoch without the profiler: wall {plain_wall * 1e3:.1f} ms")
    print(f"profiled epoch: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms, "
          f"idle share {1 - busy / wall:.3f}, {launches} kernel launches "
          f"({launches / steps:.0f} per step)")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:6]:
        print(f"  {e.device_time_total / 1e3:8.2f} ms  {e.count:6d}x  {e.key[:90]}")


def _device_ops(fn, n=N_PROFILED):
    """Device operations (kernels and copies) per call of ``fn`` and their
    names, from torch.profiler's trace of ``n`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    items = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sum(e.count for e in items) / n, sorted({e.key[:60] for e in items})


def profile_kernels():
    """K1 and K2 at (32, 3451): each kernel's own device time, and the
    device operations of one loss forward through ``_FusedNLL`` without a
    group (the single-device training step's path), NB and ZINB, unweighted
    and weighted."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    dev = torch.device("cuda")
    for fam, seed in (("nb", 11), ("zinb", 13)):
        y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                         for a in _loss_inputs(32, 3451, seed,
                                               pi_shape=(32, 3451) if fam == "zinb" else None))
        w = torch.ones((32, 1), device=dev)
        scale = torch.full((1,), 1.0 / y.numel(), device=dev)
        # the kernels are templates: nll_fwd_kernel<WITH_PI, WITH_W>
        tag = "true" if pi is not None else "false"
        k1 = _profiled_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1),
                          f"nll_fwd_kernel<{tag}, false>")
        k1w = _profiled_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1, w),
                           f"nll_fwd_kernel<{tag}, true>")
        k2 = _profiled_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, scale),
                          f"nll_bwd_kernel<{tag}, false>")
        with torch.no_grad():
            ops, names = _device_ops(lambda: fl._FusedNLL.apply(y, mu, th, pi, None, 0.1, None))
            ops_w, names_w = _device_ops(lambda: fl._FusedNLL.apply(y, mu, th, pi, w, 0.1, None))
        print(f"{fam} (32, 3451) by torch.profiler: K1 kernel {k1} ms, K1w kernel {k1w} ms, "
              f"K2 kernel {k2} ms; device operations per loss forward without a group: "
              f"{ops:g} ({', '.join(names)}), weighted {ops_w:g} ({', '.join(names_w)})")


def profile_dense_plans():
    """K4 at the encoder shape (2730, 3451) -> 64, linear, under every split
    S = 1..8 of the split-K tiling, beside the plan's own choice and
    torch.addmm, each graph-timed (``chip_smoke._device_ms``), in turns;
    with the card's co-resident clusters of each size, which the plan
    reads."""
    import torch

    from chip_smoke import dense_inputs
    from dca_tpu_torch.ops import fused_dense as fd

    dev = torch.device("cuda")
    B, K, N = 2730, 3451, 64
    x, w, b = (torch.from_numpy(a).to(dev) for a in dense_inputs(B, K, N, 7, bn=False)[:3])
    chosen = fd.device_plan(B, K, N, dev)
    print(f"co-resident clusters of S = 1..8 split-K blocks: {fd.max_clusters(dev)}")
    times = {}
    for rnd in range(2):
        for s in range(1, fd.MAX_CLUSTER + 1):
            p = chosen._replace(splits=s, cluster=s)
            ms = _device_ms(lambda: fd._kernel(x, w, b, None, "linear", None, p))
            times.setdefault(s, []).append(ms)
        times.setdefault("addmm", []).append(_device_ms(lambda: torch.addmm(b, x, w)))
    tiles = len(fd.plan_blocks(chosen._replace(splits=1, cluster=1), B, K, N))
    for key, v in times.items():
        what = "torch.addmm" if key == "addmm" else f"S = {key} ({tiles * key} blocks)"
        mark = " <- the plan" if key == chosen.splits else ""
        print(f"K4 encoder ({B}, {K}) -> {N}, linear, {what}: "
              f"{' / '.join(f'{t * 1e3:.2f}' for t in v)} us{mark}")


def profile_forward(ae_type):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import get_ae_type

    adata = io.normalize(io.read_dataset(AnnData(make_paul15_like())))
    x, sf = adata.X, io.size_factors(adata)
    net = get_ae_type(ae_type)(input_size=adata.n_vars, device="cuda").build()
    saved = os.environ.get("DCA_TPU_FUSED_DENSE")
    try:
        for mode in ("0", "1"):
            os.environ["DCA_TPU_FUSED_DENSE"] = mode
            net.forward(x, sf)  # warm-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                net.forward(x, sf)
                wall = time.perf_counter() - t0
            table = prof.key_averages()
            items = [e for e in table if e.device_type == DeviceType.CUDA]
            busy = sum(e.device_time_total for e in items) / 1e6
            copies = sum(e.device_time_total for e in items if "Memcpy" in e.key) / 1e6
            with open(os.path.join(OUT_DIR, f"profile_forward_{mode}.txt"), "w") as f:
                f.write(table.table(sort_by="device_time_total", row_limit=30))
            print(f"{ae_type} forward 2730 x 3451, K4 {'on' if mode == '1' else 'off'}: "
                  f"profiled wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.2f} ms "
                  f"(copies {copies * 1e3:.2f} ms), idle share {1 - busy / wall:.3f}")
            for e in sorted(items, key=lambda e: -e.device_time_total)[:6]:
                print(f"  {e.device_time_total / 1e3:8.3f} ms  {e.count:4d}x  {e.key[:90]}")
            host = [e for e in table if e.device_type == DeviceType.CPU]
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:4]:
                print(f"  host {e.self_cpu_time_total / 1e3:8.3f} ms  {e.count:4d}x  {e.key[:80]}")
    finally:
        if saved is None:
            os.environ.pop("DCA_TPU_FUSED_DENSE", None)
        else:
            os.environ["DCA_TPU_FUSED_DENSE"] = saved


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    print(_card())
    ae_type = sys.argv[1] if len(sys.argv) > 1 else "zinb-conddisp"
    profile_epoch(ae_type)
    profile_kernels()
    profile_dense_plans()
    profile_forward(ae_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
