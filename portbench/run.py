#!/usr/bin/env python3
"""The benchmark of dca_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``)
names a configuration and a traffic mix, found by name under
``portbench/configs`` and ``portbench/traffic``.  Set-up makes the data
and the weights from ``--seed``, builds the network and runs the warm-up
fit; the window is one ``train()`` call of about ``--seconds``.  With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics; with ``--trace 1`` a slice of the window is profiled, the window
up to the slice is recorded by the program's recorder
(``dca_tpu_torch.timeline``), and the line holds the per-layer metrics,
the device's busy and window seconds and a breakdown.  Either way the warm-up epoch is then checked against the
plain reference (``harness/reference.py``); the numbers compared and their
limits end standard error and the result line.

The run fails, and prints no result, when there is no CUDA device or
fewer than the cell asks for, or when JAX or the JAX package was loaded.
Caches the program builds go into the checkout (``dca_tpu_torch/_build``,
``.portbench_cache``); the profiler's trace file into TMPDIR.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "dca_tpu")


def _cache_env():
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (``dca_tpu_torch`` is not ``dca_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed, seconds, trace, device, t_start=T_START):
    """One run of ``cell`` on ``device`` after the look for a chip: returns
    the result dict (``check`` last).  The CPU tests call it directly."""
    import torch

    from harness import cell as C
    from harness import trace as T
    from harness.manifest import reader

    s = C.setup(cell, seed, device)
    cuda = device.type == "cuda"
    tracer = None
    if trace and cuda:
        lead = cell.traffic["trace_lead"] * seconds
        tracer = T.SliceTracer(lead, cell.traffic["trace_slice_s"])
    setup_s = time.perf_counter() - t_start
    hist, wall, epochs = C.timed_fit(s, cell, seconds, tracer, record=bool(trace))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    fit = {"epochs": epochs, "wall_s": wall, "n_train": s.n_train, "n_val": s.n - s.n_train,
           "flops": C.model_flops(cell, s, epochs), "rows": epochs * s.n_train,
           "epoch_flops": C.model_flops(cell, s, 1), "epoch_s": list(hist.epoch_s),
           "clean_epochs": epochs, "unprofiled_epochs": epochs}
    if tracer is not None and tracer.lead_taken_s is not None:
        # the epochs that ended before the profiler first started: after it
        # the process launches its graphs slower.  ``clean_epochs`` (mfu's)
        # counts the profiler's start-up, seconds on the card, as the fit's
        # time; ``unprofiled_epochs`` (the readers of the host's own time)
        # does not
        fit["clean_epochs"] = C.epochs_before(hist.epoch_s, wall - tracer.overhead_s,
                                              tracer.lead_taken_s)
        fit["unprofiled_epochs"] = C.epochs_before(hist.epoch_s, wall - tracer.overhead_s,
                                                   tracer.lead_begun_s)
    loss = hist.history["loss"]
    val = hist.history.get("val_loss", loss)
    # an epoch whose losses are not finite failed
    failed = sum(1 for a, b in zip(loss, val) if not (_finite(a) and _finite(b)))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit": power_limit() if cuda else None}
    result = {"correct": None, "attempted": epochs, "failed": failed}
    seen = {}
    if trace:
        # which trainer and tier ran, as the program's record shows them
        trainer, tier = C.trainer_seen(s.timeline)
        seen = {k: v for k, v in (("trainer", trainer), ("tier", tier)) if v is not None}
        sched = C.schedule(cell, s, trainer)
        tr = tracer.finish() if tracer is not None else None
        ctx = types.SimpleNamespace(trace=tr, schedule=sched, fit=fit, config=cell.config,
                                    traffic=cell.traffic, genes=s.genes, timeline=s.timeline)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            device_info["busy_s"] = tr.busy_s()
            device_info["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    else:
        values = {"setup_s": setup_s, "train_cells_per_s": fit["rows"] / wall,
                  "epoch_ms_p95": _p95(hist.epoch_s) * 1e3}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = device_info
    result["fit"] = {**seen, "epochs": epochs, "wall_s": wall,
                     "capture_s": hist.capture_s,
                     "clean_epochs": fit["clean_epochs"],
                     "unprofiled_epochs": fit["unprofiled_epochs"],
                     "setup_epoch_s": s.epoch_s, "warm_capture_s": s.warm.capture_s,
                     "setup_parts_s": s.times}
    C.keep_final(s, hist)
    result["fit"].update(_epoch_summary(hist.epoch_s, fit["clean_epochs"] if trace else None))
    del hist
    s.timeline = None
    C.release(s)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    numbers, detail = C.check(cell, s, device)
    result["fit"]["check_s"] = time.perf_counter() - t0
    if cuda:
        result["fit"]["check_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    result["correct"] = bool(C.judge(numbers, cell.limits)) and failed == 0
    result["check_detail"] = detail
    result["check"] = {k: {"value": _number(v), "limit": cell.limits[k]["limit"]}
                       for k, v in numbers.items()}
    return result


def _epoch_summary(epoch_s, clean):
    """The timed fit's epoch walls in brief: their median and extremes, and
    in a traced run the median before the profiler first started and
    after it."""
    import statistics

    out = {"epoch_s_median": statistics.median(epoch_s), "epoch_s_min": min(epoch_s),
           "epoch_s_max": max(epoch_s)}
    if clean:
        out["clean_epoch_s_median"] = statistics.median(epoch_s[:clean])
    if clean is not None and clean < len(epoch_s):
        out["traced_epoch_s_median"] = statistics.median(epoch_s[clean:])
    return out


def _finite(x):
    return x == x and abs(x) != float("inf")


def _number(x):
    """x, or its name where JSON has no number for it (inf, nan)."""
    return x if _finite(x) else repr(x)


def _p95(values):
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def main(argv=None):
    args = parse_args(argv)
    _cache_env()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, BENCH_DIR)
    from harness.manifest import load_manifest, resolve

    cell = resolve(load_manifest(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{n} available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_imported = time.perf_counter()
    torch.zeros(1, device=device)  # the CUDA context
    t_context = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(cell, args.seed, args.seconds, args.trace, device)
    result["fit"]["setup_parts_s"].update(imports_s=t_imported - T_START,
                                          cuda_context_s=t_context - t_imported)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
