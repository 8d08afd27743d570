#!/usr/bin/env python3
"""Where the port's time goes on one NVIDIA GPU: a profile of one training
epoch of the main path, and the loss kernels' own device time.

    python3 chip_profile.py [ae_type] [--parent DIR] [--k2 | --epoch | --forward |
                                                     --tensorboard]

1. The training epoch of ``train()`` on the 2730 x 3451 Paul15-shaped
   matrix, ``ae_type`` (default zinb-conddisp, the slice's main path)
   64-32-64, batch 32, eager (``_graphs=False``) and replayed from CUDA
   graphs (the default on the card, ``train/graphs.py``): after a warm-up
   fit, each path's per-epoch wall and the graph path's capture time, then
   a 3-epoch fit under torch.profiler, started after the capture: the wall
   time, the device's busy time (the sum of its kernels' and copies'
   durations) and idle share, the device operations per step, for the
   graph path the device operations one replay of the full step makes,
   and the kernels that take the most device time.  The profiler's own
   cost lengthens the wall time.  The whole tables go to
   ``chiprun_out/profile_eager.txt`` and ``profile_graph.txt``.  Then the
   same for the whole fit on the device (``compiled=True``: one graph an
   epoch, its epoch times the device's between the replays; the profile
   starts after its capture), into ``profile_compiled.txt``.
   ``--epoch`` runs this section alone.
2. K1, K1w, K2 and K2w alone at the training step's (32, 3451), NB and
   ZINB: the kernels' mean device time from torch.profiler's trace, and
   the device operations one loss forward and one loss backward through
   ``_FusedNLL`` make without a process group (1 each: K1 writes the loss
   itself, K2 divides g by the denominator itself).  With ``--parent DIR``
   (an earlier commit unpacked at DIR, ``chip_smoke.load_parent``) the
   parent's K2 and K2w in turns with this one's, and its operations per
   loss backward.  Then K2's code: the registers of each instantiation
   (the parent's too), and its SASS instructions per element against the
   time they take to issue (``profile_k2_code``; listings in
   ``chiprun_out/k2_sass_*.txt``).  Then K4 at the encoder shape under
   every split of its split-K tiling, against torch.addmm.  ``--k2`` runs
   the loss kernels and K2's code alone.
3. The denoise forward: ``forward`` of ``ae_type`` over the 2730 x 3451
   matrix in one block, with the fused dense kernel K4 off and on
   (DCA_TPU_FUSED_DENSE), after a warm-up, under torch.profiler: wall
   time, device busy time and idle share, the host-device copies' share,
   and the device items that take the most time; the tables go to
   ``chiprun_out/profile_forward_0.txt`` (off) and ``_1.txt`` (on).
   The outputs cross to the host as the main path fetches them, through
   a page-locked ring (``network.fetch_to_host``).  ``--forward`` runs
   this section alone.

4. The TensorBoard fit's cost (``--tensorboard``): ``train()`` of
   ``ae_type`` on the same matrix, 4 epochs, eager and from CUDA graphs,
   without TensorBoard, with it as shipped (the event file and a
   ``torch.profiler`` trace of the set-up and the first
   ``TRACE_EPOCHS`` epochs, ``train/loop.py::_fit_trace``), with a trace
   of every epoch, and with no trace: each fit's epoch walls
   (``History.epoch_s``), its mean logging time
   (``History.tb_s``) and the trace file's bytes, after an untimed
   warm-up fit.
5. The whole-epoch graph (``profile_whole_epoch``, with section 1 and
   ``--epoch``): ``compiled=True``'s graph with its IF node, the same
   graph with the epoch captured in line, and the Python-epoch loop's
   step graphs, three 6-epoch fits each in turns: each fit's median epoch,
   its capture, and the device memory it leaves allocated; then the
   host's enqueue of a replay of the whole-epoch graph before and after a
   short ``torch.profiler`` session in the process.

Prints the card's name and power limit first.  Nothing here imports JAX
or the JAX package.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import time

from chip_smoke import (G_BWD, REPO, _card, _device_ms, _loss_inputs, load_parent,
                        make_paul15_like)

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


def _fit_profiled(adata, ae_type, graphs, epochs, compiled=False):
    """One ``train()`` of ``epochs`` epochs with torch.profiler started once
    the epoch runner exists (after the graph path's warm-up and capture;
    with ``compiled``, the whole-fit graph's) and stopped after the fit;
    returns (the profile, its wall seconds, the runner)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train import compiled as whole
    from dca_tpu_torch.train import loop

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    made = {}
    module = whole if compiled else loop
    base = whole.GraphFit if compiled else loop.GraphEpoch if graphs else loop.EagerEpoch

    class Profiled(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made["runner"] = self
            torch.cuda.synchronize()
            prof.start()
            made["t0"] = time.perf_counter()

    name = base.__name__
    setattr(module, name, Profiled)
    try:
        net = get_ae_type(ae_type)(input_size=adata.n_vars, device="cuda").build()
        loop.train(adata, net, epochs=epochs, verbose=False, _graphs=graphs, compiled=compiled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - made["t0"]
        prof.stop()
    finally:
        setattr(module, name, base)
    return prof, wall, made["runner"]


def profile_epoch(ae_type, epochs=3):
    """Section 1: the epoch eager and from CUDA graphs, each after a warm-up
    fit: the unprofiled per-epoch wall (``History.epoch_s``) and capture
    time, then a profiled fit: wall, device busy and idle share, device
    operations a step, and, for the graph path, the device operations one
    replay of the full step's graph makes (its nodes) and the top
    kernels."""
    import torch
    from torch.autograd import DeviceType

    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train.loop import train

    adata = io.normalize(io.read_dataset(AnnData(make_paul15_like())))
    steps = -(-int(adata.n_obs * 0.9) // 32)
    for graphs, compiled in ((False, False), (True, False), (True, True)):
        path = "compiled" if compiled else "graph" if graphs else "eager"
        walls, captures = [], []
        for _ in range(2):  # the first fit is the warm-up
            net = get_ae_type(ae_type)(input_size=adata.n_vars, device="cuda").build()
            hist = train(adata, net, epochs=epochs, verbose=False, _graphs=graphs,
                         compiled=compiled)
            walls, captures = hist.epoch_s, hist.capture_s
        prof, wall, runner = _fit_profiled(adata, ae_type, graphs, epochs, compiled)
        table = prof.key_averages()
        items = [e for e in table if e.device_type == DeviceType.CUDA]
        busy = sum(e.device_time_total for e in items) / 1e6
        ops = sum(e.count for e in items)
        with open(os.path.join(OUT_DIR, f"profile_{path}.txt"), "w") as f:
            f.write(table.table(sort_by="device_time_total", row_limit=40))
        print(f"{ae_type} {path}: epochs without the profiler "
              f"{[round(t * 1e3, 2) for t in walls]} ms"
              + (f", capture {captures * 1e3:.1f} ms" if graphs else ""))
        print(f"  profiled, {epochs} epochs: wall {wall * 1e3:.1f} ms "
              f"({wall / epochs * 1e3:.1f} an epoch), device busy {busy * 1e3:.1f} ms, idle "
              f"share {1 - busy / wall:.3f}, {ops} device operations "
              f"({ops / (epochs * steps):.0f} per step, validation included)")
        if graphs and not compiled:
            full, step_i = runner.graphs[False], runner.bufs.step_i

            def replay():
                step_i.zero_()  # one device operation; keeps the step's row in range
                full.replay()

            ops_each, _ = _device_ops(replay)
            print(f"  replays an epoch: {runner.bufs.n_full} of the full step's graph and "
                  f"{len(runner.graphs) - 1} of the trailing step's; device operations a "
                  f"replay of the full step: {ops_each - 1:.0f}")
        for e in sorted(items, key=lambda e: -e.device_time_total)[:6]:
            print(f"  {e.device_time_total / 1e3:8.2f} ms  {e.count:6d}x  {e.key[:90]}")


def profile_whole_epoch(ae_type, fits=3, epochs=6):
    """Section 5: the whole-epoch graph of ``compiled=True`` with its IF
    node, the same graph with the body captured in line (no IF node:
    ``ops/conditional.if_body`` replaced for the fit), and the Python-epoch
    loop's step graphs, ``fits`` fits of ``epochs`` epochs each, in turns,
    from one seed's weights at dropout 0.1: each fit's median epoch over
    epochs 2 on (device time between the replays' events for the whole
    epoch, the host wall for the loop), its capture, and the device memory
    left allocated after it (the graph's pool released)."""
    import contextlib
    import gc

    import numpy as np
    import torch

    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.ops import conditional
    from dca_tpu_torch.train.loop import train

    @contextlib.contextmanager
    def in_line(stop, stream, body_stream, pool):
        yield

    adata = io.normalize(io.read_dataset(AnnData(make_paul15_like())))
    state = {k: v.clone() for k, v in get_ae_type(ae_type)(
        input_size=adata.n_vars, hidden_size=(64, 32, 64), device="cuda").build()
        .model.state_dict().items()}
    if_body = conditional.if_body
    medians = {"IF node": [], "in line": [], "loop": []}
    for kind in ("IF node", "in line", "loop", "loop", "in line", "IF node") * (fits // 2 + 1):
        if len(medians[kind]) == fits:
            continue
        conditional.if_body = in_line if kind == "in line" else if_body
        try:
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            net = get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                       hidden_dropout=0.1, device="cuda").build()
            net.model.load_state_dict(state)
            hist = train(adata, net, epochs=epochs, verbose=False,
                         compiled=kind != "loop", early_stop=0, reduce_lr=0)
            torch.cuda.synchronize()
        finally:
            conditional.if_body = if_body
        medians[kind].append(float(np.median(hist.epoch_s[1:])) * 1e3)
        del net
        gc.collect()
        torch.cuda.synchronize()
        print(f"whole epoch, {kind}: epochs {[round(t * 1e3, 2) for t in hist.epoch_s]} ms, "
              f"capture {hist.capture_s} s, device memory left after the fit "
              f"{(torch.cuda.memory_allocated() - base) / 2**20:.2f} MiB")
    print("whole epoch, medians of epochs 2-" + str(epochs) + ": "
          + "; ".join(f"{k} {[round(v, 2) for v in vals]} ms" for k, vals in medians.items()))
    # the host's enqueue of a replay, before and after a short profiler
    # session in the same process (CUPTI stays attached to the launches)
    from torch.profiler import ProfilerActivity, profile

    enqueue = []
    for profiled in (False, True):
        if profiled:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                x = torch.ones(16, device="cuda")
                for _ in range(10):
                    x.add_(1.0)
                torch.cuda.synchronize()
        net = get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                   hidden_dropout=0.1, device="cuda").build()
        net.model.load_state_dict(state)
        hist = train(adata, net, epochs=epochs, verbose=False, compiled=True, early_stop=0,
                     reduce_lr=0)
        enqueue.append(hist.fit.enqueue_s / epochs * 1e3)
    print(f"whole epoch, IF node: the host's enqueue {enqueue[0]:.3f} ms a replay, "
          f"{enqueue[1]:.3f} ms after a profiler session of 10 kernels")


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


def _backward_ops(impl, y, mu, th, pi, w, g):
    """Device operations per loss backward through ``impl._FusedNLL``
    without a group: ``torch.autograd.grad`` of a loss whose forward ran
    before the trace, with the incoming gradient ``g`` given (so autograd
    fills no seed)."""
    import torch

    ops = [t.detach().requires_grad_(True) for t in (mu, th, pi) if t is not None]
    args = (y, ops[0], ops[1], None if pi is None else ops[2], w, 0.1, None)
    loss = impl._FusedNLL.apply(*args)
    torch.autograd.grad(loss, ops, g, retain_graph=True)
    return _device_ops(lambda: torch.autograd.grad(loss, ops, g, retain_graph=True))


def profile_kernels(parent=None):
    """K1, K1w, K2 and K2w at (32, 3451), NB and ZINB: each kernel's own
    device time, the device operations of one loss forward and of one loss
    backward through ``_FusedNLL`` without a group (the single-device
    training step's path), unweighted and weighted.  With ``parent``
    (``chip_smoke.load_parent``), the parent's K2 and K2w in turns with
    this one's (parent, change, change, parent) on the same inputs, and
    the parent's device operations per loss backward."""
    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    dev = torch.device("cuda")
    g = torch.tensor(G_BWD, device=dev)
    for fam, seed in (("nb", 11), ("zinb", 13)):
        y, mu, th, pi = (None if a is None else torch.from_numpy(a).to(dev)
                         for a in _loss_inputs(32, 3451, seed,
                                               pi_shape=(32, 3451) if fam == "zinb" else None))
        w = torch.ones((32, 1), device=dev)
        _, denom = fl._fwd_kernel(y, mu, th, pi, 0.1)
        _, denom_w = fl._fwd_kernel(y, mu, th, pi, 0.1, w)
        # the kernels are templates: nll_fwd_kernel<WITH_PI, WITH_W>,
        # nll_bwd_kernel<WITH_PI, WITH_W>
        tag = "true" if pi is not None else "false"
        k1 = _profiled_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1),
                          f"nll_fwd_kernel<{tag}, false>")
        k1w = _profiled_ms(lambda: fl._fwd_kernel(y, mu, th, pi, 0.1, w),
                           f"nll_fwd_kernel<{tag}, true>")
        k2 = _profiled_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom),
                          f"nll_bwd_kernel<{tag}, false>")
        k2w = _profiled_ms(lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom_w, w),
                           f"nll_bwd_kernel<{tag}, true>")
        with torch.no_grad():
            ops, names = _device_ops(lambda: fl._FusedNLL.apply(y, mu, th, pi, None, 0.1, None))
            ops_w, names_w = _device_ops(lambda: fl._FusedNLL.apply(y, mu, th, pi, w, 0.1, None))
        bops, bnames = _backward_ops(fl, y, mu, th, pi, None, g)
        bops_w, bnames_w = _backward_ops(fl, y, mu, th, pi, w, g)
        print(f"{fam} (32, 3451) by torch.profiler: K1 kernel {k1} ms, K1w kernel {k1w} ms, "
              f"K2 kernel {k2} ms, K2w kernel {k2w} ms; device operations per loss forward "
              f"without a group: {ops:g} ({', '.join(names)}), weighted {ops_w:g} "
              f"({', '.join(names_w)}); per loss backward: {bops:g} ({', '.join(bnames)}), "
              f"weighted {bops_w:g} ({', '.join(bnames_w)})")
        if parent is None:
            continue
        scale = (g / denom).reshape(1)
        scale_w = (g / denom_w).reshape(1)
        for what, p_fn, c_fn, weighted in (
                ("K2", lambda: parent._bwd_kernel(y, mu, th, pi, 0.1, scale),
                 lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom), "false"),
                ("K2w", lambda: parent._bwd_kernel(y, mu, th, pi, 0.1, scale_w, w),
                 lambda: fl._bwd_kernel(y, mu, th, pi, 0.1, g, denom_w, w), "true")):
            name = f"nll_bwd_kernel<{tag}, {weighted}>"
            t = [_profiled_ms(p_fn, name), _profiled_ms(c_fn, name),
                 _profiled_ms(c_fn, name), _profiled_ms(p_fn, name)]
            print(f"{fam} (32, 3451) {what} kernel alone, in turns: parent {t[0]} ms, change "
                  f"{t[1]} ms, change {t[2]} ms, parent {t[3]} ms")
        pops, pnames = _backward_ops(parent, y, mu, th, pi, None, g)
        print(f"{fam} (32, 3451) the parent's device operations per loss backward without a "
              f"group: {pops:g} ({', '.join(pnames)})")


def _ptxas_registers(build_log):
    """{kernel: (registers, bytes of spill stores and loads)} of the
    nll_bwd kernels in a build's log (ptxas -v)."""
    regs, name, spill = {}, None, 0
    with open(build_log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name and "nll_bwd_kernel" in name:
                regs[name] = (int(m.group(1)), spill)
    return regs


def _sass_counts(lib_path, out_name):
    """Per nll_bwd kernel of the library: its SASS instructions up to the
    main body's last EXIT (the out-of-line slow paths of the IEEE
    divisions follow it), and the MUFU and CALL instructions among them;
    the listing goes to chiprun_out/<out_name>.  None where the toolkit has
    no cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None
    text = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "nll_bwd_kernel" in m.group(1) else None
            if name:
                funcs[name] = []
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            funcs[name].append(line.strip())
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        for name, lines in funcs.items():
            f.write(f"Function : {name}\n" + "\n".join(lines) + "\n\n")
    counts = {}
    for name, lines in funcs.items():
        first_ret = next((i for i, s in enumerate(lines) if " RET" in s), len(lines))
        exits = [i for i, s in enumerate(lines[:first_ret]) if "EXIT" in s]
        body = lines[:exits[-1] + 1] if exits else lines
        counts[name] = {"body": len(body), "all": len(lines),
                        "mufu": sum("MUFU" in s for s in body),
                        "call": sum("CALL" in s for s in body)}
    return counts


def _max_sm_clock_hz():
    proc = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60)
    return float(proc.stdout.split()[0]) * 1e6


def profile_k2_code(parent=None):
    """K2's code on the card: the registers each kernel uses (ptxas, from
    the build logs, the parent's too with ``parent``); and, where the
    toolkit has cuobjdump, the SASS instructions of each kernel's main
    body, per element, with the time they take to issue at one instruction
    a cycle on each of the 4 schedulers of the 132 SMs at the card's
    highest clock, beside the byte bound."""
    from dca_tpu_torch.ops import _build

    libs = [("change", _build.build())]
    if parent is not None:
        import importlib

        libs.append(("parent", importlib.import_module("dca_parent.ops._build").build()))
    clock = _max_sm_clock_hz()
    n = 32 * 3451
    for who, lib in libs:
        regs = _ptxas_registers(os.path.join(os.path.dirname(lib), "build.log"))
        print(f"{who}: ptxas (registers, spill bytes) of the nll_bwd kernels: {regs}")
        counts = _sass_counts(lib, f"k2_sass_{who}.txt")
        if counts is None:
            print(f"{who}: no cuobjdump in this toolkit: SASS not read")
            continue
        for name, c in counts.items():
            per_elem = c["body"]  # one element a thread
            issue_us = n * per_elem / 32 / (132 * 4 * clock) * 1e6
            print(f"{who}: {name[:90]}: {c['body']} SASS instructions in the main body "
                  f"({c['all']} with the slow paths; {c['mufu']} MUFU, {c['call']} CALL), "
                  f"{per_elem:.0f} an element: {issue_us:.2f} us to issue at (32, 3451) at "
                  f"{clock / 1e6:.0f} MHz")


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


TB_VARIANTS = ("plain", "shipped", "whole fit", "no trace")


def profile_tensorboard(ae_type, epochs=4):
    """Section 4: the TensorBoard fit's cost, by trace variant (module
    docstring)."""
    import contextlib
    import glob

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    from chip_smoke import _prepped_paul15
    from dca_tpu_torch.models.network import get_ae_type
    from dca_tpu_torch.train import loop

    adata = _prepped_paul15()
    shipped = loop._fit_trace
    variants = {
        "plain": None, "shipped": shipped,
        "whole fit": lambda logdir, device: profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True,
            on_trace_ready=tensorboard_trace_handler(logdir)),
        "no trace": lambda logdir, device: contextlib.nullcontext(),
    }
    out = os.path.join(OUT_DIR, "tb_cost")
    loop.train(adata, get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                           device="cuda").build(), epochs=1, verbose=False)
    try:
        for graphs in (False, True):
            for name in TB_VARIANTS:
                shutil.rmtree(out, ignore_errors=True)
                if variants[name] is not None:
                    loop._fit_trace = variants[name]
                net = get_ae_type(ae_type)(input_size=adata.n_vars, hidden_size=(64, 32, 64),
                                           device="cuda").build()
                hist = loop.train(adata, net, epochs=epochs, verbose=False, _graphs=graphs,
                                  output_dir=out, tensorboard=variants[name] is not None)
                torch.cuda.synchronize()
                loop._fit_trace = shipped
                traces = glob.glob(os.path.join(out, "tb", "*.pt.trace.json"))
                tb_ms = float(np.mean(hist.tb_s)) * 1e3 if hist.tb_s else 0.0
                print(f"tensorboard cost, {'graph' if graphs else 'eager'} fit, {name}: epochs "
                      f"{[round(t * 1e3, 2) for t in hist.epoch_s]} ms, logging {tb_ms:.2f} ms "
                      f"an epoch, trace {sum(os.path.getsize(t) for t in traces)} bytes")
    finally:
        loop._fit_trace = shipped
        shutil.rmtree(out, ignore_errors=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    import argparse

    parser = argparse.ArgumentParser(description="Where the port's time goes on the GPU")
    parser.add_argument("ae_type", nargs="?", default="zinb-conddisp")
    parser.add_argument("--parent", metavar="DIR",
                        help="an earlier commit unpacked at DIR: its K2 timed in turns")
    parser.add_argument("--k2", action="store_true",
                        help="only the loss kernels and K2's code (section 2 without K4)")
    parser.add_argument("--epoch", action="store_true", help="only the training epoch (section 1)")
    parser.add_argument("--forward", action="store_true",
                        help="only the denoise forward (section 3)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="only the TensorBoard fit's cost (section 4)")
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    print(_card())
    parent = None if args.parent is None else load_parent(args.parent)
    if args.forward:
        profile_forward(args.ae_type)
        return 0
    if args.tensorboard:
        profile_tensorboard(args.ae_type)
        return 0
    if not args.k2:
        # first: after a profiler session each launch of the whole-epoch
        # graph costs milliseconds of host time (PERF.md)
        profile_whole_epoch(args.ae_type)
        profile_epoch(args.ae_type)
    if args.epoch:
        return 0
    profile_kernels(parent)
    profile_k2_code(parent)
    if not args.k2:
        profile_dense_plans()
        profile_forward(args.ae_type)
    return 0


if __name__ == "__main__":
    sys.exit(main())
