#!/usr/bin/env python3
"""Whether an abort of an NCCL communicator ends a collective that a CUDA
graph replays while its peer never joins, on the cards of one host.

    python3 chip_abort.py

The launcher (``dca_tpu_torch/parallel/launch.py``) ends a failed launched
fit by killing its workers and aborting the group from a thread of rank 0
(``_abort_process_group``), while rank 0's main thread waits on its
device, and meanwhile destroys rank 0's step graphs
(``train/graphs.py::release_graphs``).  This script checks the two facts
that rests on, apart from the fit: the abort ends a collective that a
replay is waiting in, and it returns once the graph is freed, early or
late.  One variant runs in two fresh processes (a rank a card, NCCL, each
collective's timeout 60 s, ``TORCH_NCCL_ASYNC_ERROR_HANDLING=2`` as the
launcher's rank 0 has it):

  * both ranks all-reduce 4 MiB once eagerly; the graph variants capture
    one all-reduce of it in a CUDA graph and replay it once together;
  * rank 1 then stops answering (it sleeps), and rank 0 issues the
    collective once more (eagerly, or as a replay) and records an event;
  * two seconds later a thread of rank 0 kills rank 1 and calls
    ``_abort_process_group()``, as the launcher's monitor does; rank 0's
    main thread polls the event, and frees the graph (``free``) either as
    soon as the abort starts or once the event has completed.

Variants: ``eager``; ``graph`` (freed once the collective ended);
``graph-free-early`` (freed as the abort starts); ``graph-no-register``
(``NCCL_GRAPH_REGISTER=0``, freed once ended).  Each prints one JSON line:
the seconds from the collective's issue to the abort's start, to the
event's completion (``done``, absent if it never came within LIMIT_S), to
the graph's release and to the abort's return (``abort_end``, absent if it
never returned).  Two variants run at once, on cards 0-1 and 2-3 (one
pair where fewer than four cards are visible).  The whole result goes to
``chiprun_out/abort_probe.json``.  Exits 0 when every variant reported.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import datetime
import faulthandler
import gc
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(REPO, "chiprun_out")
VARIANTS = {
    "eager": dict(graph=False, free="late", register=True),
    "graph": dict(graph=True, free="late", register=True),
    "graph-free-early": dict(graph=True, free="early", register=True),
    "graph-no-register": dict(graph=True, free="late", register=False),
}
ABORT_AFTER_S = 2.0  # from the collective's issue to the abort
LIMIT_S = 20.0  # the longest rank 0 waits for the event, then for the abort
RANK_LIMIT_S = 70  # the longest a variant's processes run, start-up included


def _rank(rank, name, port):
    """One rank of variant ``name``; rank 0 prints its report."""
    import torch
    import torch.distributed as dist

    v = VARIANTS[name]
    faulthandler.dump_traceback_later(RANK_LIMIT_S - 10)
    torch.cuda.set_device(rank)
    store = dist.TCPStore("127.0.0.1", port, 2, rank == 0, datetime.timedelta(seconds=60))
    dist.init_process_group("nccl", store=store, rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60),
                            device_id=torch.device("cuda", rank))
    x = torch.ones(1 << 20, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    g = None
    if v["graph"]:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dist.all_reduce(x)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            dist.all_reduce(x)
        g.replay()
        torch.cuda.synchronize()
    store.set(f"ready/{rank}", "1")
    store.wait(["ready/0", "ready/1"])
    if rank == 1:
        store.set("pid/1", str(os.getpid()))
        time.sleep(600)
        return
    rep = {"variant": name, **v}
    t0 = time.monotonic()
    if g is not None:
        g.replay()
    else:
        dist.all_reduce(x)
    ev = torch.cuda.Event()
    ev.record()

    def abort():
        os.kill(int(store.get("pid/1")), signal.SIGKILL)
        rep["abort_start"] = time.monotonic() - t0
        try:
            dist.distributed_c10d._abort_process_group()
        except Exception as e:  # recorded: the report is the result
            rep["abort_error"] = repr(e)[:300]
        rep["abort_end"] = time.monotonic() - t0

    threading.Timer(ABORT_AFTER_S, abort).start()
    while time.monotonic() - t0 < ABORT_AFTER_S + LIMIT_S:
        if g is not None and v["free"] == "early" and "abort_start" in rep:
            g = None
            gc.collect()
            rep["freed"] = time.monotonic() - t0
        if ev.query():
            rep["done"] = time.monotonic() - t0
            break
        time.sleep(0.01)
    if g is not None and "done" in rep:
        g = None
        gc.collect()
        rep["freed"] = time.monotonic() - t0
    t_end = time.monotonic() + LIMIT_S
    while "abort_end" not in rep and time.monotonic() < t_end:
        time.sleep(0.05)
    print(json.dumps(rep), flush=True)
    os._exit(0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(name, cards):
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards, TORCH_NCCL_ASYNC_ERROR_HANDLING="2")
    if not VARIANTS[name]["register"]:
        env["NCCL_GRAPH_REGISTER"] = "0"
    logs = [open(os.path.join(LOG_DIR, f"abort_{name}_{r}.log"), "w") for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                               name, str(port)], stdout=subprocess.PIPE if r == 0 else log,
                              stderr=log, stdin=subprocess.DEVNULL, text=True, env=env,
                              start_new_session=True)
             for r, log in enumerate(logs)]
    return procs, logs


def _end(name, procs, logs, t_end):
    try:
        out, _ = procs[0].communicate(timeout=max(t_end - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        out = ""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    for log in logs:
        log.close()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else {"variant": name, "reported": False}


def main():
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
        return 0
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_abort: needs two CUDA devices", file=sys.stderr)
        return 1
    os.makedirs(LOG_DIR, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    pairs = ["0,1", "2,3"] if torch.cuda.device_count() >= 4 else ["0,1"]
    names, results = list(VARIANTS), []
    for i in range(0, len(names), len(pairs)):
        t_end = time.monotonic() + RANK_LIMIT_S
        started = [(n, _start(n, c)) for n, c in zip(names[i:i + len(pairs)], pairs)]
        for n, (procs, logs) in started:
            res = _end(n, procs, logs, t_end)
            print(json.dumps(res), flush=True)
            results.append(res)
    with open(os.path.join(LOG_DIR, "abort_probe.json"), "w") as f:
        json.dump({"results": results, "card": card, "torch": torch.__version__}, f)
    print(card)
    return 0 if all(r.get("reported", True) for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
