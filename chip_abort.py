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
launcher's rank 0 has it, unless the variant says otherwise):

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
never returned).

The ``if-body`` variants ask whether the collective may sit in the body
of the whole-fit graph's conditional IF node (``ops/conditional.py::
if_body``, ``train/graphs.py::GraphFit``), where CUDA allows kernel,
memset, memcpy, child-graph and conditional nodes only: each rank captures
``out = all_reduce(x * 1)`` (the product allocated from the graph's pool
on the body stream, as the fit's tensors are) into an IF node read from a
``stop`` flag, after one eager all-reduce on the body stream that makes
the communicator; any error of the capture or of a replay is reported
(``capture_error``, ``replay_error``).  Both ranks then replay it with
``stop`` false (``sums``: ``out`` must be 1 + 2 = 3 on both), with
``stop`` true (``kept``: ``out``, zeroed before, must stay 0, bit for
bit), and false again; then rank 1 falls silent and rank 0's replay is
aborted as above, the graph freed once the event completed.  Each rank's
graph is dumped as Graphviz text (``chiprun_out/if_body_<variant>_<rank>
.dot``), which names every node of the body.  ``if-body`` runs with
NCCL's defaults, ``if-body-no-mixing`` with ``NCCL_GRAPH_MIXING_SUPPORT=0``
(no event nodes for NCCL's own ordering against work outside graphs),
``if-body-no-register`` with ``NCCL_GRAPH_REGISTER=0``.
``graph-no-mixing`` is ``graph`` with ``NCCL_GRAPH_MIXING_SUPPORT=0``,
``if-body-no-mixing-early`` ``if-body-no-mixing`` with the graph freed as
the abort starts: whether the abort's return hangs on the setting or on
the IF node.  ``graph-default-handling`` is ``graph`` with torch's own
``TORCH_NCCL_ASYNC_ERROR_HANDLING`` (unset), as a rank that torchrun or a
script starts has it: whether rank 0's process outlives the abort.

    python3 chip_abort.py [VARIANT ...]     # default: every variant

Two variants run at once, on cards 0-1 and 2-3 (one pair where fewer than
four cards are visible).  The whole result goes to
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
    "if-body": dict(graph=True, free="late", register=True, if_body=True),
    "if-body-no-mixing": dict(graph=True, free="late", register=True, if_body=True,
                              mixing=False),
    "if-body-no-register": dict(graph=True, free="late", register=False, if_body=True),
    "graph-default-handling": dict(graph=True, free="late", register=True, handling=None),
    "graph-no-mixing": dict(graph=True, free="late", register=True, mixing=False),
    "if-body-no-mixing-early": dict(graph=True, free="early", register=True, if_body=True,
                                    mixing=False),
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
    rep = {"variant": name, **v}
    if v.get("if_body"):
        g, stop = _if_body_checks(rank, name, x, store, rep)
        if g is None:
            if rank == 0:
                print(json.dumps(rep), flush=True)
            os._exit(0)
    elif v["graph"]:
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


def _if_body_checks(rank, name, x, store, rep):
    """The ``if-body`` variants' capture and replays (module docstring);
    returns (the graph, its ``stop`` flag), or (None, None) after an error,
    which ``rep`` records."""
    import torch
    import torch.distributed as dist

    from dca_tpu_torch.ops.conditional import if_body
    from dca_tpu_torch.train.graphs import _own_stream

    dev = torch.device("cuda", torch.cuda.current_device())
    x.fill_(rank + 1)
    out = torch.zeros_like(x)
    stop = torch.zeros(1, dtype=torch.bool, device=dev)
    stream, inner = _own_stream(dev), _own_stream(dev, "body")
    inner.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(inner):
        y = x * 1.0
        dist.all_reduce(y)  # the communicator, and NCCL's stream joined to this one
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    g.enable_debug_mode()
    pool = torch.cuda.graph_pool_handle()
    try:
        with torch.cuda.graph(g, pool=pool, stream=stream, capture_error_mode="thread_local"):
            with if_body(stop, stream, inner, pool):
                y = x * 1.0
                dist.all_reduce(y)
                out.copy_(y)
        g.debug_dump(os.path.join(LOG_DIR, f"if_body_{name}_{rank}.dot"))
    except Exception as e:  # the probe's finding: recorded, not raised
        rep["capture_error"] = repr(e)[:1500]
    # the replays are collectives: both ranks go on only if both captured
    store.set(f"captured/{rank}", "0" if "capture_error" in rep else "1")
    store.wait(["captured/0", "captured/1"])
    if any(store.get(f"captured/{r}") != b"1" for r in (0, 1)):
        rep.setdefault("capture_error", "the peer's capture failed")
        return None, None
    try:
        sums, kept = [], []
        for s in (False, True, False):
            stop.fill_(s)
            out.zero_()
            torch.cuda.synchronize()
            g.replay()
            torch.cuda.synchronize()
            vals = out.unique().tolist()
            (kept if s else sums).append(vals)
        store.set(f"checks/{rank}", json.dumps([sums, kept]))
        rep["sums"], rep["kept"] = sums, kept
        rep["peer"] = json.loads(store.get(f"checks/{1 - rank}"))
        rep["ok"] = all(s == [[3.0], [3.0]] and k == [[0.0]]
                        for s, k in ((sums, kept), rep["peer"]))
    except Exception as e:
        rep["replay_error"] = repr(e)[:1500]
        return None, None
    stop.fill_(False)
    torch.cuda.synchronize()
    return g, stop


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(name, cards):
    port = _free_port()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
    env.pop("TORCH_NCCL_ASYNC_ERROR_HANDLING", None)
    if VARIANTS[name].get("handling", 2) is not None:
        env["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = str(VARIANTS[name].get("handling", 2))
    if not VARIANTS[name]["register"]:
        env["NCCL_GRAPH_REGISTER"] = "0"
    if VARIANTS[name].get("mixing") is False:
        env["NCCL_GRAPH_MIXING_SUPPORT"] = "0"
    if VARIANTS[name].get("if_body"):
        env.setdefault("NCCL_DEBUG", "WARN")
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
    names = sys.argv[1:] or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"chip_abort: no variant {unknown}; the variants: {list(VARIANTS)}",
              file=sys.stderr)
        return 2
    os.makedirs(LOG_DIR, exist_ok=True)
    if any(VARIANTS[n].get("if_body") for n in names):
        from dca_tpu_torch.ops._build import library

        library()  # built once here, before the ranks load it
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    pairs = ["0,1", "2,3"] if torch.cuda.device_count() >= 4 else ["0,1"]
    results = []
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
