"""Summarize the port's recorder (``dca_tpu_torch/timeline.py``) for one
fit of a Python-epoch loop: the epoch's phases, the host's own time, a
replay's host cost, the fit thread's CPU share, and every thread's CPU
seconds over the fit, with the epochs split into fast and slow.

Usage: python scripts/fit_timeline.py <timeline.jsonl> [--fit N] [--epochs A:B] [--json]

The JSONL is ``DCA_TPU_TIMELINE``'s; ``--fit`` picks a fit by its number
(default: the one with the most epochs), ``--epochs`` a range of its
epochs (``A:B`` as in Python; default all).  Per epoch:

  perm, steps, validation, fetch   the leaf spans that tile dca.fit.epoch
  host                             epoch - fetch: the host's own time
  replay                           steps / graphs.replays that epoch
  callbacks                        after the epoch: history, callbacks
  device                           on a card, the stream's time from the
                                   epoch's first operation to its
                                   validation's last (dca.fit.device)

An epoch is slow when it is 5% above the median.  ``fit_thread_cpu_share``
is the fit thread's CPU seconds (``time.thread_time`` after each epoch)
over the wall between the first and the last of those readings.  The fast
and the slow epochs' ``cpu_share`` is the same quotient pooled over their
stretches (consecutive epochs of one kind) of at least ``MIN_STRETCH_S``
of wall, from the reading before a stretch to its last: a thread's CPU
clock may step too coarsely for one epoch of tens of ms (PERF.md).
"""

import argparse
import json
import statistics
import sys
from collections import defaultdict

PHASES = ("perm", "steps", "validation", "fetch")
MIN_STRETCH_S = 1.0


def _median(xs):
    return statistics.median(xs) if xs else None


def summarize(rows, fit=None, epochs=None):
    """The summary (a dict) of fit ``fit`` of ``rows`` (the JSONL's
    dicts), over the epochs ``epochs`` (a slice) of it."""
    by_fit = defaultdict(list)
    for r in rows:
        by_fit[r.get("fit", 0)].append(r)
    if fit is None:
        fit = max(by_fit, key=lambda f: sum(r["stage"] == "epoch" for r in by_fit[f]))
    rows = by_fit[fit]
    per = defaultdict(lambda: defaultdict(float))
    replays = defaultdict(int)
    for r in rows:
        if r["stage"] in PHASES + ("epoch", "callbacks", "device"):
            per[r["epoch"]][r["stage"]] += r["dur"]
        elif r.get("name") == "graphs.replays":
            replays[r["epoch"]] += r["n"]
    order = sorted(e for e in per if "epoch" in per[e])
    order = order[epochs] if epochs is not None else order
    walls = [per[e]["epoch"] for e in order]
    cut = 1.05 * _median(walls)

    clock = sorted((r["t0"], r["cpu_s"], r["epoch"]) for r in rows
                   if r["stage"] == "cpu" and r["kind"] == "fit")
    reading = {e: (t, c) for t, c, e in clock}
    # the fit thread's CPU seconds and wall over the stretches of slow
    # (True) and fast (False) epochs that last MIN_STRETCH_S or more
    pooled = {True: [0.0, 0.0], False: [0.0, 0.0]}
    i = 0
    while i < len(order):
        slow_i = per[order[i]]["epoch"] > cut
        j = i
        while j + 1 < len(order) and (per[order[j + 1]]["epoch"] > cut) == slow_i:
            j += 1
        first = reading.get(order[i - 1] if i else order[i])
        last = reading.get(order[j])
        if first and last and last[0] - first[0] >= MIN_STRETCH_S:
            pooled[slow_i][0] += last[1] - first[1]
            pooled[slow_i][1] += last[0] - first[0]
        i = j + 1

    def phases(es, slow_kind):
        out = {k: _median([per[e][k] * 1e3 for e in es if k in per[e]])
               for k in PHASES + ("epoch", "callbacks", "device")}
        out["host"] = _median([(per[e]["epoch"] - per[e]["fetch"]) * 1e3 for e in es])
        cpu_s, wall_s = pooled[slow_kind] if slow_kind is not None else (0.0, 0.0)
        out["cpu_share"] = cpu_s / wall_s if wall_s else None
        out["cpu_share_wall_s"] = wall_s or None
        out["epochs"] = len(es)
        return out

    slow = [e for e in order if per[e]["epoch"] > cut]
    fast = [e for e in order if per[e]["epoch"] <= cut]
    lo, hi = (order[0], order[-1]) if order else (0, -1)
    span = [(t, c) for t, c, e in clock if lo <= e <= hi]
    fit_share = None
    if len(span) >= 2 and span[-1][0] > span[0][0]:
        fit_share = (span[-1][1] - span[0][1]) / (span[-1][0] - span[0][0])
    threads = defaultdict(list)
    for r in rows:
        if r.get("name") == "cpu.thread":
            threads[(r["part"], r["kind"], r["fit_thread"])].append((r["t0"], r["cpu_s"]))
    cpu = sorted(([name, tid, fit_thread, round(s[-1][1] - s[0][1], 4),
                   round(s[-1][0] - s[0][0], 3)]
                  for (tid, name, fit_thread), s in threads.items()
                  if len(s) >= 2), key=lambda x: -x[3])
    return {
        "fit": fit, "epochs": len(order),
        "epoch_host_ms": _median([(per[e]["epoch"] - per[e]["fetch"]) * 1e3 for e in order]),
        "replay_host_us": _median([per[e]["steps"] / replays[e] * 1e6 for e in order
                                   if replays[e]]),
        "leaf_cover_min": min((sum(per[e][k] for k in PHASES) / per[e]["epoch"]
                               for e in order), default=None),
        "fit_thread_cpu_share": fit_share,
        "all": phases(order, None), "fast": phases(fast, False), "slow": phases(slow, True),
        "threads_cpu_s": cpu[:12],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("path")
    p.add_argument("--fit", type=int)
    p.add_argument("--epochs")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    with open(args.path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    epochs = None
    if args.epochs:
        a, b = args.epochs.split(":")
        epochs = slice(int(a) if a else None, int(b) if b else None)
    out = summarize(rows, args.fit, epochs)
    if args.json:
        print(json.dumps(out))
        return
    print(f"fit {out['fit']}: {out['epochs']} epochs; host {out['epoch_host_ms']:.3f} ms an "
          f"epoch; replay {out['replay_host_us'] or 0:.1f} us; leaves cover "
          f">= {out['leaf_cover_min']:.4f} of each epoch; fit thread CPU share "
          f"{out['fit_thread_cpu_share']}")
    for kind in ("all", "fast", "slow"):
        ph = out[kind]
        print(f"  {kind:5s} ({ph['epochs']} epochs, ms medians): " + ", ".join(
            f"{k} {ph[k]:.3f}" for k in ("epoch",) + PHASES + ("host", "callbacks", "device",
                                                              "cpu_share", "cpu_share_wall_s")
            if ph[k] is not None))
    for name, tid, fit_thread, cpu_s, wall in out["threads_cpu_s"]:
        print(f"  thread {name} ({tid}{', the fit' if fit_thread else ''}): {cpu_s} s CPU "
              f"in {wall} s")


if __name__ == "__main__":
    sys.exit(main())
