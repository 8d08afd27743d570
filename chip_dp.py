#!/usr/bin/env python3
"""Data-parallel training of the PyTorch/CUDA port on several cards of one
host, one rank per card over NCCL.

    python3 chip_dp.py [n_cards]     # default: every visible card

First the graph pairs (``phase_graph_pairs``): over NCCL each rank
replays its sharded step from CUDA graphs (``train/graphs.py``), and each
grid is fitted both ways in this one call, captured and eager
(``_graphs=False``), on spawned ranks, and again launched from this
process (``parallel/launch.py``): the n x 1 grid in memory (zinb-conddisp 3
epochs at 3451 genes), the 2 x 2 and 1 x 4 grids at MP_GENES, the
streamed 2 x 2 grid (parts of 512, 2 epochs, host tier), and the same
three in-memory grids with ``compiled=True`` on the first 2720 cells
(the whole-fit graph, one replay an epoch with the collectives inside,
against its epochs from Python): the same bits captured and eager,
spawned and launched, each rank's launches its schedule's (the captured
fits with their warm-ups: the whole-fit graph's is an epoch), the first
and steady epochs and capture seconds printed.  Then:

Trains zinb-conddisp (64-32-64, batch 32) on ``chip_smoke.py``'s 2730 x
3451 Paul15-shaped matrix on one card in this process, 2 epochs through
``chip_smoke.py``'s phase 4 (the steps replayed from CUDA graphs, and
eagerly), times the one-card epoch both ways as phase 4 does
(``epoch_timings``, 2-epoch fits), then runs its phase 7 with
``n_cards`` spawned ranks, one per card, over NCCL: zinb-conddisp 2 epochs
and nb-conddisp 1, the histories the same on every rank, the loss within
rtol 1e-3 of the one-card fit and val_loss within rtol 1e-2, the per-rank
launches of the loss kernels, the denoised matrices equal on every rank,
rank 0 alone writing; the zinb-conddisp fits log to TensorBoard, and rank
0's last gradient histograms must match the one-card gradient of its
final parameters within rtol 1e-3; the ``compiled=True`` fit on the first
2720 cells is held to the one-card compiled fit likewise; the streamed fit
under the group (``train(devices="all", max_device_cells=512)``, host and
padded-payload tiers) is held to the one-card streamed fit of phase 10 (a)
from the same weights (``stream_reference``), its val_loss within rtol
1e-2 as phase 7's on one card.  val_loss gets more room than phase 7's
1e-3: the
Dense bias before each BatchNorm has a gradient that is zero in exact
arithmetic and rounding noise in float32, which RMSprop scales up to
steps of the learning rate; the eval-mode BatchNorm carries that drift
into val_loss (and the eval-mode gradients), and cuBLAS rounds a rank's
block of 8 rows otherwise than the whole batch of 32 (at 2 ranks phase 7
measured 4e-4 to 8e-4).  Then a 1-epoch streamed fit at BIG_CELLS x 3451
(``chip_smoke.synthetic_sparse_counts``, ~10% nonzero) with parts of
BIG_PART cells through the padded-payload tier, on one card (the steps
replayed from CUDA graphs) and on ``n_cards`` ranks over NCCL (replayed too):
each epoch's time, the same history on every rank, the loss within rtol
1e-3 of the one card's and val_loss within rtol 1e-2, and the launches of
each rank and of the one card exactly those of the schedule.  Then
gene-dim model parallelism (``chip_smoke.phase_model_parallel``):
zinb-conddisp on the first MP_GENES = 3448 genes (which 2 and 4 divide)
for 2 epochs through ``dca(devices="all", model_parallel=M)`` on the
``n_cards`` ranks over NCCL, at M = 1 (the data-parallel grid, for its
epoch time), and, on 4 cards, 2 x 2 and 1 x 4: the same history on every
rank, within rtol 1e-3 (loss) and 1e-2 (val_loss) of the one-card fit of
the same genes, the gathered parameters and denoised matrices equal on
every rank, rank 0 alone writing, each rank's launches exact; each grid's
epoch time beside the one card's; and the streamed fit on the 2 x 2 and 1
x 4 grids (``train(devices="all", model_parallel=M,
max_device_cells=512)``, host and padded-payload tiers) against the
one-card streamed fit of the same genes.  Then the same fits from this one
process, their ranks started by the fit itself (``chip_smoke.phase_launch``,
``parallel/launch.py``, a card a rank over NCCL): ``dca(devices=n)``,
``dca(devices=n, model_parallel=2)`` and the streamed 2 x 2 grid at
MP_GENES, each within rtol 1e-4 of the spawned ranks' fit, rank 0's
launches theirs, epoch times beside theirs.  Prints the cards' names and
power limits and the epoch times; exits non-zero on any failure.  Nothing
here imports JAX or the JAX package.

    python3 chip_dp.py [n_cards] --launch-checks

runs only the failure checks over NCCL (``phase_launch_checks``,
FAIL_CASES): a fit of two ranks whose rank 1 dies, or stops answering
while its process lives (rank 0 then waits in a collective), its ranks
started by the launcher (``train(devices=2)``) or by hand
(``init_process_group`` from torchrun's variables, no launcher: the
group's own progress rule), under replayed steps (rank 1 fails at the
end of epoch 2) or under the whole-fit graph (``compiled=True``: rank 1
fails once its card has run epoch 2), eight checks, each from a child
process that must survive, raise ``LaunchError`` naming rank 1 within
FAIL_TIMEOUT + 30 s of its failure, leave no group and no child, and
then train a next fit.  The children run two at a time, each on two
cards of its own (``CUDA_VISIBLE_DEVICES``), so four cards are needed.

    python3 chip_dp.py [n_cards] --compiled-pairs

runs only the graph pairs' ``compiled=True`` fits.

    python3 chip_dp.py [n_cards] --thread-timings

runs the launched streamed 2 x 2 fit and the one-card ``_one_card`` fit
with ``threads`` 1 and the caller's default count, for their epoch times
(``thread_timings``).
"""

from __future__ import annotations

import faulthandler
import functools
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

BIG_CELLS, BIG_PART = 65_536, 16_384
MP_GENES = 3448
MP_RUNS = (("zinb-conddisp", "zinb-conddisp", MP_GENES, 2),)
BIG_TIMEOUT = 900  # seconds for the ranks of the large streamed fit, start-up included
LOG_DIR = os.path.join(REPO, "chiprun_out")  # what the launcher checks leave to read


def _big_fit(dev, out_dir, devices=None):
    """The 1-epoch streamed fit at BIG_CELLS x 3451 from the weights in
    ``out_dir``; returns its history, epoch times and launches."""
    import torch

    adata = cs._lazy_adata(cs.synthetic_sparse_counts(BIG_CELLS))
    state = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(out_dir,
                                                                      "big_state.npz")).items()}
    with cs._switches(cs.STREAM_TIERS["padded"]):
        hist, launches, _ = cs._stream_fit(dev, adata, state, 1, verbose=False, devices=devices,
                                           max_device_cells=BIG_PART)
    torch.cuda.synchronize()
    return {"history": hist.history, "epoch_s": hist.epoch_s, "launches": launches}


def _big_rank(rank, world, port, out_dir):
    """One rank of the large streamed fit, on its card over NCCL."""
    import torch

    from dca_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend="nccl")
    res = _big_fit(torch.device("cuda"), out_dir, devices="all")
    with open(os.path.join(out_dir, f"big{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def phase_big_stream(n):
    """The large streamed fit on one card, then on ``n`` ranks; returns both."""
    import torch

    out_dir = os.path.join(cs.OUT_DIR, "big")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda")
    np.savez(os.path.join(out_dir, "big_state.npz"),
             **{k: v.cpu().numpy() for k, v in cs._stream_state(dev, 3451).items()})
    one = _big_fit(dev, out_dir)
    cs.run_ranks(_big_rank, n, (out_dir,), BIG_TIMEOUT, "the large streamed fit")
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"big{r}.json")) as f:
            ranks.append(json.load(f))
    want_one = cs._want_stream_launches(1, BIG_CELLS, BIG_PART)
    cs._check(one["launches"] == want_one, f"the large streamed fit on one card launched "
              f"{one['launches']}, expected {want_one}")
    for rk, res in enumerate(ranks):
        want = cs.want_group_stream_launches(1, BIG_CELLS, BIG_PART, n, rk, captured=True)
        cs._check(res["history"] == ranks[0]["history"]
                  and bool(np.isfinite(res["history"]["loss"] + res["history"]["val_loss"]).all()),
                  f"the large streamed fit: rank {rk}'s history {res['history']}, rank 0's "
                  f"{ranks[0]['history']}")
        cs._check(res["launches"] == want, f"the large streamed fit: rank {rk} launched "
                  f"{res['launches']}, expected {want}")
    # the tolerances of phase 7's streamed fits against the one-card fit
    for key, rtol in (("loss", 1e-3), ("val_loss", cs.STREAM_VAL_RTOL)):
        ref = np.asarray(one["history"][key])
        rel = float(np.max(np.abs(np.asarray(ranks[0]["history"][key]) - ref) / np.abs(ref)))
        cs._check(rel <= rtol, f"the large streamed fit: {key} {ranks[0]['history'][key]} on "
                  f"{n} ranks vs {ref.tolist()} on one card, relative difference {rel:.3e} > "
                  f"{rtol}")
    return one, ranks


PAIR_EPOCHS = 3  # the in-memory fits of the graph pairs
PAIR_TIMEOUT = 900  # seconds for the spawned ranks of the graph pairs, start-up included


def pair_configs(n, kinds=("steps", "compiled")):
    """The graph pairs' fits on ``n`` ranks: {name: (genes, model_parallel,
    fit)}, ``fit`` "memory", "streamed" or "compiled".  Of ``kinds``
    "steps": the data-parallel grid n x 1 at 3451 genes, the grids (n / M)
    x M at MP_GENES for M = 2 and 4 where M divides n, and the streamed (n
    / 2) x 2 grid at MP_GENES; "compiled": the same in-memory grids with
    ``compiled=True`` on the first ``cs.DP_COMPILED_CELLS`` cells (a split
    that every grid's data indices divide)."""
    out = {}
    for kind, fit in (("steps", "memory"), ("compiled", "compiled")):
        if kind not in kinds:
            continue
        label = "in memory" if fit == "memory" else "compiled"
        out[f"{n}x1 {label}"] = (3451, 1, fit)
        for m in (2, 4):
            if n % m == 0:
                out[f"{n // m}x{m} {label} at {MP_GENES} genes"] = (MP_GENES, m, fit)
    if "steps" in kinds and n % 2 == 0:
        out[f"streamed {n // 2}x2 at {MP_GENES} genes"] = (MP_GENES, 2, "streamed")
    return out


def _pair_fit(counts, model, fit, graphs, devices):
    """One fit of the graph pairs: zinb-conddisp 64-32-64 on ``counts`` over
    ``devices`` ("all" on a spawned rank, n from this process) on a grid of
    ``model`` columns, in memory through ``dca()`` for PAIR_EPOCHS (with
    ``compiled=True`` on the first DP_COMPILED_CELLS cells where ``fit`` is
    "compiled") or streamed through ``train()`` (host tier, parts of
    STREAM_MAX_CELLS, DP_STREAM_EPOCHS) from ``_stream_state``'s weights,
    its steps (or the compiled fit's epochs) captured (``graphs``) or from
    Python (``_graphs=False``); {history, this rank's launches, epoch
    seconds, capture seconds, the digest of the final parameters (whole on
    every rank)}."""
    import hashlib

    import torch

    from dca_tpu_torch.ops import fused_loss as fl

    dev = torch.device("cuda")
    kw = {"_graphs": graphs}
    if fit == "compiled":
        counts, kw["compiled"] = counts[:cs.DP_COMPILED_CELLS], True
    if fit == "streamed":
        with cs._switches(cs.STREAM_TIERS["host"]):
            hist, launches, net = cs._stream_fit(
                dev, cs._lazy_adata(counts), cs._stream_state(dev, counts.shape[1]),
                cs.DP_STREAM_EPOCHS, verbose=False, devices=devices, model_parallel=model,
                max_device_cells=cs.STREAM_MAX_CELLS, _graphs=graphs)
    else:
        fl.reset_launches()
        _, net, hist = cs._mp_fit(counts, "zinb-conddisp", PAIR_EPOCHS, devices=devices,
                                  model_parallel=model, training_kwds=kw)
        launches = dict(fl.launches)
    torch.cuda.synchronize()
    digest = hashlib.sha1(b"".join(v.detach().cpu().numpy().tobytes()
                                   for v in net.model.state_dict().values())).hexdigest()
    return {"history": hist.history, "launches": launches, "epoch_s": hist.epoch_s,
            "capture_s": hist.capture_s, "params": digest}


def _pair_rank(rank, world, port, out_dir, kinds):
    """One spawned rank of the graph pairs, on its card over NCCL: each fit
    of ``pair_configs``, captured then eager."""
    import torch

    from dca_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{port}", world, rank, backend="nccl")
    counts = cs.make_paul15_like()
    res = {}
    for name, (genes, model, fit) in pair_configs(world, kinds).items():
        for graphs in (True, False):
            res[f"{name} {'captured' if graphs else 'eager'}"] = _pair_fit(
                counts[:, :genes], model, fit, graphs, "all")
    with open(os.path.join(out_dir, f"pairs{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _want_pair(n, model, fit, rank, graphs):
    """Rank ``rank``'s K1/K2 launches in a pair fit on ``n`` ranks: the
    whole-fit graph's warm-up runs one epoch more."""
    n_data = n // model
    if fit == "streamed":
        return cs.want_group_stream_launches(cs.DP_STREAM_EPOCHS, 2730, cs.STREAM_MAX_CELLS,
                                             n_data, rank // model, captured=graphs)
    if fit == "compiled":
        return cs.want_mp_launches("zinb", PAIR_EPOCHS + graphs, cs.DP_COMPILED_CELLS, n_data,
                                   rank // model)
    return cs.want_mp_launches("zinb", PAIR_EPOCHS, 2730, n_data, rank // model,
                               captured=graphs)


def phase_graph_pairs(n, cards, kinds=("steps", "compiled")):
    """The sharded step replayed from CUDA graphs over NCCL against the same
    step eager, in one call: each fit of ``pair_configs(n)``, captured and
    eager, on ``n`` spawned ranks (a card a rank) and launched from this
    process (``dca(devices=n)``/``train(devices=n)``).  Held, after every
    fit has run and printed: captured and
    eager the same bits (the histories, and the digest of the final
    parameters), spawned and launched the same bits, a capture recorded
    where the fit replays (the captured fits) and none elsewhere,
    the histories the same on every spawned rank, each spawned rank's launches
    (and the launched rank 0's) those of its schedule, the captured ones
    with their warm-ups (``want_mp_launches``,
    ``want_group_stream_launches``).  Prints each fit's first and steady
    epochs (the best of the epochs after the first) and capture seconds.
    Returns {fit: {spawned: rank 0's result, launched: this process's}}."""
    out_dir = os.path.join(cs.OUT_DIR, "pairs")
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(LOG_DIR, exist_ok=True)
    cs.run_ranks(_pair_rank, n, (out_dir, kinds), PAIR_TIMEOUT, "the graph pairs")
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"pairs{r}.json")) as f:
            ranks.append(json.load(f))
    counts = cs.make_paul15_like()
    launched = {}
    for name, (genes, model, fit) in pair_configs(n, kinds).items():
        for graphs in (True, False):
            launched[f"{name} {'captured' if graphs else 'eager'}"] = _pair_fit(
                counts[:, :genes], model, fit, graphs, n)
    out, bad = {}, []
    for name, (genes, model, fit) in pair_configs(n, kinds).items():
        fits = {}
        for how, res in (("spawned", ranks[0]), ("launched", launched)):
            for mode in ("captured", "eager"):
                fits[(how, mode)] = res[f"{name} {mode}"]
        base = fits[("spawned", "eager")]
        for (how, mode), f in fits.items():
            ep = [t * 1e3 for t in f["epoch_s"]]
            cap = "none" if f["capture_s"] is None else f"{f['capture_s']:.3f} s"
            print(f"graph pair {name}, {how} {mode} ({n} cards over NCCL): first epoch "
                  f"{ep[0]:.1f} ms, steady {min(ep[1:]):.1f} ms (epochs "
                  f"{[round(t, 1) for t in ep]}), capture {cap}; "
                  f"rank 0's launches { {k: v for k, v in f['launches'].items() if v} }; "
                  f"the eager spawned fit's bits: "
                  f"{f['history'] == base['history'] and f['params'] == base['params']}; "
                  f"cards: {'; '.join(cards[:n])}")
            if f["history"] != base["history"] or f["params"] != base["params"]:
                bad.append(f"{name}: {how} {mode} history {f['history']} (parameters "
                           f"{f['params']}) is not the eager spawned fit's {base['history']} "
                           f"({base['params']})")
            replays = mode == "captured"
            if (f["capture_s"] is not None) != replays:
                bad.append(f"{name}: {how} {mode} capture_s {f['capture_s']}")
            want = _want_pair(n, model, fit, 0, replays)
            if f["launches"] != want:
                bad.append(f"{name}: {how} {mode} rank 0 launched {f['launches']}, expected "
                           f"{want}")
        for rk, res in enumerate(ranks[1:], 1):
            for mode in ("captured", "eager"):
                f = res[f"{name} {mode}"]
                want = _want_pair(n, model, fit, rk, mode == "captured")
                if f["history"] != base["history"] or f["launches"] != want:
                    bad.append(f"{name}: spawned rank {rk} {mode}: history {f['history']}, "
                               f"launches {f['launches']} (expected {want})")
        out[name] = {f"{how} {mode}": f for (how, mode), f in fits.items()}
    with open(os.path.join(LOG_DIR, "graph_pairs.json"), "w") as f:
        json.dump({"fits": out, "bad": bad, "cards": cards[:n]}, f)
    cs._check(not bad, "the graph pairs: " + "; ".join(bad))
    return out


def _print_mp(mp, n, cards):
    for key, v in mp.items():
        print(f"zinb-conddisp 2730 x {MP_GENES} epoch on the grid {key.split('-', 2)[-1]} "
              f"({n} cards over NCCL, CUDA graphs): {[round(t * 1e3, 1) for t in v['epoch_s']]} ms "
              f"on rank 0, against {[round(t * 1e3, 1) for t in v['one_card_epoch_s']]} ms "
              f"on one card (CUDA graphs); per-rank launches "
              f"{[{k: c for k, c in r.items() if c} for r in v['launches']]}; largest "
              f"relative differences from one card {v['rel']}; cards: {'; '.join(cards[:n])}")


# the launcher's failure checks: {name: (who starts the ranks, what rank 1
# does, where)}: "launched" by ``train(devices=2)`` (``parallel/launch.py``)
# or "hand": two processes that join by ``init_process_group("nccl",
# init_method="env://")`` (no launcher: the group's own progress rule);
# rank 1 "dies" (exit code 3) or "hangs" (its process lives on, silent);
# "step": at the end of epoch 2 of a fit whose steps replay from CUDA
# graphs, "fit": once its device has run epoch 2 of the whole-fit graph
# (``compiled=True``)
FAIL_CASES = {
    "dies": ("launched", "dies", "step"), "hangs": ("launched", "hangs", "step"),
    "dies-fit": ("launched", "dies", "fit"), "hangs-fit": ("launched", "hangs", "fit"),
    "hand-dies": ("hand", "dies", "step"), "hand-hangs": ("hand", "hangs", "step"),
    "hand-dies-fit": ("hand", "dies", "fit"), "hand-hangs-fit": ("hand", "hangs", "fit"),
}
FAIL_TIMEOUT = 30.0  # the stall timeout in the failure checks, seconds
FAIL_LIMIT = 180  # seconds for each check's child process
FAIL_PAIRS = ("0,1", "2,3")  # the cards of the two checks that run at once
FAIL_EPOCHS = 5
# a launched worker that runs the real one, armed to fail
FAILING_WORKER = """
import sys
sys.path.insert(0, REPO)
import chip_dp
from dca_tpu_torch.parallel import launch
chip_dp.arm_failure(HOW, WHERE, FAILED_AT)
launch._worker_main(*(int(a) for a in sys.argv[1:4]))
"""


def arm_failure(how, where, failed_at):
    """Make this process's rank fail as ``how`` says ("dies": exit code 3;
    "hangs": its process lives on, silent) at ``where`` ("step": the end of
    epoch 2 of a Python-epoch fit, ``_FitCallbacks.end_epoch``; "fit":
    once the device has run epoch 2 of the whole-fit graph, before its
    point of progress, ``GraphFit.run_each``'s ``post``: so the other rank
    has run it too and is ahead by that point),
    first writing the wall time of the failure to ``failed_at``."""
    from dca_tpu_torch.train import compiled, loop

    def fail():
        with open(failed_at, "w") as f:
            f.write(repr(time.time()))
        sys.stderr.write(f"rank 1 {how} after epoch 2\n")
        sys.stderr.flush()
        if how == "dies":
            os._exit(3)
        time.sleep(3600)

    if where == "step":
        end = loop._FitCallbacks.end_epoch

        def failing(self, epoch, monitor):
            if epoch == 1:
                fail()
            return end(self, epoch, monitor)

        loop._FitCallbacks.end_epoch = failing
    else:
        post, posts = compiled.post_progress, []

        def failing_post():
            posts.append(1)
            if len(posts) == 2:
                fail()
            post()

        compiled.post_progress = failing_post


def _live_children():
    pid, kids = os.getpid(), set()
    for tid in os.listdir(f"/proc/{pid}/task"):
        try:
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                kids |= set(f.read().split())
        except OSError:
            pass
    return sorted(kids)


def _listen_port():
    """A free port below the host's ephemeral range, for rank 0's store: a
    port of that range that ``cs._free_port`` frees may be taken by another
    process's outgoing connection before the store listens on it
    (EADDRINUSE)."""
    import random
    import socket

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    while True:
        port = random.randrange(max(low - 8192, 1024), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port


def _fail_data(dev):
    """The failure checks' data: ``chip_smoke.py``'s matrix on its first
    DP_COMPILED_CELLS cells (a split that 2 ranks divide: ``compiled=True``
    takes the whole-fit graph), with phase 10's weights."""
    adata = cs._lazy_adata(cs.make_paul15_like()[:cs.DP_COMPILED_CELLS])
    return adata, cs._stream_state(dev, adata.n_vars)


def _hand_rank(how, where, failed_at):
    """Rank 1 of a "hand" check: joins the group from torchrun's
    variables, armed to fail."""
    import torch
    import torch.distributed as dist

    from dca_tpu_torch.parallel import launch

    launch.TIMEOUT_S = FAIL_TIMEOUT
    torch.cuda.set_device(1)
    dev = torch.device("cuda", 1)
    dist.init_process_group("nccl", init_method="env://")
    arm_failure(how, where, failed_at)
    adata, state = _fail_data(dev)
    cs._stream_fit(dev, adata, state, FAIL_EPOCHS, verbose=False, devices="all",
                   compiled=where == "fit")


def failure_child(name, dev, n_ranks=2):
    """The failure check ``name`` (FAIL_CASES) from this process, rank 0
    on ``dev``: a fit of zinb-conddisp 2720 x 3451 over NCCL, FAIL_EPOCHS
    epochs, its steps replayed ("step") or ``compiled=True`` ("fit"), whose
    rank 1 fails, with the stall timeout FAIL_TIMEOUT (``launch.TIMEOUT_S``);
    then a next fit in the same process (launched again, or with no
    group for a "hand" check).  Returns {the error's type and first lines,
    seconds to it from the call and from rank 1's failure, a group or
    children left, the next fit's history, ok}: ok for a ``LaunchError``
    naming rank 1 (its exit code where the launcher saw it exit, else its
    lack of progress) within FAIL_TIMEOUT + 30 s of its failure, nothing
    left, and a next fit that trains."""
    import torch
    import torch.distributed as dist

    from dca_tpu_torch.parallel import launch

    start, how, where = FAIL_CASES[name]
    launch.TIMEOUT_S = FAIL_TIMEOUT
    failed_at = os.path.join(LOG_DIR, f"failed_at_{name}")
    peer, inner = None, launch.worker_command
    if start == "launched":
        script = (FAILING_WORKER.replace("REPO", repr(REPO)).replace("HOW", repr(how))
                  .replace("WHERE", repr(where)).replace("FAILED_AT", repr(failed_at)))
        launch.worker_command = lambda rank, world, port: [
            sys.executable, "-c", script, str(port), str(rank), str(world)]
        devices = n_ranks
    else:
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_listen_port()),
                   WORLD_SIZE=str(n_ranks))
        with open(os.path.join(LOG_DIR, f"failure_{name}_rank1.err"), "w") as log:
            peer = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--hand-rank",
                                     how, where, failed_at], env=dict(env, RANK="1"),
                                    stdout=log, stderr=log, stdin=subprocess.DEVNULL)
        os.environ.update(env, RANK="0")
        dist.init_process_group("nccl", init_method="env://")
        devices = "all"
    adata, state = _fail_data(dev)
    t0 = time.perf_counter()
    err = None
    try:
        cs._stream_fit(dev, adata, state, FAIL_EPOCHS, verbose=False, devices=devices,
                       compiled=where == "fit")
    except Exception as e:  # what the caller sees
        err = e
    t_err, wall = time.perf_counter(), time.time()
    failed = float(open(failed_at).read()) if os.path.exists(failed_at) else None
    if peer is not None:
        peer.kill()
        out_peer = peer.wait()
    out = {"case": name, "seconds": t_err - t0,
           "after_failure_s": None if failed is None else wall - failed,
           "error": None if err is None else type(err).__name__,
           "message": "" if err is None else str(err)[:1500],
           "group_left": dist.is_initialized(), "children_left": _live_children()}
    if peer is not None:
        out["rank1_rc"] = out_peer
    what = ("exited with code 3" if start == "launched" and how == "dies"
            else f"made no progress for {FAIL_TIMEOUT:g} s")
    out["ok"] = (isinstance(err, launch.LaunchError) and f"rank 1 of {n_ranks}" in out["message"]
                 and what in out["message"] and not out["group_left"]
                 and not out["children_left"] and out["after_failure_s"] is not None
                 and out["after_failure_s"] < FAIL_TIMEOUT + 30)
    launch.worker_command = inner
    hist, _, _ = cs._stream_fit(dev, adata, state, 1, verbose=False,
                                devices=n_ranks if start == "launched" else None)
    out["next_fit"] = hist.history
    out["ok"] = out["ok"] and bool(np.isfinite(hist.history["loss"]).all()) and (
        not dist.is_initialized() and not _live_children())
    return out


def _start_failure_child(name, cards):
    """``failure_child(name)`` in its own interpreter and session, on
    ``cards``, its output into files (no pipe to fill while the other
    child is read): a caller that the failure kills shows as the child's
    exit code, and whatever the child leaves is killed with its
    session."""
    os.makedirs(LOG_DIR, exist_ok=True)
    cmd = [sys.executable, os.path.abspath(__file__), "--failure-child", name]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
    with open(os.path.join(LOG_DIR, f"failure_{name}.out"), "w") as out, \
            open(os.path.join(LOG_DIR, f"failure_{name}.err"), "w") as err:
        return subprocess.Popen(cmd, stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                                start_new_session=True, env=env)


def _end_failure_child(name, proc, t_end):
    """The result of ``_start_failure_child(name)``'s ``proc``, killed at
    ``t_end`` (monotonic seconds) if it has not ended."""
    try:
        rc = proc.wait(timeout=max(t_end - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = f"killed after {FAIL_LIMIT} s"
    try:
        os.killpg(proc.pid, signal.SIGKILL)  # anything of the child's left
    except ProcessLookupError:
        pass
    with open(os.path.join(LOG_DIR, f"failure_{name}.out")) as f:
        out = f.read()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    res = json.loads(lines[-1]) if lines else {"ok": False}
    res["rc"] = rc
    return res


def thread_timings(dev, n_ranks, cards):
    """The launched streamed (n_ranks / 2) x 2 fit at MP_GENES (host tier,
    DP_STREAM_EPOCHS) on a card a rank over NCCL, and the launched
    ``_one_card`` fit of 2 ranks on the first card over gloo (in memory,
    2730 x 3451), each with ``threads`` 1 (the launcher's default for gloo
    ranks) and the caller's default count (for NCCL ranks): epoch times,
    the same history both ways."""
    import torch

    counts = cs.make_paul15_like()
    default = torch.get_num_threads()
    fits = {
        f"streamed {n_ranks // 2}x2 at {MP_GENES} genes, NCCL": (
            cs._lazy_adata(counts[:, :MP_GENES]), cs._stream_state(dev, MP_GENES),
            dict(devices=n_ranks, model_parallel=2, max_device_cells=cs.STREAM_MAX_CELLS)),
        "2 ranks on one card, gloo": (
            cs._lazy_adata(counts), cs._stream_state(dev, counts.shape[1]),
            dict(devices=2, _one_card=True))}
    out = {}
    for name, (adata, state, kw) in fits.items():
        hists = {}
        for threads in (1, default):
            with cs._switches(cs.STREAM_TIERS["host"]):
                hist, launches, _ = cs._stream_fit(dev, adata, state, cs.DP_STREAM_EPOCHS,
                                                   verbose=False, threads=threads, **kw)
            torch.cuda.synchronize()
            label = f"{threads} thread(s) a rank"
            hists[label] = hist.history
            out[f"{name}, {label}"] = {"epoch_s": hist.epoch_s, "group_s": hist.launch["group_s"]}
            print(f"launched {name}, {label}: epochs "
                  f"{[round(t * 1e3, 1) for t in hist.epoch_s]} ms on rank 0, group formed "
                  f"after {hist.launch['group_s']:.2f} s; cards: {'; '.join(cards[:n_ranks])}")
        a, b = hists.values()
        for key, rtol in (("loss", 1e-3), ("val_loss", cs.STREAM_VAL_RTOL)):
            rel = float(np.max(np.abs(np.asarray(b[key]) - a[key]) / np.abs(a[key])))
            out[f"{name}: {key} relative difference"] = rel
            cs._check(bool(np.isfinite(a[key] + b[key]).all()) and rel <= rtol,
                      f"launched {name}: {key} {a[key]} with 1 thread a rank, {b[key]} with "
                      f"{default}, relative difference {rel:.3e} > {rtol}")
    return out


def phase_launch_checks(n, cards, names=tuple(FAIL_CASES)):
    """The failure checks ``names`` over NCCL, two at a time, each child on
    two cards of its own (FAIL_PAIRS)."""
    cs._check(n >= 4, f"--launch-checks runs its children on two cards each: {n} cards")
    failures = {}
    for i in range(0, len(names), len(FAIL_PAIRS)):
        t_end = time.monotonic() + FAIL_LIMIT
        procs = {name: _start_failure_child(name, pair)
                 for name, pair in zip(names[i:i + len(FAIL_PAIRS)], FAIL_PAIRS)}
        failures.update({name: _end_failure_child(name, proc, t_end)
                         for name, proc in procs.items()})
    for name, res in failures.items():
        print(f"launch check {name} {FAIL_CASES[name]}: {json.dumps(res)}")
    with open(os.path.join(LOG_DIR, "launch_checks.json"), "w") as f:
        json.dump({"failures": failures, "cards": cards[:n]}, f)
    bad = [name for name, res in failures.items() if not res.get("ok")]
    cs._check(not bad, f"the launcher's failure checks {bad} failed: {failures}")


def phase_thread_timings(n, cards):
    """``thread_timings`` on the ``n`` cards, written beside the checks."""
    import torch

    timings = thread_timings(torch.device("cuda"), n, cards)
    with open(os.path.join(LOG_DIR, "thread_timings.json"), "w") as f:
        json.dump({"threads": timings, "cards": cards[:n]}, f)


def main():
    import torch

    if sys.argv[1:2] == ["--failure-child"]:
        # the threads' stacks on stderr (the child's log) if it is still
        # running shortly before its limit
        faulthandler.dump_traceback_later(FAIL_LIMIT - 15)
        cs.phase_build()
        torch.cuda.set_device(0)
        res = failure_child(sys.argv[2], torch.device("cuda", 0))
        print(json.dumps(res))
        return 0 if res["ok"] else 1
    if sys.argv[1:2] == ["--hand-rank"]:
        faulthandler.dump_traceback_later(FAIL_LIMIT - 15)
        _hand_rank(*sys.argv[2:5])
        return 0
    flags = {"--compiled-pairs": functools.partial(phase_graph_pairs, kinds=("compiled",)),
             "--launch-checks": phase_launch_checks, "--thread-timings": phase_thread_timings}
    only = [phase for flag, phase in flags.items() if flag in sys.argv]
    sys.argv = [a for a in sys.argv if a not in flags]
    if not torch.cuda.is_available():
        print("chip_dp: no CUDA device; this script runs only on GPUs", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    if not 2 <= n <= torch.cuda.device_count():
        print(f"chip_dp: {n} ranks need 2 to {torch.cuda.device_count()} cards here",
              file=sys.stderr)
        return 1
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    models = tuple(m for m in (1, 2, 4) if n % m == 0)
    if only:
        failed = False
        try:
            cs.phase_build()
        except cs.SmokeFailure as e:
            print(f"chip_dp: FAILED: {e}", file=sys.stderr)
            return 1
        for phase in only:  # each runs whatever an earlier one gave
            try:
                phase(n, cards)
            except cs.SmokeFailure as e:
                print(f"chip_dp: FAILED: {e}", file=sys.stderr)
                failed = True
        return 1 if failed else 0
    try:
        cs.phase_build()
        phase_graph_pairs(n, cards)
        _, _, hist, _, tb = cs.phase_api("zinb-conddisp", 2, tensorboard=True)
        one = cs.epoch_timings(epochs=2)
        stream = cs.stream_reference(torch.device("cuda"))
        dp = cs.phase_data_parallel(hist, tb["histograms"], n, "nccl", val_rtol=1e-2,
                                    single_compiled=cs.dp_compiled_reference(),
                                    single_stream=stream)
        big_one, big = phase_big_stream(n)
        mp = cs.phase_model_parallel(n, "nccl", models=models, runs=MP_RUNS)
        launched = cs.phase_launch(dp, mp, n_ranks=n, one_card=False,
                                   runs=MP_RUNS)
    except cs.SmokeFailure as e:
        print(f"chip_dp: FAILED: {e}", file=sys.stderr)
        return 1
    _print_mp(mp, n, cards)
    for key, v in launched.items():
        print(f"launched {key} (dca()/train() from this process, {n} cards over NCCL): epochs "
              f"{[round(t * 1e3, 1) for t in v['epoch_s']]} ms on rank 0, against "
              f"{[round(t * 1e3, 1) for t in v['spawned_epoch_s']]} ms on the spawned ranks; "
              f"group formed {v['launch']['group_s']:.2f} s after the call, "
              f"{v['launch']['shared_bytes']} bytes of shared inputs; cards: "
              f"{'; '.join(cards[:n])}")
    print(f"zinb-conddisp 2730 x 3451 epoch: on one card {min(one['graph']):.1f} ms from "
          f"CUDA graphs, {min(one['eager']):.1f} ms eager (the best of 3 fits each); "
          f"{dp['per_epoch_s'] * 1e3:.1f} ms data parallel on {n} cards over NCCL (CUDA graphs); "
          f"cards: {'; '.join(cards[:n])}")
    for tier, ep in dp["stream"]["epoch_s"].items():
        print(f"streamed 2730 x 3451 epoch, parts of {cs.STREAM_MAX_CELLS} ({tier} tier): "
              f"{[round(t * 1e3, 1) for t in stream['epoch_s']]} ms on one card from CUDA "
              f"graphs, {[round(t * 1e3, 1) for t in ep]} ms on {n} cards over NCCL (CUDA graphs)")
    rel = {k: abs(big[0]["history"][k][0] / big_one["history"][k][0] - 1.0)
           for k in ("loss", "val_loss")}
    print(f"streamed {BIG_CELLS} x 3451 epoch, parts of {BIG_PART} (padded payloads): "
          f"{big_one['epoch_s'][0]:.3f} s on one card from CUDA graphs, "
          f"{big[0]['epoch_s'][0]:.3f} s on {n} cards over NCCL (CUDA graphs, rank 0); loss "
          f"{big_one['history']['loss']} / {big[0]['history']['loss']}, val_loss "
          f"{big_one['history']['val_loss']} / {big[0]['history']['val_loss']} (relative "
          f"differences {rel['loss']:.2e}, {rel['val_loss']:.2e}); launches "
          f"{big_one['launches']} on one card, {[r['launches'] for r in big]} on the ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
