#!/usr/bin/env python3
"""Data-parallel training of the PyTorch/CUDA port on several cards of one
host, one rank per card over NCCL.

    python3 chip_dp.py [n_cards]     # default: every visible card

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
replayed from CUDA graphs) and on ``n_cards`` ranks over NCCL (eager):
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
epoch time beside the one card's.  Prints the cards' names and power
limits and the epoch times; exits non-zero on any failure.  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

BIG_CELLS, BIG_PART = 65_536, 16_384
MP_GENES = 3448
MP_RUNS = (("zinb-conddisp", "zinb-conddisp", MP_GENES, 2),)
BIG_TIMEOUT = 900  # seconds for the ranks of the large streamed fit, start-up included


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
        want = cs.want_group_stream_launches(1, BIG_CELLS, BIG_PART, n, rk)
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


def _print_mp(mp, n, cards):
    for key, v in mp.items():
        print(f"zinb-conddisp 2730 x {MP_GENES} epoch on the grid {key.split('-', 2)[-1]} "
              f"({n} cards over NCCL, eager): {[round(t * 1e3, 1) for t in v['epoch_s']]} ms "
              f"on rank 0, against {[round(t * 1e3, 1) for t in v['one_card_epoch_s']]} ms "
              f"on one card (CUDA graphs); per-rank launches "
              f"{[{k: c for k, c in r.items() if c} for r in v['launches']]}; largest "
              f"relative differences from one card {v['rel']}; cards: {'; '.join(cards[:n])}")


def main():
    import torch

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
    try:
        _, _, hist, _, tb = cs.phase_api("zinb-conddisp", 2, tensorboard=True)
        one = cs.epoch_timings(epochs=2)
        stream = cs.stream_reference(torch.device("cuda"))
        dp = cs.phase_data_parallel(hist, tb["histograms"], n, "nccl", val_rtol=1e-2,
                                    single_compiled=cs.dp_compiled_reference(),
                                    single_stream=stream)
        big_one, big = phase_big_stream(n)
        mp = cs.phase_model_parallel(n, "nccl", models=models, runs=MP_RUNS)
    except cs.SmokeFailure as e:
        print(f"chip_dp: FAILED: {e}", file=sys.stderr)
        return 1
    _print_mp(mp, n, cards)
    print(f"zinb-conddisp 2730 x 3451 epoch: on one card {min(one['graph']):.1f} ms from "
          f"CUDA graphs, {min(one['eager']):.1f} ms eager (the best of 3 fits each); "
          f"{dp['per_epoch_s'] * 1e3:.1f} ms data parallel on {n} cards over NCCL (eager); "
          f"cards: {'; '.join(cards[:n])}")
    for tier, ep in dp["stream"]["epoch_s"].items():
        print(f"streamed 2730 x 3451 epoch, parts of {cs.STREAM_MAX_CELLS} ({tier} tier): "
              f"{[round(t * 1e3, 1) for t in stream['epoch_s']]} ms on one card from CUDA "
              f"graphs, {[round(t * 1e3, 1) for t in ep]} ms on {n} cards over NCCL (eager)")
    rel = {k: abs(big[0]["history"][k][0] / big_one["history"][k][0] - 1.0)
           for k in ("loss", "val_loss")}
    print(f"streamed {BIG_CELLS} x 3451 epoch, parts of {BIG_PART} (padded payloads): "
          f"{big_one['epoch_s'][0]:.3f} s on one card from CUDA graphs, "
          f"{big[0]['epoch_s'][0]:.3f} s on {n} cards over NCCL (eager, rank 0); loss "
          f"{big_one['history']['loss']} / {big[0]['history']['loss']}, val_loss "
          f"{big_one['history']['val_loss']} / {big[0]['history']['val_loss']} (relative "
          f"differences {rel['loss']:.2e}, {rel['val_loss']:.2e}); launches "
          f"{big_one['launches']} on one card, {[r['launches'] for r in big]} on the ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
