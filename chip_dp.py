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
2720 cells is held to the one-card compiled fit likewise.  val_loss gets
more room than phase 7's 1e-3: the
Dense bias before each BatchNorm has a gradient that is zero in exact
arithmetic and rounding noise in float32, which RMSprop scales up to
steps of the learning rate; the eval-mode BatchNorm carries that drift
into val_loss (and the eval-mode gradients), and cuBLAS rounds a rank's
block of 8 rows otherwise than the whole batch of 32 (at 2 ranks phase 7
measured 4e-4 to 8e-4).  Prints the cards' names and power limits and
both epoch times; exits non-zero on
any failure.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_dp: no CUDA device; this script runs only on GPUs", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    n = int(sys.argv[1]) if len(sys.argv) > 1 else torch.cuda.device_count()
    if not 2 <= n <= torch.cuda.device_count():
        print(f"chip_dp: {n} ranks need 2 to {torch.cuda.device_count()} cards here",
              file=sys.stderr)
        return 1
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    try:
        _, _, hist, _, tb = cs.phase_api("zinb-conddisp", 2, tensorboard=True)
        one = cs.epoch_timings(epochs=2)
        dp = cs.phase_data_parallel(hist, tb["histograms"], n, "nccl", val_rtol=1e-2,
                                    single_compiled=cs.dp_compiled_reference())
    except cs.SmokeFailure as e:
        print(f"chip_dp: FAILED: {e}", file=sys.stderr)
        return 1
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip().splitlines()
    print(f"zinb-conddisp 2730 x 3451 epoch: on one card {min(one['graph']):.1f} ms from "
          f"CUDA graphs, {min(one['eager']):.1f} ms eager (the best of 3 fits each); "
          f"{dp['per_epoch_s'] * 1e3:.1f} ms data parallel on {n} cards over NCCL (eager); "
          f"cards: {'; '.join(cards[:n])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
