#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the chip, at the cell's
own size (no window: a training cell's readings need none).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--faults 1,2,3]
                                   [--controls 4,5] [--out FILE]

For each seed of ``--seeds``: set-up as a run makes it (the warm-up
epoch and the traffic's further one-epoch fits, ``cell.more_states``),
then the numbers the check compares, of the program against the reference (the
sound readings; their largest is a limit's lower end).  For each seed of
``--controls`` or ``--faults`` also the control's: the reference in TF32,
the nearest precision below the configuration's float32, in the
program's place (its epoch against the float32 reference, its forward at
each of the program's states against the float64 judge).  For each of
``--faults`` also two faults planted in the reference put in the
program's place (half of each batch left out, the mean over the rest; the
likelihood's value off by 1%), against the float32 reference.  Every row
carries ``correct``: its numbers judged by the cell's limits, as a run
judges the program's.  A state left unchanged reads 1 on ``leaf_gap`` and
needs no run.  One JSON line a reading goes to ``--out`` and to standard
output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

FAULTS = (("half_batch", {"fault": "half_batch"}), ("loss_scale", {"fault": "loss_scale"}))


def readings(cell, seed, device, faults, control):
    from harness import cell as C
    from harness import reference as R

    t0 = time.perf_counter()
    s = C.setup(cell, seed, device)
    t_setup = time.perf_counter() - t0
    prog = C.program_readings(s)
    C.release(s)
    layers, heads = C.layer_names(cell.config["hidden_size"]), C.head_names(cell.config)
    t0 = time.perf_counter()
    inputs, truth = C.reference_epoch(cell, s, device)
    states, tf32_states = C.state_gaps(cell, s, inputs)
    t_ref = time.perf_counter() - t0
    numbers, detail = C.compare(cell, s, prog, truth, states)

    def row(kind, numbers, detail, **extra):
        return {"cell": cell.name, "seed": seed, "kind": kind, "numbers": numbers,
                "correct": C.judge(numbers, cell.limits), "detail": detail, **extra}

    out = [row("program", numbers, detail, setup_s=t_setup, reference_s=t_ref,
               loss=prog["loss"], val_loss=prog["val_loss"], ref_loss=truth["loss"],
               ref_val_loss=truth["val_loss"])]
    kinds = ((("tf32", {"precision": "tf32"}),) if control else ()) + (FAULTS if faults else ())
    for kind, kw in kinds:
        _, r = C.reference_epoch(cell, s, device, inputs=inputs, **kw)
        like = {"loss": r["loss"], "val_loss": r["val_loss"], "params": r["params"]}
        if kind == "tf32":
            # the control in the program's place at the program's states
            gaps = tf32_states
        else:
            at = R.eval_at(inputs, r["params"], r["moving"], layers, heads, s.n_train)
            gaps = {"fault": abs(r["val_loss"] - at) / at}
        out.append(row(kind, *C.compare(cell, s, like, truth, gaps)))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, BENCH_DIR)
    import run
    from harness.manifest import load_manifest, resolve

    run._cache_env()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = resolve(load_manifest(), args.workload)
    device = torch.device("cuda", 0)
    faults = {int(x) for x in args.faults.split(",") if x}
    controls = {int(x) for x in args.controls.split(",") if x} | faults
    seeds = [int(x) for x in args.seeds.split(",") if x]
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        import contextlib

        with contextlib.redirect_stdout(sys.stderr):
            rows = readings(cell, seed, device, seed in faults, seed in controls)
        for row in rows:
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
