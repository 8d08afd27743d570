"""On the card: one short run of each cell, through the benchmark's
command, ends in a result line with ``correct`` true."""

import json
import os
import subprocess
import sys

import pytest

from harness.manifest import load_manifest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in load_manifest()["workloads"]])
def test_a_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                          "--seed", "2147483711", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu"
