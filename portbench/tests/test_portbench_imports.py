"""Nothing the benchmark runs imports JAX, Flax, the JAX package or the
repository's JAX-side scripts, by top-level name compared whole
(``dca_tpu_torch`` is not ``dca_tpu``); the reference imports nothing of
the port either."""

import ast
import os
import subprocess
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = {"jax", "jaxlib", "flax", "dca_tpu", "bench", "chip_smoke", "chip_profile"}


def _sources():
    for d, _, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    path = os.path.join(BENCH_DIR, "harness", "reference.py")
    assert "dca_tpu_torch" not in set(_imports(path))


def test_a_run_loads_no_jax():
    """A CPU run of a cell in a fresh interpreter, then ``sys.modules``."""
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}]\n"
        "import run\n"
        "from harness.manifest import load_manifest, resolve\n"
        "cell = resolve(load_manifest(), 'zinb-conddisp.paul15')\n"
        "cell.traffic.update(cell.traffic['cpu_test'])\n"
        "run.run_cell(cell, 3, 0.3, 0, torch.device('cpu'))\n"
        "print('forbidden:' + ','.join(run.forbidden_modules()))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"
