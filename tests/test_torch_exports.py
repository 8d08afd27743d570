"""The port's import surface and CLI help against the JAX package's: each
subpackage re-exports the names of the matching ``dca_tpu`` subpackage's
``__all__`` (less the JAX-only mesh helpers), each imports first in a fresh
interpreter without a cycle, and the help text marks no option as not
ported; ``chip_smoke.py`` copied outside a
checkout stops with one line naming the missing package."""

import importlib
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SUBPACKAGES = ("data", "models", "ops", "parallel", "train")
# dca_tpu/parallel's jax.sharding helpers: the port runs one process per
# device (dca_tpu_torch/parallel/mesh.py) and has no counterpart of them
MESH_HELPERS = {"make_mesh", "param_sharding", "batch_sharding", "replicated"}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_exports_cover_the_jax_package(sub):
    theirs = importlib.import_module(f"dca_tpu.{sub}")
    ours = importlib.import_module(f"dca_tpu_torch.{sub}")
    want = set(theirs.__all__) - MESH_HELPERS
    assert want <= set(ours.__all__), sorted(want - set(ours.__all__))
    for name in ours.__all__:
        assert getattr(ours, name) is not None, name
        assert not getattr(getattr(ours, name), "__module__", "dca_tpu_torch").startswith(
            "dca_tpu."), name
    if sub == "parallel":
        assert set(theirs.__all__) - set(ours.__all__) == MESH_HELPERS


@pytest.mark.parametrize("sub", SUBPACKAGES + ("hyper", "diagnostics", "data.simulate"))
def test_imports_first_in_a_fresh_interpreter(sub):
    proc = subprocess.run([sys.executable, "-c", f"import dca_tpu_torch.{sub}"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_names_of_the_jax_examples_import():
    from dca_tpu_torch.data import normalize, read_dataset  # noqa: F401
    from dca_tpu_torch.models import ZINBAutoencoder  # noqa: F401
    from dca_tpu_torch.train import train  # noqa: F401


def test_help_marks_only_modelparallel_as_not_ported(capsys):
    """Since --modelparallel is ported the help marks no option as not
    ported, and says what --modelparallel needs as the JAX package's
    does."""
    from dca_tpu_torch.__main__ import parse_args

    with pytest.raises(SystemExit):
        parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "not ported" not in text
    assert re.findall(r"--[a-z]+", text[:text.index("Requires --devices")])[-1] == "--modelparallel"


def test_chip_smoke_outside_a_checkout_names_the_missing_package(tmp_path):
    """Copied alone into an empty directory, the script exits 1 with one
    line on stderr, before it looks for a card (so this runs on the CPU)."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert proc.stdout == ""
    lines = proc.stderr.strip().splitlines()
    assert len(lines) == 1 and "no dca_tpu_torch package" in lines[0], proc.stderr
