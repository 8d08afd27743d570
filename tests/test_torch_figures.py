"""The port's examples (``examples/*_torch.py``): ``tests/test_figures.py``'s
four paper-figure checks run through ``dca_tpu_torch.dca`` on the CPU, at
the same sizes, epochs and thresholds (``slow``-marked, as there), and the
tutorial's pipeline at a small size (tier 1).

The examples are imported by their own module names, each ending in
``_torch``, so that a worker that also runs ``tests/test_figures.py`` (whose
examples share the stems) never takes one module for the other.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
sys.path.insert(0, EXAMPLES)


@pytest.mark.slow
def test_figure5_de_foldchange_preserved():
    from de_foldchange_torch import run_evaluation

    rho_orig, rho_dca, rho_smooth = run_evaluation(
        n_cells=300, n_genes=100, epochs=80, verbose=False, device="cpu"
    )
    assert rho_dca >= rho_orig - 0.05, (rho_dca, rho_orig)
    assert rho_dca > 0.6, rho_dca
    assert rho_dca > rho_smooth + 0.3, (rho_dca, rho_smooth)


@pytest.mark.slow
def test_figure8_nk_subtype_mclust_recovers_protein_split():
    from nk_subtype_mclust_torch import run_evaluation

    acc_o, p_o, acc_d, p_d = run_evaluation(
        n_cells=400, n_genes=100, epochs=80, verbose=False, device="cpu"
    )
    assert acc_d > acc_o + 0.05, (acc_o, acc_d)
    assert acc_d > 0.9, acc_d
    assert p_d < 1e-6, p_d
    assert p_d < p_o, (p_o, p_d)


@pytest.mark.slow
def test_figure9_pseudotime_branching_metrics():
    from pseudotime_branching_torch import run_evaluation

    res = run_evaluation(n_cells=500, n_genes=100, epochs=100, verbose=False, device="cpu")
    assert res["anti_dca"] < res["anti_raw"] - 0.05, res
    assert res["anti_dca"] < -0.4, res
    assert res["contrast_dca"] > res["contrast_raw"] + 0.1, res
    assert res["n_double_zero"] >= 10, res
    assert res["anti_double_zero"] < -0.15, res
    assert res["dpt_spearman_dca"] > 0.75, res
    assert res["dpt_spearman_dca"] > res["dpt_spearman_raw"] - 0.05, res


@pytest.mark.slow
def test_figure6_protein_rna_spearman_improves():
    from protein_rna_correlation_torch import run_evaluation

    r_orig, r_dca = run_evaluation(
        n_cells=400, n_genes=100, epochs=100, verbose=False, device="cpu"
    )
    assert np.median(r_dca) > np.median(r_orig) + 0.05, (
        np.median(r_orig), np.median(r_dca)
    )
    assert np.min(r_dca) > np.min(r_orig) - 0.15, (r_orig, r_dca)


def test_the_tutorial_pipeline_denoises_on_the_cpu():
    """``run_tutorial`` at 300 cells x 60 genes, 2 epochs: finite denoised
    counts of the input's shape, two epochs of finite losses, and finite
    silhouettes of the noisy, denoised and true counts."""
    from tutorial_torch import run_tutorial, silhouette

    res = run_tutorial(n_cells=300, n_genes=60, epochs=2, device="cpu", verbose=False)
    assert res["denoised"].shape == res["noisy"].shape == (300, 60)
    assert np.isfinite(res["denoised"]).all() and (res["denoised"] >= 0).all()
    assert len(res["history"]["loss"]) == 2
    assert np.isfinite(res["history"]["loss"] + res["history"]["val_loss"]).all()
    for name in ("noisy", "denoised", "true"):
        assert np.isfinite(silhouette(res[name], res["groups"])), name


RUN_SCRIPT = """
import json, runpy, sys
sys.argv = ["tutorial_torch.py", sys.argv[1], "--device", "cpu", "--cells", "300",
            "--genes", "60", "--epochs", "2"]
runpy.run_path({script!r}, run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "dca_tpu"))))
"""


def test_the_tutorial_script_imports_no_jax(tmp_path):
    """``python examples/tutorial_torch.py out --device cpu`` at the small
    size in a fresh interpreter: it prints the three silhouettes, writes
    the full outputs, and neither JAX nor the JAX package is imported."""
    script = RUN_SCRIPT.format(script=os.path.join(EXAMPLES, "tutorial_torch.py"))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", script, str(out)], capture_output=True,
                          text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == [], lines[-1]
    assert sum(line.startswith("silhouette") for line in lines) == 3, proc.stdout
    assert {"mean.tsv", "latent.tsv", "dropout.tsv"} <= set(os.listdir(out))
