"""The port's diagnostics (``dca_tpu_torch/diagnostics.py``) against the JAX
package's ``dca_tpu/diagnostics.py`` on the samples of
tests/test_diagnostics.py, on the CPU, and that file's assertions on the
port.

Tolerances: the fitted mu, theta, pi of ``fit_zinb`` within rtol 1e-3 and
its NLL within rtol 1e-5 (both run 1500 float32 Adam steps on the same
loss, whose lgamma/log/pow round in other ways in torch and XLA);
``optimize_zinb``'s (a, b, t) within rtol 1e-3, or, where L-BFGS-B's line
search took another branch on the float32 gradients, its objective at the
two optima within rtol 1e-5; ``zero_inflation_test``'s p-value within the
bound the NLLs' rtol 1e-5 implies: p is chi2's tail at 2 n (nb_nll - zinb
nll), so |log p - log p'| <= n 1e-5 (|zinb nll| + |nb_nll|)
(``chip_smoke.pvalue_log_tol``; the measured distances are in CHANGES.md).
"""

import os

import numpy as np
import pytest
import torch

from dca_tpu import diagnostics as jdg

from chip_smoke import (DIAG_NLL_RTOL, DIAG_OBJ_RTOL, DIAG_PARAM_RTOL, _diag_samples,
                        _zero_model_loss, pvalue_log_tol)
from conftest import make_counts
from dca_tpu_torch import diagnostics as dg
from dca_tpu_torch.data.adata import AnnData

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

CPU = "cpu"


@pytest.fixture(scope="module")
def samples():
    return _diag_samples()


@pytest.fixture(scope="module")
def zinb_fits(samples):
    y = samples[0]
    return dg.fit_zinb(y, maxiter=1500, device=CPU), jdg.fit_zinb(y, maxiter=1500)


@pytest.fixture(scope="module")
def zi_tests(samples):
    y_zi = samples[1]
    return (dg.zero_inflation_test(y_zi, maxiter=1200, device=CPU),
            jdg.zero_inflation_test(y_zi, maxiter=1200))


def test_samples_are_the_jax_tests_samples(samples):
    """chip_smoke's copy of the samples of tests/test_diagnostics.py, which
    phase 12 runs on the card."""
    from test_diagnostics import _sim_counts

    rs = np.random.RandomState(1)
    y = rs.negative_binomial(2.0, 2.0 / 6.0, size=5000)
    y = np.where(rs.uniform(size=y.shape) < 0.3, 0, y).astype(np.float32)
    np.testing.assert_array_equal(samples[0], y)
    np.testing.assert_array_equal(samples[2], _sim_counts(0.0))
    np.testing.assert_array_equal(samples[3], _sim_counts(0.35))


def test_fit_zinb_matches_jax(zinb_fits):
    ours, theirs = zinb_fits
    for k in ("mu", "theta", "pi"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=DIAG_PARAM_RTOL, err_msg=k)
    np.testing.assert_allclose(ours["nll"], theirs["nll"], rtol=DIAG_NLL_RTOL)


def test_zero_inflation_test_matches_jax(zi_tests, samples):
    ours, theirs = zi_tests
    np.testing.assert_allclose(ours["zinb"]["nll"], theirs["zinb"]["nll"], rtol=DIAG_NLL_RTOL)
    np.testing.assert_allclose(ours["nb_nll"], theirs["nb_nll"], rtol=DIAG_NLL_RTOL)
    log_d = abs(np.log(ours["pvalue"]) - np.log(theirs["pvalue"]))
    assert log_d <= pvalue_log_tol(theirs, samples[1].size), (ours["pvalue"], theirs["pvalue"])


@pytest.mark.parametrize("which", [2, 3], ids=["nb", "zero-inflated"])
def test_optimize_zinb_matches_jax(samples, which):
    counts = samples[which]
    mu, dropout = counts.mean(0), (counts == 0).mean(0)
    theta = jdg.estimate_theta_moments(counts)
    assert dg.estimate_theta_moments(counts) == theta
    ours = dg.optimize_zinb(mu, dropout, theta=theta, device=CPU)
    theirs = jdg.optimize_zinb(mu, dropout, theta=theta)
    if not np.allclose(ours, theirs, rtol=DIAG_PARAM_RTOL, atol=0.0):
        # another branch of the line search: the same optimum's value
        np.testing.assert_allclose(_zero_model_loss(mu, dropout, *ours),
                                   _zero_model_loss(mu, dropout, *theirs), rtol=DIAG_OBJ_RTOL)


def test_closed_forms_and_plots_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    rs = np.random.RandomState(0)
    th, mu, pi = rs.uniform(0.1, 5, 50), rs.uniform(0.1, 9, 50), rs.uniform(0, 1, 50)
    np.testing.assert_array_equal(dg.zinb_zero(th, mu, pi), jdg.zinb_zero(th, mu, pi))
    np.testing.assert_array_equal(dg.log_loss(pi, mu > 4), jdg.log_loss(pi, mu > 4))
    assert dg.lrt(-10.0, -14.0, 3, 1) == jdg.lrt(-10.0, -14.0, 3, 1)
    ad = AnnData(make_counts(100, 40, seed=3))
    ours = dg.plot_mean_dropout(ad, out_file=str(tmp_path / "ours.png"), device=CPU)
    theirs = jdg.plot_mean_dropout(ad, out_file=str(tmp_path / "theirs.png"))
    assert os.path.exists(tmp_path / "ours.png")
    for k in ("nb_ll", "zinb_ll"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=DIAG_NLL_RTOL, err_msg=k)


# tests/test_diagnostics.py's assertions, on the port


def test_nb_zero_closed_form():
    assert abs(dg.nb_zero(1.0, 2.0) - 1.0 / 3.0) < 1e-12
    assert abs(dg.zinb_zero(1.0, 2.0, 0.5) - (0.5 + 0.5 / 3.0)) < 1e-12


def test_estimate_theta_moments():
    rs = np.random.RandomState(0)
    theta = 2.0
    mu = rs.gamma(3.0, 2.0, size=(1, 300))
    X = rs.negative_binomial(theta, theta / (theta + mu), size=(3000, 300))
    est = dg.estimate_theta_moments(X.astype(np.float32))
    assert 1.0 < est < 4.0, est


def test_fit_zinb_recovers_params(zinb_fits):
    fit = zinb_fits[0]
    assert abs(fit["mu"] - 4.0) / 4.0 < 0.15, fit
    assert abs(fit["pi"] - 0.3) < 0.1, fit
    assert abs(fit["theta"] - 2.0) / 2.0 < 0.5, fit


def test_zero_inflation_test_detects(zi_tests):
    res = zi_tests[0]
    assert res["pvalue"] < 0.01, res


def test_plots(tmp_path):
    pytest.importorskip("matplotlib")
    ad = AnnData(make_counts(100, 40, seed=3))
    out = dg.plot_mean_var(ad, out_file=str(tmp_path / "mv.png"))
    assert os.path.exists(out)
    for fn in (dg.plot_mean_dropout, dg.plot_zeroinf):
        path = str(tmp_path / f"{fn.__name__}.png")
        ret = fn(ad, out_file=path, device=CPU)
        assert os.path.exists(path)
        assert np.isfinite(ret["zinb_ll"]) and np.isfinite(ret["pvalue"])
    dg.plot_zeroinf(ad, out_file=str(tmp_path / "zi_mv.png"), mean_var_plot=True, device=CPU)
    assert os.path.exists(str(tmp_path / "zi_mv.png"))


def test_zinb_zero_fit_rises_on_zero_inflated_sim(samples):
    def fitted_pi(counts):
        mu = counts.mean(0)
        dropout = (counts == 0).mean(0)
        theta = dg.estimate_theta_moments(counts)
        a, b, _ = dg.optimize_zinb(mu, dropout, theta=theta, device=CPU)
        return float(dg.sigmoid(np.log(np.median(mu) + 1e-7) * a + b))

    pi_nb, pi_zi = fitted_pi(samples[2]), fitted_pi(samples[3])
    assert pi_zi > 0.1, pi_zi
    assert pi_nb < 0.05, pi_nb
    assert pi_zi > pi_nb + 0.08, (pi_zi, pi_nb)


def test_plot_zeroinf_pvalue_discriminates(samples):
    pytest.importorskip("matplotlib")
    ret_zi = dg.plot_mean_dropout(AnnData(samples[3]), device=CPU)
    ret_nb = dg.plot_mean_dropout(AnnData(samples[2]), device=CPU)
    assert ret_zi["pvalue"] < 0.01, ret_zi
    assert ret_zi["zinb_ll"] < ret_zi["nb_ll"]
    gain_zi = ret_zi["nb_ll"] - ret_zi["zinb_ll"]
    gain_nb = ret_nb["nb_ll"] - ret_nb["zinb_ll"]
    assert gain_zi > gain_nb


def test_diagnostics_run_on_the_card_by_default(monkeypatch, samples):
    """Like every entry point, the diagnostics that compute in torch run on
    the CUDA device unless asked for the CPU: none falls back silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counts = samples[2]
    for call in (lambda: dg.fit_zinb(samples[0], maxiter=1),
                 lambda: dg.zero_inflation_test(samples[1], maxiter=1),
                 lambda: dg.optimize_zinb(counts.mean(0), (counts == 0).mean(0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
