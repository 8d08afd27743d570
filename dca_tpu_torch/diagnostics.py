"""Model-checking diagnostics: the port of the JAX package's
``dca_tpu/diagnostics.py`` (the statistics of the reference's ``utils.py``).

  * closed-form NB/ZINB zero probabilities;
  * the likelihood-ratio test for zero-inflation;
  * the quadratic mean-variance fit for a moment estimate of theta;
  * the ZINB fit of scalar (mean, dispersion, dropout) by Adam on the exact
    NLL, and the gene-level zero model by L-BFGS-B: the JAX package's
    ``jax.value_and_grad`` becomes ``torch.autograd`` on the port's plain
    ``losses.zinb_nll``/``nb_nll``, which reach no fused kernel there either;
  * ``plot_mean_dropout``, ``plot_mean_var`` and ``plot_zeroinf`` (matplotlib).

The closed forms, the test, the moment estimate and the plots are numpy and
matplotlib, as in the JAX package.  Every function that computes in torch
takes ``device``: the CUDA device unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.stats import chi2

from .device import resolve_device
from .losses import nb_nll, zinb_nll


def _dense(X):
    if sp.issparse(X):
        return np.asarray(X.todense())
    return np.asarray(X)


# ---------------------------------------------------------------------------
# closed forms
# ---------------------------------------------------------------------------


def nb_zero(theta, mu):
    """P(X=0) under NB(mean=mu, dispersion=theta)."""
    return (theta / (theta + mu)) ** theta


def zinb_zero(theta, mu, pi):
    """P(X=0) under ZINB."""
    return pi + (1.0 - pi) * nb_zero(theta, mu)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def log_loss(pred, true):
    """Bernoulli cross-entropy."""
    eps = 1e-10
    return -(true * np.log(pred + eps) + (1.0 - true) * np.log(1.0 - pred + eps))


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


def lrt(ll_full, ll_reduced, df_full, df_reduced):
    """Likelihood ratio test p-value."""
    stat = 2.0 * (ll_full - ll_reduced)
    return chi2.sf(stat, df_full - df_reduced)


def estimate_theta_moments(X):
    """Moment estimate of a global theta from the quadratic mean-variance
    relation var = mu + mu^2/theta."""
    X = _dense(X)
    mu = X.mean(0)
    var = X.var(0)
    # least squares of var - mu ~ mu^2 / theta
    coef = np.linalg.lstsq(
        (mu**2).reshape(-1, 1), np.maximum(var - mu, 1e-10), rcond=None
    )[0][0]
    theta = 1.0 / max(coef, 1e-10)
    return float(theta)


def _adam_minimize(loss, p0, device, maxiter=2000, lr=0.05, b1=0.9, b2=0.999,
                   eps=1e-8):
    """Shared scalar-parameter Adam loop for the diagnostic ML fits, in
    float32 on ``device``."""
    p = torch.tensor(np.asarray(p0, np.float32), device=device)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for t_i in range(1, maxiter + 1):
        q = p.detach().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss(q), q)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g**2
        mhat = m / (1 - b1**t_i)
        vhat = v / (1 - b2**t_i)
        p = p - lr * mhat / (torch.sqrt(vhat) + eps)
    return p


def fit_zinb(y, maxiter=2000, lr=0.05, seed=0, device=None):
    """Fit scalar (mu, theta, pi) ZINB to a 1-D count sample by Adam on the
    exact ZINB NLL.

    Returns dict(mu, theta, pi, nll)."""
    device = resolve_device(device)
    y_np = np.asarray(y, np.float32).ravel()
    y = torch.from_numpy(y_np).to(device)

    def unpack(p):
        return torch.exp(p[0]), torch.exp(p[1]), torch.sigmoid(p[2])

    def loss(p):
        mu, theta, pi = unpack(p)
        return zinb_nll(y, mu.expand(y.shape), theta.expand(y.shape), pi.expand(y.shape))

    p = _adam_minimize(loss, [np.log(y_np.mean() + 1e-3), 0.0, 0.0], device,
                       maxiter=maxiter, lr=lr)
    mu, theta, pi = (float(x) for x in unpack(p))
    return {"mu": mu, "theta": theta, "pi": pi, "nll": float(loss(p))}


def optimize_zinb(mu, dropout, theta=None, maxiter=100, device=None):
    """Fit the reference's gene-level ZINB zero model:

        P(zero | gene) = pi + (1 - pi) * (t / (mu + t))**t,
        pi = sigmoid(a * log(mu + 1e-7) + b)

    minimizing the mean Bernoulli log-loss against the empirical per-gene
    dropout, by scipy's L-BFGS-B with float32 gradients from torch on
    ``device``, read back as float64.  ``theta=None`` also optimizes t
    (parameterized as exp, initialized at exp(-10)).

    Returns ``(a, b, t)``."""
    from scipy.optimize import minimize

    device = resolve_device(device)
    mu_t = torch.from_numpy(np.asarray(mu, np.float32).ravel()).to(device)
    dropout_t = torch.from_numpy(np.asarray(dropout, np.float32).ravel()).to(device)
    opt_t = theta is None
    eps = 1e-7  # tf.losses.log_loss epsilon

    def loss(p):
        a, b = p[0], p[1]
        t = torch.exp(p[2]) if opt_t else theta
        pi = torch.sigmoid(torch.log(mu_t + 1e-7) * a + b)
        pred = pi + (1.0 - pi) * (t / (mu_t + t)) ** t
        return -torch.mean(
            dropout_t * torch.log(pred + eps)
            + (1.0 - dropout_t) * torch.log(1.0 - pred + eps)
        )

    p0 = np.array([-1.0, 0.0, -10.0] if opt_t else [-1.0, 0.0], np.float64)

    def fun(p):
        q = torch.tensor(p, dtype=torch.float32, device=device, requires_grad=True)
        with torch.enable_grad():
            v = loss(q)
            (g,) = torch.autograd.grad(v, q)
        return float(v.detach()), g.cpu().numpy().astype(np.float64)

    res = minimize(fun, p0, jac=True, method="L-BFGS-B",
                   options={"maxiter": maxiter})
    a, b = float(res.x[0]), float(res.x[1])
    t = float(np.exp(res.x[2])) if opt_t else float(theta)
    return a, b, t


def zero_inflation_test(y, maxiter=2000, device=None):
    """LRT of ZINB vs NB on a count sample: fits both, returns p-value of the
    zero-inflation term (small p => zero-inflated)."""
    device = resolve_device(device)
    y_np = np.asarray(y, np.float32).ravel()
    z = fit_zinb(y_np, maxiter=maxiter, device=device)
    y = torch.from_numpy(y_np).to(device)

    def nb_loss(p):
        mu = torch.exp(p[0])
        theta = torch.exp(p[1])
        return nb_nll(y, mu.expand(y.shape), theta.expand(y.shape))

    p = _adam_minimize(nb_loss, [np.log(y_np.mean() + 1e-3), 0.0], device, maxiter=maxiter)
    nb_nll_val = float(nb_loss(p))
    n = y_np.size
    ll_full = -z["nll"] * n
    ll_red = -nb_nll_val * n
    return {"pvalue": float(lrt(ll_full, ll_red, 3, 2)), "zinb": z, "nb_nll": nb_nll_val}


# ---------------------------------------------------------------------------
# plots (matplotlib optional)
# ---------------------------------------------------------------------------


def _plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for diagnostics plots") from e


def _counts(adata):
    return _dense(adata.X if not hasattr(adata, "raw") or adata.raw is None else adata.raw.X)


def plot_mean_var(adata, out_file=None):
    """Per-gene mean-variance scatter with the fitted NB curve."""
    plt = _plt()
    X = _counts(adata)
    mu = X.mean(0)
    var = X.var(0)
    theta = estimate_theta_moments(X)
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.loglog(np.maximum(mu, 1e-3), np.maximum(var, 1e-3), ".", alpha=0.3, label="genes")
    xs = np.logspace(-3, np.log10(max(mu.max(), 1.0)), 100)
    ax.loglog(xs, xs + xs**2 / theta, "r-", label=f"NB fit (theta={theta:.2f})")
    ax.loglog(xs, xs, "k--", label="Poisson")
    ax.set_xlabel("gene mean")
    ax.set_ylabel("gene variance")
    ax.legend()
    if out_file:
        fig.savefig(out_file, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_file
    return fig


def plot_mean_dropout(adata, out_file=None, opt_zinb_theta=False, ax=None, device=None):
    """Per-gene mean vs empirical dropout with the NB and FITTED ZINB
    zero-probability curves, their log-losses, and the zero-inflation LRT
    p-value.

    The ZINB curve uses the global fit pi = sigmoid(a*log(mu)+b) from
    :func:`optimize_zinb` on ``device``; theta comes from the quadratic
    mean-variance moment fit unless ``opt_zinb_theta``.

    Returns dict(a, b, theta, nb_ll, zinb_ll, pvalue, fig) so callers can
    assert on the fit (the figure is in ``'fig'``)."""
    plt = _plt()
    X = _counts(adata)
    mu = X.mean(0)
    dropout = (X == 0).mean(0)
    theta = estimate_theta_moments(X)

    a, b, t = optimize_zinb(mu, dropout, theta=None if opt_zinb_theta else theta,
                            device=device)
    nb_pred = nb_zero(theta, mu)
    zinb_pred = zinb_zero(t, mu, sigmoid(np.log(mu + 1e-7) * a + b))
    # the reference's log_loss is the SUM of the Bernoulli cross-entropy
    nb_ll = float(log_loss(nb_pred, dropout).sum())
    zinb_ll = float(log_loss(zinb_pred, dropout).sum())
    pvalue = float(lrt(-zinb_ll, -nb_ll, 3, 1))

    fig = None
    if ax is None:
        fig, ax = plt.subplots(figsize=(10, 5))
    order = np.argsort(mu)
    ax.plot(mu, dropout, "o", c="black", markersize=1)
    ax.set(xscale="log")
    ax.plot(mu[order], nb_pred[order], color="red")
    ax.plot(mu[order], zinb_pred[order], color="green")
    ax.set_ylabel("Empirical dropout rate")
    ax.set_xlabel(r"Mean expression")
    ax.legend([
        "Genes",
        r"NB($\theta=%.2f)\ L=%.4f$" % (1.0 / theta, nb_ll),
        r"ZINB($\theta=%.2f,\pi=\sigma(%.2f\mu%+.2f))\ L=%.4f$"
        % (1.0 / t, a, b, zinb_ll),
    ])
    ret = dict(a=a, b=b, theta=t, nb_ll=nb_ll, zinb_ll=zinb_ll,
               pvalue=pvalue, fig=fig)
    if out_file and fig is not None:
        fig.savefig(out_file, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ret


def plot_zeroinf(adata, out_file=None, mean_var_plot=False, opt_theta=True, device=None):
    """Zero-inflation diagnostic figure: the mean-dropout panel with fitted
    NB/ZINB zero curves, optionally paired with the mean-variance panel.
    Returns the plot_mean_dropout fit dict."""
    plt = _plt()
    if mean_var_plot:
        fig, axs = plt.subplots(1, 2, figsize=(15, 5))
        _mean_var_panel(adata, axs[0])
        ret = plot_mean_dropout(adata, opt_zinb_theta=opt_theta, ax=axs[1], device=device)
    else:
        fig, ax = plt.subplots(1, 1, figsize=(10, 5))
        ret = plot_mean_dropout(adata, opt_zinb_theta=opt_theta, ax=ax, device=device)
    fig.tight_layout()
    ret["fig"] = fig
    if out_file:
        fig.savefig(out_file, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return ret


def _mean_var_panel(adata, ax):
    X = _counts(adata)
    mu = X.mean(0)
    var = X.var(0)
    theta = estimate_theta_moments(X)
    ax.loglog(np.maximum(mu, 1e-3), np.maximum(var, 1e-3), ".", alpha=0.3)
    xs = np.logspace(-3, np.log10(max(mu.max(), 1.0)), 100)
    ax.loglog(xs, xs + xs**2 / theta, "r-")
    ax.loglog(xs, xs, "k--")
    ax.set_xlabel("gene mean")
    ax.set_ylabel("gene variance")
    ax.legend(["genes", f"NB fit (theta={theta:.2f})", "Poisson"])
