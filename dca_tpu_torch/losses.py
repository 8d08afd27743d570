"""Count-likelihood losses in plain PyTorch.

A port of the JAX package's ``dca_tpu/losses.py`` (``mse_loss``,
``poisson_loss``, ``nb_nll``, ``zinb_nll``), with the same numerical
contract:

  * eps = 1e-10, theta clipped at 1e6, the ZINB zero branch at y < 1e-8
    on the original y (a NaN target takes the NB case), ridge * pi^2;
  * mean (not sum) reduction;
  * NaN masking: NaN targets are zeroed for the terms; NB and Poisson
    divide by the number of non-NaN targets, MSE and ZINB by the number of
    non-NaN results (``_reduce_mean_nan``), each clamped to 1;
  * ``nan2inf`` applied elementwise before the reduction for NB, after it
    for ZINB;
  * ``log(1.0 + x)``, not ``log1p``, and ``torch.pow`` for the NB zero
    probability: this module is the op-order oracle, and the fused kernels
    (``ops/fused_loss.py``) may use ``log1p`` and exp/log.

``lgamma`` here is ``torch.lgamma``, the library function, as the JAX module
uses ``jax.lax.lgamma``.  ``sample_weights`` is the JAX package's per-row
weighted mean (NaN targets weight 0).
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-10
THETA_CLIP = 1e6
ZERO_THRESHOLD = 1e-8


def _nan2zero(x):
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _nan2inf(x):
    return torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)


def _nelem(x):
    """Number of non-NaN elements, clamped to 1 to avoid 0/0."""
    nelem = torch.sum((~torch.isnan(x)).to(torch.float32))
    return torch.where(nelem == 0.0, torch.ones_like(nelem), nelem).to(x.dtype)


def _reduce_mean_nan(x):
    """Mean over the non-NaN elements of x (NaN counted as 0 in the sum)."""
    return torch.sum(_nan2zero(x)) / _nelem(x)


def _apply_weights(elem, y_true, sample_weights):
    """Weighted mean over elements; per-row weights broadcast over genes and
    NaN targets get weight 0."""
    w = sample_weights.to(elem.dtype)[:, None].expand(elem.shape)
    w = w * (~torch.isnan(y_true)).to(elem.dtype)
    total = torch.sum(w)
    total = torch.where(total == 0.0, torch.ones_like(total), total)
    return torch.sum(_nan2zero(elem) * w) / total


def _assert_finite(x, name):
    """The ``--debug`` sanitizer: abort on the first non-finite term."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError("dca_tpu_torch debug: " + name + " has inf/nan")


def mse_loss(y_true, y_pred, sample_weights: Optional[torch.Tensor] = None):
    """Masked mean squared error."""
    y_true = y_true.to(torch.float32)
    ret = torch.square(y_pred.to(torch.float32) - y_true)
    if sample_weights is not None:
        return _apply_weights(ret, y_true, sample_weights)
    return _reduce_mean_nan(ret)


def poisson_loss(y_true, y_pred, sample_weights: Optional[torch.Tensor] = None):
    """Poisson NLL ``y_pred - y log(y_pred + 1e-10) + lgamma(y + 1)``,
    averaged over the non-NaN targets."""
    y_pred = y_pred.to(torch.float32)
    y_true = y_true.to(torch.float32)
    y0 = _nan2zero(y_true)
    ret = y_pred - y0 * torch.log(y_pred + 1e-10) + torch.lgamma(y0 + 1.0)
    if sample_weights is not None:
        return _apply_weights(ret, y_true, sample_weights)
    return torch.sum(ret) / _nelem(y_true)


def nb_nll(
    y_true,
    y_pred,
    theta,
    *,
    masking: bool = False,
    scale_factor: float = 1.0,
    mean: bool = True,
    sample_weights: Optional[torch.Tensor] = None,
    debug: bool = False,
):
    """Negative binomial negative log-likelihood.

    ``theta`` broadcasts against ``y_pred``: (B, G) for conditional
    dispersion, (1, G) constant, (B, 1) shared."""
    eps = EPS
    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32) * scale_factor

    if masking and sample_weights is None:
        nelem = _nelem(y_true)
        y_true = _nan2zero(y_true)

    theta = torch.clamp(theta.to(torch.float32), max=THETA_CLIP)

    if debug:
        _assert_finite(y_pred, "y_pred")

    y_for_terms = _nan2zero(y_true) if sample_weights is not None else y_true

    t1 = (
        torch.lgamma(theta + eps)
        + torch.lgamma(y_for_terms + 1.0)
        - torch.lgamma(y_for_terms + theta + eps)
    )
    t2 = (theta + y_for_terms) * torch.log(1.0 + y_pred / (theta + eps)) + (
        y_for_terms * (torch.log(theta + eps) - torch.log(y_pred + eps))
    )

    if debug:
        _assert_finite(t1, "t1")
        _assert_finite(t2, "t2")

    final = _nan2inf(t1 + t2)

    if not mean:
        return final
    if sample_weights is not None:
        return _apply_weights(final, y_true, sample_weights)
    if masking:
        return torch.sum(final) / nelem
    return torch.mean(final)


def zinb_nll(
    y_true,
    y_pred,
    theta,
    pi,
    *,
    ridge_lambda: float = 0.0,
    masking: bool = False,
    scale_factor: float = 1.0,
    mean: bool = True,
    sample_weights: Optional[torch.Tensor] = None,
    debug: bool = False,
):
    """Zero-inflated NB negative log-likelihood.

    ``nb_case = NB_elementwise - log(1 - pi + eps)``; ``zero_case =
    -log(pi + (1 - pi) * (theta / (theta + mu + eps))**theta + eps)``,
    taken where ``y < 1e-8``; plus ``ridge_lambda * pi**2``.  ``debug``
    runs the NB sanitizer."""
    eps = EPS
    nb_elem = nb_nll(y_true, y_pred, theta, masking=masking, scale_factor=scale_factor,
                     mean=False, sample_weights=sample_weights, debug=debug)
    pi = pi.to(torch.float32)
    nb_case = nb_elem - torch.log(1.0 - pi + eps)

    y_true = y_true.to(torch.float32)
    y_pred = y_pred.to(torch.float32) * scale_factor
    theta = torch.clamp(theta.to(torch.float32), max=THETA_CLIP)

    zero_nb = torch.pow(theta / (theta + y_pred + eps), theta)
    zero_case = -torch.log(pi + ((1.0 - pi) * zero_nb) + eps)
    result = torch.where(y_true < ZERO_THRESHOLD, zero_case, nb_case)
    result = result + ridge_lambda * torch.square(pi)

    if mean:
        if sample_weights is not None:
            result = _apply_weights(result, y_true, sample_weights)
        elif masking:
            result = _reduce_mean_nan(result)
        else:
            result = torch.mean(result)
    return _nan2inf(result)
