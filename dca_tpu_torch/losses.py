"""Count-likelihood losses in plain PyTorch.

A port of the NB part of the JAX package's ``dca_tpu/losses.py``, with the
same numerical contract:

  * eps = 1e-10, theta clipped at 1e6;
  * mean (not sum) reduction;
  * NaN masking: NaN targets are zeroed for the terms, and the masked mean
    divides by the number of non-NaN targets (clamped to 1);
  * ``nan2inf`` applied elementwise before the reduction;
  * ``log(1.0 + x)``, not ``log1p``: this module is the op-order oracle, and
    the fused kernels (``ops/fused_loss.py``) may use ``log1p``.

``lgamma`` here is ``torch.lgamma``, the library function, as the JAX module
uses ``jax.lax.lgamma``.  ZINB, Poisson and MSE wait for the next slice of
the port (ROADMAP.md, Queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1e-10
THETA_CLIP = 1e6


def _nan2zero(x):
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def _nan2inf(x):
    return torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)


def _nelem(x):
    """Number of non-NaN elements, clamped to 1 to avoid 0/0."""
    nelem = torch.sum((~torch.isnan(x)).to(torch.float32))
    return torch.where(nelem == 0.0, torch.ones_like(nelem), nelem).to(x.dtype)


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
