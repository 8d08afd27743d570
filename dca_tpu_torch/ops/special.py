"""log Gamma and digamma from basic elementwise ops, for x > 0.

These are the plain PyTorch twins of the device functions in
``csrc/special.cuh``, which the fused NB loss kernels inline: the same
8-step branch-free recurrence that pushes the argument to z >= 8, then the
same Stirling and asymptotic series with the same constants, so a kernel
and its plain version agree to float rounding.  float32 accuracy is about
1e-6 relative for x >= 1e-4 (tests/test_torch_ops.py holds them against
scipy).
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_N_PUSH = 8  # x + 8 >= 8 for every x > 0 of the loss


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """log Gamma(x) for x > 0."""
    z = x.to(torch.float32)
    shift = torch.zeros_like(z)
    for _ in range(_N_PUSH):
        small = z < 8.0
        shift = shift + torch.where(small, torch.log(z), 0.0)
        z = torch.where(small, z + 1.0, z)
    zi = 1.0 / z
    zi2 = zi * zi
    # (z-1/2) ln z - z + ln(2 pi)/2 + 1/(12z) - 1/(360z^3) + 1/(1260z^5)
    series = zi * (1.0 / 12.0 + zi2 * (-1.0 / 360.0 + zi2 * (1.0 / 1260.0)))
    return (z - 0.5) * torch.log(z) - z + _HALF_LOG_2PI + series - shift


def digamma(x: torch.Tensor) -> torch.Tensor:
    """psi(x) for x > 0."""
    z = x.to(torch.float32)
    shift = torch.zeros_like(z)
    for _ in range(_N_PUSH):
        small = z < 8.0
        shift = shift + torch.where(small, 1.0 / z, 0.0)
        z = torch.where(small, z + 1.0, z)
    zi = 1.0 / z
    zi2 = zi * zi
    # psi(z) ~ ln z - 1/(2z) - 1/(12z^2) + 1/(120z^4) - 1/(252z^6)
    series = zi2 * (-1.0 / 12.0 + zi2 * (1.0 / 120.0 - zi2 * (1.0 / 252.0)))
    return torch.log(z) - 0.5 * zi + series - shift
