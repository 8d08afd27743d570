"""Weight initializers with Keras semantics, drawn from a ``torch.Generator``.

The distributions are those of the JAX package's ``ops/initializers.py``
(default ``glorot_uniform``).  The random streams differ from JAX's, so the
parity tests copy JAX-initialised weights across with ``bridge.py``.
Each initializer is ``fn(generator, shape, device) -> float32 tensor``.
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[:-2]:
        receptive *= s
    return shape[-2] * receptive, shape[-1] * receptive


# Keras VarianceScaling divides the target stddev by the stddev of a
# [-2, 2]-truncated standard normal so the drawn values hit the target std
_TRUNC_STD = 0.87962566103838207


def _uniform(gen, shape, device, limit):
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (2.0 * limit) - limit


def _trunc_normal(gen, shape, device, stddev):
    t = torch.empty(shape, device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (stddev / _TRUNC_STD)


def glorot_uniform(gen, shape, device="cpu"):
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, device, math.sqrt(6.0 / (fan_in + fan_out)))


def glorot_normal(gen, shape, device="cpu"):
    fan_in, fan_out = _fans(shape)
    return _trunc_normal(gen, shape, device, math.sqrt(2.0 / (fan_in + fan_out)))


def he_uniform(gen, shape, device="cpu"):
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, device, math.sqrt(6.0 / fan_in))


def he_normal(gen, shape, device="cpu"):
    fan_in, _ = _fans(shape)
    return _trunc_normal(gen, shape, device, math.sqrt(2.0 / fan_in))


def lecun_uniform(gen, shape, device="cpu"):
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, device, math.sqrt(3.0 / fan_in))


def lecun_normal(gen, shape, device="cpu"):
    fan_in, _ = _fans(shape)
    return _trunc_normal(gen, shape, device, math.sqrt(1.0 / fan_in))


def zeros(gen, shape, device="cpu"):
    return torch.zeros(shape, device=device, dtype=torch.float32)


def ones(gen, shape, device="cpu"):
    return torch.ones(shape, device=device, dtype=torch.float32)


def random_uniform(gen, shape, device="cpu"):
    return _uniform(gen, shape, device, 0.05)


def random_normal(gen, shape, device="cpu"):
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.05


INITIALIZERS = {
    "glorot_uniform": glorot_uniform,
    "glorot_normal": glorot_normal,
    "he_uniform": he_uniform,
    "he_normal": he_normal,
    "lecun_uniform": lecun_uniform,
    "lecun_normal": lecun_normal,
    "zeros": zeros,
    "ones": ones,
    "random_uniform": random_uniform,
    "random_normal": random_normal,
}


def get_initializer(name):
    if callable(name):
        return name
    if name not in INITIALIZERS:
        raise ValueError(f"Unknown initializer {name!r}; available: {sorted(INITIALIZERS)}")
    return INITIALIZERS[name]
