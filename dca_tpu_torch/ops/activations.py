"""Activation functions, with the output heads' exact clips.

    MeanAct = clip(exp(x), 1e-5, 1e6)
    DispAct = clip(softplus(x), 1e-4, 1e4)

The hidden-layer registry holds the same names as the JAX package's
``dca_tpu/ops/activations.py``.  PReLU carries a trainable parameter and is
not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def MeanAct(x):
    return torch.clamp(torch.exp(x), 1e-5, 1e6)


def DispAct(x):
    return torch.clamp(F.softplus(x), 1e-4, 1e4)


def _linear(x):
    return x


def _leaky_relu(x):
    # Keras LeakyReLU default alpha=0.3
    return F.leaky_relu(x, negative_slope=0.3)


ACTIVATIONS = {
    "relu": torch.relu,
    "selu": F.selu,
    "elu": F.elu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "softsign": F.softsign,
    "hard_sigmoid": F.hardsigmoid,
    "exponential": torch.exp,
    "linear": _linear,
    "LeakyReLU": _leaky_relu,
    "leaky_relu": _leaky_relu,
}


def get_activation(name):
    if callable(name):
        return name
    if name not in ACTIVATIONS:
        raise ValueError(
            f"Unknown activation {name!r}; available: {sorted(ACTIVATIONS)} "
            "(PReLU waits for a later slice of the port, see ROADMAP.md)"
        )
    return ACTIVATIONS[name]
