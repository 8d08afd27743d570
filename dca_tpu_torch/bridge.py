"""Turn the JAX package's parameters into the port's module state.

``params_from_jax(params, state)`` takes the ``dca_tpu`` params/state pytree
as nested dicts of numpy arrays (``{'trunk': {layer: {'kernel', 'bias',
'bn_beta'}}, 'branches': {branch: {layer: {...}}}, 'heads': {head:
{'kernel', 'bias'} or {'theta'}}}`` and the same ``trunk``/``branches``
layout of ``moving_mean``/``moving_var`` for the state) and returns the
state dict of a ``models.core.DCANetwork`` of the same definition, for
``net.load_state_dict(..., strict=True)``, which checks every name and
shape.  The names are the pytree paths joined by dots
(``branches.mean.dec1_last_mean.kernel``, ``heads.dispersion.theta``).
Kernels are (in, out) on both sides, and the elementwise pi kernel a
vector on both, so nothing is transposed.  The tests use it to run both
packages on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix, out):
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            _flatten(value, name, out)
        else:
            out[name] = torch.from_numpy(np.array(value, dtype=np.float32))


def params_from_jax(params, state):
    out = {}
    _flatten(params, "", out)
    _flatten(state, "", out)
    return out
