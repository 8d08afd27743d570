"""Turn the JAX package's parameters into the port's module state.

``params_from_jax(params, state)`` takes the ``dca_tpu`` params/state pytree
as nested dicts of numpy arrays (``{'trunk': {layer: {'kernel', 'bias',
'bn_beta'}}, 'heads': {head: {'kernel', 'bias'}}}`` and ``{'trunk': {layer:
{'moving_mean', 'moving_var'}}}``) and returns the state dict of a
``models.core.DCANetwork`` of the same definition, for
``net.load_state_dict(..., strict=True)``, which checks every name and
shape.  Kernels are (in, out) on both sides, so nothing is transposed.
The tests use it to run both packages on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params, state):
    if params.get("branches") or state.get("branches"):
        raise NotImplementedError("fork branches are not ported yet (ROADMAP.md)")
    out = {}
    for group, tree in (("trunk", params["trunk"]), ("heads", params["heads"]),
                        ("trunk", state.get("trunk", {}))):
        for layer, leaves in tree.items():
            for key, value in leaves.items():
                out[f"{group}.{layer}.{key}"] = torch.from_numpy(
                    np.array(value, dtype=np.float32))
    return out
