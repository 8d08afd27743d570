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

``flatten_tree``/``unflatten_tree`` map such trees to and from their
paths; joined by "/" they are the keys of the JAX package's files
(``weights.hdf5``, the checkpoints' npz), which the port reads and writes.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten_tree(tree, sep="/", prefix=""):
    """{path: leaf} of a tree of nested dicts, the keys joined by ``sep``
    (the JAX package's pytree paths for "/"); empty dicts have no leaf."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{sep}{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_tree(value, sep, name))
        else:
            out[name] = value
    return out


def unflatten_tree(flat, sep="/"):
    """The nested dicts of a {path: leaf} mapping (``flatten_tree``'s
    inverse)."""
    tree = {}
    for path, leaf in flat.items():
        *parents, last = path.split(sep)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


@torch.no_grad()
def copy_tree_into(live, new):
    """Copy each array of ``new`` ({path: array or tensor}) into the tensor
    of ``live`` at its path, in place; each must be there, of its shape."""
    for key, t in live.items():
        if key not in new:
            raise KeyError(f"no array for {key!r}")
        src = new[key] if torch.is_tensor(new[key]) else torch.from_numpy(np.array(new[key]))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(src.shape)} vs the "
                             f"tensor's {tuple(t.shape)}")
        t.copy_(src.to(dtype=t.dtype))


def params_from_jax(params, state):
    return {name: torch.from_numpy(np.array(value, dtype=np.float32))
            for tree in (params, state) for name, value in flatten_tree(tree, ".").items()}
