"""Keras-parity RMSprop on lists of tensors.

The port of the JAX package's ``train/optim.py:rmsprop``: rho 0.9, epsilon
1e-7 added outside the square root (``p -= lr * g / (sqrt(a) + eps)``), and
elementwise ``clipvalue`` clipping of the gradient before the update, not a
global norm.  The learning rate is an argument of ``update``: the trainer
passes a 0-d float32 tensor on the parameters' device, the counterpart of
the JAX package's ``lr_arr = jnp.float32(cbs.lr)``, which ReduceLROnPlateau
rewrites in place between epochs, so a CUDA graph that captured the step
reads the new rate at its next replay (``train/graphs.py``).  Its product
with the gradient is the float32 product a Python float gives, which
``update`` also takes; ``clipvalue`` stays a constant.

Unlike the JAX transform, ``update`` writes the new parameters and
accumulators in place (under ``torch.no_grad``), so a step allocates no
second copy of the model.  The other Keras optimizers wait for a later
slice (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    name: str
    default_lr: float
    init: Callable[[Any], Any]
    # update(grads, opt_state, params, lr): updates params and opt_state in
    # place; lr a 0-d float32 tensor on the params' device, or a float
    update: Callable[[Any, Any, Any, Any], None]


def rmsprop(clipvalue=None, rho=0.9, eps=1e-7):
    def init(params):
        return {"a": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        for p, g, a in zip(params, grads, opt_state["a"]):
            if clipvalue is not None:
                g = torch.clamp(g, -clipvalue, clipvalue)
            a.copy_(rho * a + (1.0 - rho) * torch.square(g))
            p.sub_(lr * g / (torch.sqrt(a) + eps))

    return Optimizer("RMSprop", 1e-3, init, update)


_FACTORIES = {"rmsprop": rmsprop}


def get_optimizer(name: str, clipvalue=None) -> Optimizer:
    """Resolve by (case-insensitive) Keras optimizer name."""
    key = name.lower()
    if key not in _FACTORIES:
        raise ValueError(
            f"Optimizer {name!r} is not ported yet; available: "
            f"{sorted(_FACTORIES)} (the rest wait for a later slice, see ROADMAP.md)"
        )
    return _FACTORIES[key](clipvalue=clipvalue)
