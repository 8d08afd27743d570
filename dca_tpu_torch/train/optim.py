"""Keras-parity optimizers on lists of tensors, updated in place.

The port of the JAX package's ``train/optim.py``: SGD, RMSprop, Adam,
Adamax, Nadam, Adagrad and Adadelta with its defaults and its formulas
(RMSprop rho 0.9, epsilon 1e-7 added outside the square root, ``p -= lr *
g / (sqrt(a) + eps)``; Adam's bias corrections ``sqrt(1 - b2**t) / (1 -
b1**t)`` on a step count t; Adagrad's accumulators starting at 0.1), and
elementwise ``clipvalue`` clipping of the gradient before the update, not
a global norm.  The learning rate is an argument of ``update``: the
trainer passes a 0-d float32 tensor on the parameters' device, the
counterpart of the JAX package's ``lr_arr = jnp.float32(cbs.lr)``, which
ReduceLROnPlateau rewrites in place between epochs, so a CUDA graph that
captured the step reads the new rate at its next replay
(``train/graphs.py``).  Its product with the gradient is the float32
product a Python float gives, which ``update`` also takes; ``clipvalue``
and the other hyperparameters stay constants.

Unlike the JAX transforms, ``update`` writes the new parameters and
state in place (under ``torch.no_grad``), so a step allocates no second
copy of the model and every tensor it writes keeps its address, as a
replayed CUDA graph needs.  The step count of Adam, Adamax and Nadam is a
0-d int32 tensor on the device, advanced in place, and their bias
corrections are computed from it on the device in float32, as
``t.astype(jnp.float32)`` gives them: nothing of an update goes through
the host.  ``state_tensors`` lists every tensor of a state, the step count
included, for the warm-up's restore before a capture.

RMSprop's update of parameters on a card is one launch of the kernel K5
for all of them (``ops/fused_optim.py``), the same bits as its plain loop,
which the CPU runs.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..ops import fused_optim


class Optimizer(NamedTuple):
    name: str
    default_lr: float
    init: Callable[[Any], Any]
    # update(grads, opt_state, params, lr): updates params and opt_state in
    # place; lr a 0-d float32 tensor on the params' device, or a float
    update: Callable[[Any, Any, Any, Any], None]


def state_tensors(opt_state):
    """Every tensor of an optimizer state: the tensors of each per-parameter
    list, and each lone tensor (a step count)."""
    out = []
    for value in opt_state.values():
        if torch.is_tensor(value):
            out.append(value)
        else:
            out.extend(value)
    return out


def _clip(g, clipvalue):
    return g if clipvalue is None else torch.clamp(g, -clipvalue, clipvalue)


def _zeros_like(params):
    return [torch.zeros_like(p) for p in params]


def _step_count(params):
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _advance(t):
    """t += 1 in place; the new count as float32."""
    t.add_(1)
    return t.to(torch.float32)


def sgd(clipvalue=None, momentum=0.0, nesterov=False):
    def init(params):
        return {"m": _zeros_like(params)} if momentum else {}

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        if not momentum:
            for p, g in zip(params, grads):
                p.sub_(lr * _clip(g, clipvalue))
            return
        for p, g, m in zip(params, grads, opt_state["m"]):
            g = _clip(g, clipvalue)
            m.copy_(momentum * m - lr * g)
            if nesterov:
                p.copy_(p + momentum * m - lr * g)
            else:
                p.add_(m)

    return Optimizer("SGD", 0.01, init, update)


def _rmsprop_loop(params, grads, accs, lr, clipvalue, rho, eps):
    """RMSprop's plain update, leaf by leaf: on the CPU the update itself,
    on a card the plain version of K5 (``ops/fused_optim.py``)."""
    for p, g, a in zip(params, grads, accs):
        g = _clip(g, clipvalue)
        a.copy_(rho * a + (1.0 - rho) * torch.square(g))
        p.sub_(lr * g / (torch.sqrt(a) + eps))


def rmsprop(clipvalue=None, rho=0.9, eps=1e-7):
    def init(params):
        return {"a": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        # parameters on a card: every leaf in one launch of K5, the same bits
        run = fused_optim.rmsprop if params and params[0].is_cuda else _rmsprop_loop
        run(params, grads, opt_state["a"], lr, clipvalue, rho, eps)

    return Optimizer("RMSprop", 1e-3, init, update)


def adam(clipvalue=None, b1=0.9, b2=0.999, eps=1e-7, amsgrad=False):
    def init(params):
        s = {"m": _zeros_like(params), "v": _zeros_like(params), "t": _step_count(params)}
        if amsgrad:
            s["vhat"] = _zeros_like(params)
        return s

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        tf = _advance(opt_state["t"])
        lr_t = lr * torch.sqrt(1.0 - torch.pow(b2, tf)) / (1.0 - torch.pow(b1, tf))
        vhats = opt_state["vhat"] if amsgrad else opt_state["v"]
        for p, g, m, v, vhat in zip(params, grads, opt_state["m"], opt_state["v"], vhats):
            g = _clip(g, clipvalue)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            if amsgrad:
                torch.maximum(vhat, v, out=vhat)
            p.sub_(lr_t * m / (torch.sqrt(vhat) + eps))

    return Optimizer("Adam", 1e-3, init, update)


def adamax(clipvalue=None, b1=0.9, b2=0.999, eps=1e-7):
    def init(params):
        return {"m": _zeros_like(params), "u": _zeros_like(params), "t": _step_count(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        tf = _advance(opt_state["t"])
        lr_t = lr / (1.0 - torch.pow(b1, tf))
        for p, g, m, u in zip(params, grads, opt_state["m"], opt_state["u"]):
            g = _clip(g, clipvalue)
            m.copy_(b1 * m + (1 - b1) * g)
            torch.maximum(b2 * u, torch.abs(g), out=u)
            p.sub_(lr_t * m / (u + eps))

    return Optimizer("Adamax", 1e-3, init, update)


def nadam(clipvalue=None, b1=0.9, b2=0.999, eps=1e-7):
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params), "t": _step_count(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        tf = _advance(opt_state["t"])
        c_next = 1 - torch.pow(b1, tf + 1)
        c_m = 1 - torch.pow(b1, tf)
        c_v = 1 - torch.pow(b2, tf)
        for p, g, m, v in zip(params, grads, opt_state["m"], opt_state["v"]):
            g = _clip(g, clipvalue)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            mhat = b1 * m / c_next + (1 - b1) * g / c_m
            vhat = v / c_v
            p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))

    return Optimizer("Nadam", 1e-3, init, update)


def adagrad(clipvalue=None, eps=1e-7, initial_accumulator=0.1):
    def init(params):
        return {"a": [torch.full_like(p, initial_accumulator) for p in params]}

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        for p, g, a in zip(params, grads, opt_state["a"]):
            g = _clip(g, clipvalue)
            a.add_(torch.square(g))
            p.sub_(lr * g / (torch.sqrt(a) + eps))

    return Optimizer("Adagrad", 1e-3, init, update)


def adadelta(clipvalue=None, rho=0.95, eps=1e-7):
    def init(params):
        return {"a": _zeros_like(params), "d": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, opt_state, params, lr):
        for p, g, a, d in zip(params, grads, opt_state["a"], opt_state["d"]):
            g = _clip(g, clipvalue)
            a.copy_(rho * a + (1 - rho) * torch.square(g))
            delta = g * torch.sqrt(d + eps) / torch.sqrt(a + eps)
            d.copy_(rho * d + (1 - rho) * torch.square(delta))
            p.sub_(lr * delta)

    return Optimizer("Adadelta", 1e-3, init, update)


_FACTORIES = {
    "sgd": sgd,
    "rmsprop": rmsprop,
    "adam": adam,
    "adamax": adamax,
    "nadam": nadam,
    "adagrad": adagrad,
    "adadelta": adadelta,
}


def get_optimizer(name: str, clipvalue=None) -> Optimizer:
    """Resolve by (case-insensitive) Keras optimizer name."""
    key = name.lower()
    if key not in _FACTORIES:
        raise ValueError(f"Unknown optimizer {name!r}; available: {sorted(_FACTORIES)}")
    return _FACTORIES[key](clipvalue=clipvalue)
