"""Autoencoder core: the network definition, its parameters as an
``nn.Module``, and the forward pass.

A port of the JAX package's ``dca_tpu/models/core.py``.  ``build_definition``
is the same pure-Python description of all 11 reference architectures; the
parameters and batch-norm statistics live in ``DCANetwork``, named like the
JAX pytree (``trunk.<layer>.kernel``, ``branches.<branch>.<layer>.bias``,
``heads.<head>.bias``, the constant head's ``heads.dispersion.theta``, ...),
with each dense ``kernel`` kept (in, out) as JAX stores it and the
elementwise pi head's kernel a vector (units,).  ``apply`` returns the
same outputs dict and the new batch-norm state:

    outputs = {
      'output':    MeanAct(mean_logits) * size_factors
      'mean':      MeanAct(mean_logits)          (alias 'mean_norm')
      'disp':      dispersion: (B, G), (B, 1) for *-shared, or the constant
                   head's (1, G) clip(exp(theta), 1e-3, 1e4); None for
                   normal and poisson
      'pi':        dropout probability of the ZINB heads: (B, G), (B, 1)
                   for zinb-shared; None otherwise
      'latent':    center Dense output before BN/activation
      'decoded':   last trunk hidden (None for the fork architectures)
    }

Trunk layer = Dense -> BatchNorm(center only) -> activation -> dropout, with
Keras BatchNorm semantics: no gamma, eps 1e-3, the biased batch variance
both for normalising and for the moving update, and
``moving = 0.99 * moving + 0.01 * batch``.  ``nn.BatchNorm1d`` is not used:
it updates its running variance with the unbiased variance.  The fork
architectures' decoder branches (``branches.<mean|disp|pi>.<layer>``) are
such layers too, each with its own batch-norm state.

All 11 architectures of the JAX package run here; the PReLU activation
(its trainable alpha) waits for a later slice (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.activations import DispAct, MeanAct, get_activation
from ..ops.initializers import get_initializer

BN_EPS = 1e-3
BN_MOMENTUM = 0.99
THETA_EXP_CLIP = (1e-3, 1e4)


@dataclasses.dataclass(frozen=True)
class LayerDef:
    name: str
    in_dim: int
    units: int
    l1: float
    l2: float
    dropout: float
    batchnorm: bool


@dataclasses.dataclass(frozen=True)
class HeadDef:
    name: str
    in_dim: int
    units: int
    l1: float
    l2: float
    kind: str  # 'dense' | 'elementwise' | 'constant'
    activation: str  # 'mean' | 'disp' | 'sigmoid' | 'linear' | 'none'


@dataclasses.dataclass(frozen=True)
class NetworkDef:
    ae_type: str
    input_size: int
    output_size: int
    likelihood: str  # 'mse' | 'poisson' | 'nb' | 'zinb'
    activation: str
    init: str
    input_dropout: float
    shared: Tuple[LayerDef, ...]
    branches: Dict[str, Tuple[LayerDef, ...]]  # fork decoder branches, {} if not fork
    heads: Dict[str, HeadDef]
    branch_of_head: Dict[str, str]  # head name -> branch feeding it ('' = shared trunk)
    elempi_shared: bool = False
    ridge: float = 0.0
    debug: bool = False


# ---------------------------------------------------------------------------
# definition builder
# ---------------------------------------------------------------------------

_STAGE_HEADS = {
    # ae_type -> (disp_kind, has_pi, fork)
    "normal": (None, False, False),
    "poisson": (None, False, False),
    "nb": ("constant", False, False),
    "nb-conddisp": ("conddisp", False, False),
    "nb-shared": ("shared", False, False),
    "nb-fork": ("conddisp", False, True),
    "zinb": ("constant", True, False),
    "zinb-conddisp": ("conddisp", True, False),
    "zinb-shared": ("shared", True, False),
    "zinb-fork": ("conddisp", True, True),
    "zinb-elempi": ("conddisp", True, False),
}

LIKELIHOODS = {
    "normal": "mse",
    "poisson": "poisson",
    "nb": "nb",
    "nb-conddisp": "nb",
    "nb-shared": "nb",
    "nb-fork": "nb",
    "zinb": "zinb",
    "zinb-conddisp": "zinb",
    "zinb-shared": "zinb",
    "zinb-fork": "zinb",
    "zinb-elempi": "zinb",
}


def build_definition(
    ae_type: str,
    input_size: int,
    output_size: Optional[int] = None,
    hidden_size: Sequence[int] = (64, 32, 64),
    l2_coef: float = 0.0,
    l1_coef: float = 0.0,
    l2_enc_coef: float = 0.0,
    l1_enc_coef: float = 0.0,
    ridge: float = 0.0,
    hidden_dropout=0.0,
    input_dropout: float = 0.0,
    batchnorm: bool = True,
    activation: str = "relu",
    init: str = "glorot_uniform",
    sharedpi: bool = False,
    debug: bool = False,
) -> NetworkDef:
    if ae_type not in _STAGE_HEADS:
        raise ValueError(f"Unknown ae_type {ae_type!r}; available: {sorted(_STAGE_HEADS)}")
    disp_kind, has_pi, fork = _STAGE_HEADS[ae_type]
    output_size = input_size if output_size is None else output_size
    hidden_size = tuple(int(h) for h in hidden_size)

    if isinstance(hidden_dropout, (list, tuple)):
        if len(hidden_dropout) != len(hidden_size):
            raise ValueError("hidden_dropout needs one rate per hidden layer")
        dropouts = tuple(float(d) for d in hidden_dropout)
    else:
        dropouts = (float(hidden_dropout),) * len(hidden_size)

    center_idx = int(np.floor(len(hidden_size) / 2.0))

    shared: List[LayerDef] = []
    branch_names: List[str]
    if not fork:
        branch_names = []
    elif has_pi:
        branch_names = ["mean", "disp", "pi"]
    else:
        branch_names = ["mean", "disp"]
    branches: Dict[str, List[LayerDef]] = {b: [] for b in branch_names}

    in_dim = input_size
    branch_in = None
    for i, (hid_size, hid_drop) in enumerate(zip(hidden_size, dropouts)):
        if i == center_idx:
            layer_name, stage = "center", "center"
        elif i < center_idx:
            layer_name, stage = f"enc{i}", "encoder"
        else:
            layer_name, stage = f"dec{i - center_idx}", "decoder"

        # encoder-specific l1/l2 overrides
        l1 = l1_enc_coef if (l1_enc_coef != 0.0 and stage in ("center", "encoder")) else l1_coef
        l2 = l2_enc_coef if (l2_enc_coef != 0.0 and stage in ("center", "encoder")) else l2_coef

        if fork and i > center_idx:
            for b in branch_names:
                prev = branches[b][-1].units if branches[b] else branch_in
                branches[b].append(
                    LayerDef(
                        name=f"{layer_name}_last_{b}",
                        in_dim=prev,
                        units=hid_size,
                        l1=l1,
                        l2=l2,
                        dropout=hid_drop,
                        batchnorm=batchnorm,
                    )
                )
        else:
            shared.append(
                LayerDef(
                    name=layer_name,
                    in_dim=in_dim,
                    units=hid_size,
                    l1=l1,
                    l2=l2,
                    dropout=hid_drop,
                    batchnorm=batchnorm,
                )
            )
            in_dim = hid_size
            branch_in = hid_size

    trunk_out = shared[-1].units if shared else input_size

    def _branch_out(b: str) -> int:
        if branches.get(b):
            return branches[b][-1].units
        return trunk_out

    heads: Dict[str, HeadDef] = {}
    branch_of_head: Dict[str, str] = {}

    if ae_type == "normal":
        mean_act = "linear"
    elif ae_type == "zinb-elempi":
        mean_act = "none"  # raw logits; MeanAct applied to the negated logits
    else:
        mean_act = "mean"
    heads["mean"] = HeadDef(
        name="mean" if ae_type != "zinb-elempi" else "mean_no_act",
        in_dim=_branch_out("mean"),
        units=output_size,
        l1=l1_coef,
        l2=l2_coef,
        kind="dense",
        activation=mean_act,
    )
    branch_of_head["mean"] = "mean" if fork else ""

    if disp_kind == "constant":
        heads["dispersion"] = HeadDef(
            name="dispersion", in_dim=0, units=output_size, l1=0.0, l2=0.0,
            kind="constant", activation="none",
        )
        branch_of_head["dispersion"] = ""
    elif disp_kind == "conddisp":
        heads["dispersion"] = HeadDef(
            name="dispersion", in_dim=_branch_out("disp"), units=output_size,
            l1=l1_coef, l2=l2_coef, kind="dense", activation="disp",
        )
        branch_of_head["dispersion"] = "disp" if fork else ""
    elif disp_kind == "shared":
        heads["dispersion"] = HeadDef(
            name="dispersion", in_dim=trunk_out, units=1, l1=l1_coef,
            l2=l2_coef, kind="dense", activation="disp",
        )
        branch_of_head["dispersion"] = ""

    if has_pi:
        if ae_type == "zinb-elempi":
            heads["pi"] = HeadDef(
                name="pi", in_dim=output_size, units=1 if sharedpi else output_size,
                l1=l1_coef, l2=l2_coef, kind="elementwise", activation="sigmoid",
            )
            branch_of_head["pi"] = ""
        elif ae_type == "zinb-shared":
            heads["pi"] = HeadDef(
                name="pi", in_dim=trunk_out, units=1, l1=l1_coef, l2=l2_coef,
                kind="dense", activation="sigmoid",
            )
            branch_of_head["pi"] = ""
        else:
            heads["pi"] = HeadDef(
                name="pi", in_dim=_branch_out("pi"), units=output_size,
                l1=l1_coef, l2=l2_coef, kind="dense", activation="sigmoid",
            )
            branch_of_head["pi"] = "pi" if fork else ""

    return NetworkDef(
        ae_type=ae_type,
        input_size=input_size,
        output_size=output_size,
        likelihood=LIKELIHOODS[ae_type],
        activation=activation,
        init=init,
        input_dropout=float(input_dropout),
        shared=tuple(shared),
        branches={b: tuple(v) for b, v in branches.items()},
        heads=heads,
        branch_of_head=branch_of_head,
        elempi_shared=sharedpi,
        ridge=ridge,
        debug=debug,
    )


# ---------------------------------------------------------------------------
# parameters and state
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """One Dense layer's parameters, and its batch-norm parameter and state
    when it has one.  ``kernel`` is (in, out), the JAX layout, or (units,)
    for the elementwise pi head."""

    def __init__(self, kernel: torch.Tensor, batchnorm: bool):
        super().__init__()
        units = kernel.shape[-1]
        zeros = torch.zeros(units, device=kernel.device, dtype=torch.float32)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(zeros.clone())
        self.batchnorm = batchnorm
        if batchnorm:
            self.bn_beta = nn.Parameter(zeros.clone())
            self.register_buffer("moving_mean", zeros.clone())
            self.register_buffer("moving_var", torch.ones_like(zeros))


class ConstantDispersion(nn.Module):
    """The constant dispersion head: one free theta per gene, (1, G),
    initialised to zeros (Keras ConstantDispersionLayer)."""

    def __init__(self, units: int, device):
        super().__init__()
        self.theta = nn.Parameter(torch.zeros((1, units), device=device, dtype=torch.float32))


def _check_supported(definition: NetworkDef):
    if definition.activation == "PReLU":
        raise NotImplementedError(
            "the PReLU activation (a trainable alpha per unit) is not ported "
            "yet (see ROADMAP.md, Queue 1)")


def _stack(layers, init_fn, generator, device):
    return nn.ModuleDict({
        layer.name: Dense(init_fn(generator, (layer.in_dim, layer.units), device),
                          layer.batchnorm)
        for layer in layers
    })


def _head(head: HeadDef, init_fn, generator, device):
    if head.kind == "constant":
        return ConstantDispersion(head.units, device)
    shape = (head.units,) if head.kind == "elementwise" else (head.in_dim, head.units)
    return Dense(init_fn(generator, shape, device), batchnorm=False)


class DCANetwork(nn.Module):
    """Parameters (``trunk``, ``branches``, ``heads``) and batch-norm state
    of a network, initialised from ``generator`` in the JAX package's layer
    order."""

    def __init__(self, definition: NetworkDef, generator: torch.Generator,
                 device="cpu"):
        super().__init__()
        _check_supported(definition)
        init_fn = get_initializer(definition.init)
        self.trunk = _stack(definition.shared, init_fn, generator, device)
        self.branches = nn.ModuleDict({
            bname: _stack(layers, init_fn, generator, device)
            for bname, layers in definition.branches.items()
        })
        self.heads = nn.ModuleDict({
            hname: _head(head, init_fn, generator, device)
            for hname, head in definition.heads.items()
        })

    def bn_state(self):
        """{'trunk': {layer: {'moving_mean', 'moving_var'}}, 'branches':
        {branch: {layer: ...}}} of the BN layers."""
        def of(stack):
            return {name: {"moving_mean": d.moving_mean, "moving_var": d.moving_var}
                    for name, d in stack.items() if d.batchnorm}
        return {"trunk": of(self.trunk),
                "branches": {b: of(stack) for b, stack in self.branches.items()}}

    @torch.no_grad()
    def load_bn_state(self, state):
        stacks = [(self.trunk, state["trunk"])] + [
            (self.branches[b], s) for b, s in state.get("branches", {}).items()]
        for stack, layers in stacks:
            for name, s in layers.items():
                d = stack[name]
                d.moving_mean.copy_(s["moving_mean"])
                d.moving_var.copy_(s["moving_var"])


# ---------------------------------------------------------------------------
# forward pass
# ---------------------------------------------------------------------------


def _batchnorm(d: Dense, x, training: bool):
    """Keras BatchNormalization(center=True, scale=False)."""
    if training:
        mu = torch.mean(x, dim=0)
        var = torch.mean(torch.square(x - mu), dim=0)  # biased, as Keras
        xn = (x - mu) * torch.rsqrt(var + BN_EPS) + d.bn_beta
        mu, var = mu.detach(), var.detach()
        new_s = {
            "moving_mean": d.moving_mean * BN_MOMENTUM + mu * (1.0 - BN_MOMENTUM),
            "moving_var": d.moving_var * BN_MOMENTUM + var * (1.0 - BN_MOMENTUM),
        }
        return xn, new_s
    xn = (x - d.moving_mean) * torch.rsqrt(d.moving_var + BN_EPS) + d.bn_beta
    return xn, {"moving_mean": d.moving_mean, "moving_var": d.moving_var}


def _dropout(x, rate: float, generator):
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


_HEAD_ACTS = {"mean": MeanAct, "disp": DispAct, "sigmoid": torch.sigmoid}


def _apply_head(head: HeadDef, d: Dense, x):
    if head.kind == "elementwise":
        z = x * d.kernel + d.bias
    else:
        z = x @ d.kernel + d.bias
    act = _HEAD_ACTS.get(head.activation)
    return z if act is None else act(z)


def theta_exp(net: DCANetwork):
    """The constant dispersion head's theta as the model exposes it:
    clip(exp(theta), 1e-3, 1e4), (1, G)."""
    return torch.clamp(torch.exp(net.heads["dispersion"].theta), *THETA_EXP_CLIP)


def _apply_stack(layers, stack, x, act_fn, training, generator, new_state):
    """Dense -> BN -> activation -> dropout per layer; returns (x, latent)
    and puts each BN layer's new state into ``new_state``."""
    latent = None
    for layer in layers:
        d = stack[layer.name]
        x = x @ d.kernel + d.bias
        if layer.name == "center":
            latent = x  # encoder output = center Dense before BN/activation
        if layer.batchnorm:
            x, new_state[layer.name] = _batchnorm(d, x, training)
        x = act_fn(x)
        if layer.dropout > 0.0 and training:
            x = _dropout(x, layer.dropout, generator)
    return x, latent


def apply(definition: NetworkDef, net: DCANetwork, count, size_factors, *,
          training: bool = False, generator: Optional[torch.Generator] = None):
    """Full forward pass.  Returns (outputs dict, new batch-norm state);
    the state is the current one in eval mode, and the caller commits a
    training step's state with ``net.load_bn_state``."""
    x = count.to(torch.float32)
    sf = size_factors.to(torch.float32).reshape(-1, 1)

    if definition.input_dropout > 0.0 and training:
        x = _dropout(x, definition.input_dropout, generator)

    act_fn = get_activation(definition.activation)
    new_state = {"trunk": {}, "branches": {}}
    x, latent = _apply_stack(definition.shared, net.trunk, x, act_fn, training,
                             generator, new_state["trunk"])

    # branch outputs of the fork architectures; '' is the shared trunk
    branch_out = {"": x}
    for bname, layers in definition.branches.items():
        new_state["branches"][bname] = {}
        branch_out[bname], _ = _apply_stack(layers, net.branches[bname], x, act_fn,
                                            training, generator,
                                            new_state["branches"][bname])

    heads = definition.heads
    of = definition.branch_of_head
    out: Dict[str, Optional[torch.Tensor]] = {}
    if definition.ae_type == "zinb-elempi":
        # pi from the negated mean logits z: mean = MeanAct(z), pi =
        # sigmoid(z * kernel + bias)
        d = net.heads["mean"]
        z = -(branch_out[of["mean"]] @ d.kernel + d.bias)
        out["mean"] = MeanAct(z)
        out["pi"] = _apply_head(heads["pi"], net.heads["pi"], z)
    else:
        out["mean"] = _apply_head(heads["mean"], net.heads["mean"], branch_out[of["mean"]])
        out["pi"] = (_apply_head(heads["pi"], net.heads["pi"], branch_out[of["pi"]])
                     if "pi" in heads else None)

    if "dispersion" not in heads:
        out["disp"] = None
    elif heads["dispersion"].kind == "constant":
        out["disp"] = theta_exp(net)
    else:
        out["disp"] = _apply_head(heads["dispersion"], net.heads["dispersion"],
                                  branch_out[of["dispersion"]])

    out["output"] = out["mean"] * sf
    out["mean_norm"] = out["mean"]
    out["latent"] = latent
    out["decoded"] = x if not definition.branches else None
    return out, new_state


def regularization_loss(definition: NetworkDef, net: DCANetwork) -> torch.Tensor:
    """Sum of the Keras l1_l2 kernel penalties added to the loss."""
    total = torch.zeros((), dtype=torch.float32,
                        device=next(net.parameters()).device)

    def add(kernel, l1, l2):
        nonlocal total
        if l1:
            total = total + l1 * torch.sum(torch.abs(kernel))
        if l2:
            total = total + l2 * torch.sum(torch.square(kernel))

    for layer in definition.shared:
        add(net.trunk[layer.name].kernel, layer.l1, layer.l2)
    for bname, layers in definition.branches.items():
        for layer in layers:
            add(net.branches[bname][layer.name].kernel, layer.l1, layer.l2)
    for hname, head in definition.heads.items():
        if head.kind != "constant":  # the constant theta is not regularised
            add(net.heads[hname].kernel, head.l1, head.l2)
    return total
