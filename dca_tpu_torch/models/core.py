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

In eval mode with DCA_TPU_FUSED_DENSE=1 the trunk layers before ``center``,
the fork branches' layers and the dense heads go through the fused dense
kernel K4 (``ops/fused_dense.py``), as the JAX package routes them through
its Pallas kernel; ``center`` stays plain so that ``latent`` is its pre-BN
output, and so do the hidden layers under PReLU, whose trainable alpha K4
has no epilogue for.  Matrix products honour DCA_TPU_MATMUL (``_dot``).
``apply`` with ``keys`` computes only the heads (and fork branches) those
outputs need, what XLA's dead-code elimination gives the JAX package's
per-keys predict.

In a data-parallel training step (``shard``, a ``parallel.step.BatchShard``)
each rank runs its rows of the global batch: BatchNorm normalises with the
mean and biased variance of the whole global batch, summed over the ranks
of the data group as GSPMD's psum gives them in the JAX package, and
dropout draws the global batch's mask from the shared-seed generator and
takes its own rows, so the ranks compute what one device would on the
whole batch.  With gene-dim model parallelism (the shard's mesh has a
model axis) the network holds this rank's gene shards
(``parallel/mesh.py``): the input layer multiplies its gene columns by its
rows of the kernel and sums the product over the model group before the
bias; the input-dropout mask is the global (n, G_in) draw cut to its rows
and columns; the heads give its columns of the outputs.

All 11 architectures of the JAX package run here.  With
``activation="PReLU"`` every hidden layer of the trunk and of the fork
branches carries a trainable alpha per unit, ``prelu_alpha`` (Keras zeros
at init), which the bridge carries across from the JAX pytree under the
same name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import matmul_dtype, use_fused_dense
from ..ops.activations import (PARAMETRIC_ACTIVATIONS, DispAct, MeanAct, get_activation,
                               prelu)
from ..ops.fused_dense import fused_dense_block, supported_activation
from ..ops.initializers import get_initializer
from ..parallel.multihost import all_reduce_sum

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
    """One Dense layer's parameters, its batch-norm parameter and state when
    it has one, and its PReLU alpha (zeros, as Keras initialises it) when
    ``prelu``.  ``kernel`` is (in, out), the JAX layout, or (units,) for
    the elementwise pi head."""

    def __init__(self, kernel: torch.Tensor, batchnorm: bool, prelu: bool = False):
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
        if prelu:
            self.prelu_alpha = nn.Parameter(zeros.clone())


class ConstantDispersion(nn.Module):
    """The constant dispersion head: one free theta per gene, (1, G),
    initialised to zeros (Keras ConstantDispersionLayer)."""

    def __init__(self, units: int, device):
        super().__init__()
        self.theta = nn.Parameter(torch.zeros((1, units), device=device, dtype=torch.float32))


def _stack(layers, init_fn, generator, device, parametric):
    return nn.ModuleDict({
        layer.name: Dense(init_fn(generator, (layer.in_dim, layer.units), device),
                          layer.batchnorm, prelu=parametric)
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
        init_fn = get_initializer(definition.init)
        parametric = definition.activation in PARAMETRIC_ACTIVATIONS
        self.trunk = _stack(definition.shared, init_fn, generator, device, parametric)
        self.branches = nn.ModuleDict({
            bname: _stack(layers, init_fn, generator, device, parametric)
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


def _eval_state(d: Dense):
    return {"moving_mean": d.moving_mean, "moving_var": d.moving_var}


def _batchnorm(d: Dense, x, training: bool, shard=None):
    """Keras BatchNormalization(center=True, scale=False); in training
    under a ``shard``, with the statistics of the whole global batch: the
    sum of x over the ranks first, then the sum of (x - mean)^2.  The sums
    are differentiable, so the moving statistics and the gradients are
    those of the global batch."""
    if training:
        if shard is None:
            mu = torch.mean(x, dim=0)
            var = torch.mean(torch.square(x - mu), dim=0)  # biased, as Keras
        else:
            mu = all_reduce_sum(torch.sum(x, dim=0), shard.group) / shard.n
            var = all_reduce_sum(torch.sum(torch.square(x - mu), dim=0), shard.group) / shard.n
        xn = (x - mu) * torch.rsqrt(var + BN_EPS) + d.bn_beta
        mu, var = mu.detach(), var.detach()
        new_s = {
            "moving_mean": d.moving_mean * BN_MOMENTUM + mu * (1.0 - BN_MOMENTUM),
            "moving_var": d.moving_var * BN_MOMENTUM + var * (1.0 - BN_MOMENTUM),
        }
        return xn, new_s
    xn = (x - d.moving_mean) * torch.rsqrt(d.moving_var + BN_EPS) + d.bn_beta
    return xn, _eval_state(d)


def _dropout(x, rate: float, generator, shard=None, cols=None):
    """Inverted dropout; under a ``shard`` this rank's rows of the global
    batch's mask, and with ``cols`` = (lo, hi, width) its columns [lo, hi)
    of a mask ``width`` wide (the input's gene shard)."""
    keep = 1.0 - rate
    width = x.shape[1] if cols is None else cols[2]
    shape = x.shape if shard is None else (shard.n, width)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if shard is not None:
        mask = mask[shard.lo:shard.hi]
    if cols is not None:
        mask = mask[:, cols[0]:cols[1]]
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _dot(x, w):
    """x @ w in the configured input precision (``config.matmul_dtype``):
    under DCA_TPU_MATMUL=bf16 both operands are rounded to bfloat16 and the
    product accumulates in float32, JAX's bf16 dot with
    ``preferred_element_type=f32``; float32 otherwise."""
    dt = matmul_dtype()
    if dt is not None:
        x = x.to(dt).to(torch.float32)
        w = w.to(dt).to(torch.float32)
    return x @ w


_HEAD_ACTS = {"mean": MeanAct, "disp": DispAct, "sigmoid": torch.sigmoid}
# the fused kernel's epilogue of each dense head activation
_HEAD_EPILOGUES = {"mean": "mean", "disp": "disp", "sigmoid": "sigmoid",
                   "linear": "linear", "none": "linear"}


def _apply_head(head: HeadDef, d: Dense, x, fused: bool = False):
    if head.kind == "elementwise":
        z = x * d.kernel + d.bias
    elif fused and head.activation in _HEAD_EPILOGUES:
        return fused_dense_block(x, d.kernel, d.bias,
                                 activation=_HEAD_EPILOGUES[head.activation])
    else:
        z = _dot(x, d.kernel) + d.bias
    act = _HEAD_ACTS.get(head.activation)
    return z if act is None else act(z)


def theta_exp(net: DCANetwork):
    """The constant dispersion head's theta as the model exposes it:
    clip(exp(theta), 1e-3, 1e4), (1, G)."""
    return torch.clamp(torch.exp(net.heads["dispersion"].theta), *THETA_EXP_CLIP)


def _apply_stack(layers, stack, x, activation, training, generator, new_state,
                 shard=None, in_group=None):
    """Dense -> BN -> activation -> dropout per layer; returns (x, latent)
    and puts each BN layer's new state into ``new_state``.  In eval mode
    with the fused kernel switched on, the layers run through it up to
    ``center``, which stays plain: ``latent`` is its Dense output before
    BN and activation.  PReLU layers never take the kernel, as in the JAX
    package.  ``in_group``: the model group over which the first layer's
    products of this rank's gene shard (x's columns and the kernel's rows)
    are summed before its bias, the row-parallel input layer of gene-dim
    model parallelism."""
    latent = None
    parametric = activation in PARAMETRIC_ACTIVATIONS
    if (not training and not parametric and use_fused_dense()
            and supported_activation(activation) and in_group is None):
        for i, layer in enumerate(layers):
            if layer.name == "center":
                layers = layers[i:]
                break
            d = stack[layer.name]
            bn = (d.moving_mean, d.moving_var, d.bn_beta) if layer.batchnorm else None
            x = fused_dense_block(x, d.kernel, d.bias, bn=bn, activation=activation)
            if layer.batchnorm:
                new_state[layer.name] = _eval_state(d)
        else:
            return x, latent
    act_fn = None if parametric else get_activation(activation)
    for i, layer in enumerate(layers):
        d = stack[layer.name]
        if i == 0 and in_group is not None:
            x = all_reduce_sum(_dot(x, d.kernel), in_group) + d.bias
        else:
            x = _dot(x, d.kernel) + d.bias
        if layer.name == "center":
            latent = x  # encoder output = center Dense before BN/activation
        if layer.batchnorm:
            x, new_state[layer.name] = _batchnorm(d, x, training, shard)
        x = prelu(x, d.prelu_alpha) if parametric else act_fn(x)
        if layer.dropout > 0.0 and training:
            x = _dropout(x, layer.dropout, generator, shard)
    return x, latent


# the heads each output needs
_HEADS_OF_KEY = {"output": ("mean",), "mean": ("mean",), "mean_norm": ("mean",),
                 "disp": ("dispersion",), "pi": ("pi",)}


def _wanted_heads(definition: NetworkDef, keys):
    """The heads to compute for ``keys`` (None: all of them)."""
    if keys is None:
        return set(definition.heads)
    wanted = {h for k in keys for h in _HEADS_OF_KEY.get(k, ())}
    if definition.ae_type == "zinb-elempi" and "pi" in wanted:
        wanted.add("mean")  # pi reads the mean head's logits
    return wanted & set(definition.heads)


def _apply_branches(definition, net, x, activation, training, generator, new_state,
                    heads, shard=None):
    """{branch: output} of the fork branches that feed ``heads``; '' is the
    shared trunk's output ``x``."""
    of = definition.branch_of_head
    branch_out = {"": x}
    for bname, layers in definition.branches.items():
        if not any(of[h] == bname for h in heads):
            continue
        new_state[bname] = {}
        branch_out[bname], _ = _apply_stack(layers, net.branches[bname], x, activation,
                                            training, generator, new_state[bname], shard)
    return branch_out


def _apply_heads(definition, net, branch_out, sf, heads, fused):
    """The outputs of ``heads`` (the rest None), and ``output`` = mean * sf."""
    hdefs = definition.heads
    of = definition.branch_of_head
    out: Dict[str, Optional[torch.Tensor]] = {"mean": None, "pi": None, "disp": None}
    if definition.ae_type == "zinb-elempi":
        if "mean" in heads:
            # pi from the negated mean logits z: mean = MeanAct(z), pi =
            # sigmoid(z * kernel + bias)
            d = net.heads["mean"]
            z = -(_dot(branch_out[of["mean"]], d.kernel) + d.bias)
            out["mean"] = MeanAct(z)
            if "pi" in heads:
                out["pi"] = _apply_head(hdefs["pi"], net.heads["pi"], z)
    else:
        for hname, key in (("mean", "mean"), ("pi", "pi")):
            if hname in heads:
                out[key] = _apply_head(hdefs[hname], net.heads[hname],
                                       branch_out[of[hname]], fused)
    if "dispersion" in heads:
        if hdefs["dispersion"].kind == "constant":
            out["disp"] = theta_exp(net)
        else:
            out["disp"] = _apply_head(hdefs["dispersion"], net.heads["dispersion"],
                                      branch_out[of["dispersion"]], fused)
    out["output"] = None if out["mean"] is None else out["mean"] * sf
    out["mean_norm"] = out["mean"]
    return out


def apply(definition: NetworkDef, net: DCANetwork, count, size_factors, *,
          training: bool = False, generator: Optional[torch.Generator] = None,
          keys=None, shard=None):
    """Full forward pass.  Returns (outputs dict, new batch-norm state);
    the state is the current one in eval mode, and the caller commits a
    training step's state with ``net.load_bn_state``.  With ``keys`` the
    dict holds only those outputs, and only the heads they need run.
    ``shard``: this rank's rows of a distributed batch (a
    ``parallel.step.BatchShard``); with a model axis in its mesh ``count``
    holds this rank's gene columns of the input (``Mesh.gene_block``) and
    the heads give its columns of the outputs."""
    x = count.to(torch.float32)
    sf = size_factors.to(torch.float32).reshape(-1, 1)
    cols = in_group = None
    if shard is not None and shard.mesh.shards(definition.input_size):
        lo, hi = shard.mesh.gene_block(definition.input_size)
        cols = (lo, hi, definition.input_size)
        in_group = shard.mesh.model

    if definition.input_dropout > 0.0 and training:
        x = _dropout(x, definition.input_dropout, generator, shard, cols)

    activation = definition.activation
    new_state = {"trunk": {}, "branches": {}}
    x, latent = _apply_stack(definition.shared, net.trunk, x, activation, training,
                             generator, new_state["trunk"], shard, in_group)
    heads = _wanted_heads(definition, keys)
    branch_out = _apply_branches(definition, net, x, activation, training, generator,
                                 new_state["branches"], heads, shard)
    out = _apply_heads(definition, net, branch_out, sf, heads,
                       fused=not training and use_fused_dense(definition.output_size))
    out["latent"] = latent
    out["decoded"] = x if not definition.branches else None
    if keys is not None:
        out = {k: out[k] for k in keys}
    return out, new_state


def apply_decoder(definition: NetworkDef, net: DCANetwork, latent_act, size_factors):
    """Decoder-only eval forward, from the center layer's output after
    BN/activation (what the decoder stack consumes in the full forward) to
    the heads: the analogue of the reference's get_decoder.  Returns
    (outputs dict, the last trunk hidden).  With the fused kernel switched
    on, every decoder layer and head goes through it, as in the JAX
    package."""
    x = latent_act.to(torch.float32)
    sf = size_factors.to(torch.float32).reshape(-1, 1)
    center_idx = next(i for i, layer in enumerate(definition.shared)
                      if layer.name == "center")
    x, _ = _apply_stack(definition.shared[center_idx + 1:], net.trunk, x,
                        definition.activation, False, None, {})
    heads = set(definition.heads)
    branch_out = _apply_branches(definition, net, x, definition.activation, False, None,
                                 {}, heads)
    out = _apply_heads(definition, net, branch_out, sf, heads,
                       fused=use_fused_dense(definition.output_size))
    return out, x


def regularization_loss(definition: NetworkDef, net: DCANetwork,
                        keep=None) -> torch.Tensor:
    """Sum of the Keras l1_l2 kernel penalties added to the loss; with
    ``keep`` (a predicate on a kernel's state-dict name, e.g.
    ``"trunk.enc0.kernel"``) only those of the kernels it keeps (gene-dim
    model parallelism penalises its gene shards and its whole kernels on
    different ranks)."""
    total = torch.zeros((), dtype=torch.float32,
                        device=next(net.parameters()).device)

    def add(name, kernel, l1, l2):
        nonlocal total
        if keep is not None and not keep(name):
            return
        if l1:
            total = total + l1 * torch.sum(torch.abs(kernel))
        if l2:
            total = total + l2 * torch.sum(torch.square(kernel))

    for layer in definition.shared:
        add(f"trunk.{layer.name}.kernel", net.trunk[layer.name].kernel, layer.l1, layer.l2)
    for bname, layers in definition.branches.items():
        for layer in layers:
            add(f"branches.{bname}.{layer.name}.kernel", net.branches[bname][layer.name].kernel,
                layer.l1, layer.l2)
    for hname, head in definition.heads.items():
        if head.kind != "constant":  # the constant theta is not regularised
            add(f"heads.{hname}.kernel", net.heads[hname].kernel, head.l1, head.l2)
    return total
