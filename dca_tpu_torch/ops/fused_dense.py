"""Fused dense block, CUDA kernel K4: Dense -> inference BatchNorm (center
only) -> activation [-> size-factor multiply] in one pass,

    out = act((x @ W + b) * s + t) [* sf],
    s = rsqrt(moving_var + 1e-3),  t = beta - moving_mean * s

the eval-mode trunk layer and the output heads' epilogues (MeanAct, DispAct,
sigmoid and the size-factor multiply) of the JAX package's
``dca_tpu/ops/fused_dense.py``, with the same signature less its TPU tile
arguments and ``interpret``.  The model uses it when DCA_TPU_FUSED_DENSE=1
(``config.use_fused_dense``), for eval-mode forwards only.

For a tensor on the CPU ``fused_dense_block`` runs the plain version,
``fused_dense_reference``, which folds BN the same way (s and t first) and
applies the kernel's epilogue formulas; that is what the CPU tests hold
against the JAX package.  For a CUDA tensor it launches the kernel
(``csrc/fused_dense.cu``) or raises.  Under DCA_TPU_MATMUL=bf16 both round x
and W to bfloat16 and accumulate in float32, as the JAX kernel does.
"""

from __future__ import annotations

import torch

from ..config import matmul_dtype
from .activations import MeanAct

BN_EPS = 1e-3  # Keras BatchNormalization default (models/core.py BN_EPS)

# the kernel's activations, numbered as csrc/fused_dense.cu numbers them
_ACT_CODES = {"mean": 0, "disp": 1, "sigmoid": 2, "relu": 3, "selu": 4,
              "elu": 5, "tanh": 6, "linear": 7}

# jax.nn.selu's constants
SELU_SCALE = 1.0507009873554805
SELU_ALPHA = 1.6732632423543772

# Launches of the kernel, counted by its wrapper where it launches.
launches = {"fused_dense": 0}


def reset_launches():
    launches["fused_dense"] = 0


def supported_activation(name) -> bool:
    return name in _ACT_CODES


def _softplus(z):
    """softplus as the kernel and jax.nn.softplus compute it:
    max(z, 0) + log1p(exp(-|z|)), with no overflow for large z."""
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-z.abs()))


# the plain versions of the kernel's epilogues, with its formulas
EPILOGUES = {
    "mean": MeanAct,
    "disp": lambda z: torch.clamp(_softplus(z), 1e-4, 1e4),
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "selu": lambda z: SELU_SCALE * torch.where(z > 0, z, SELU_ALPHA * torch.expm1(z)),
    "elu": lambda z: torch.where(z > 0, z, torch.expm1(z)),
    "tanh": torch.tanh,
    "linear": lambda z: z,
}


def fold_bn(bn):
    """(s, t) of the inference BatchNorm (moving_mean, moving_var, beta):
    z * s + t == (z - moving_mean) * rsqrt(moving_var + eps) + beta."""
    mm, mv, beta = bn
    s = torch.rsqrt(mv + BN_EPS)
    return s, beta - mm * s


def _check(x, kernel, bias, bn, activation, size_factors):
    if activation not in _ACT_CODES:
        raise ValueError(f"activation {activation!r} not fusable; "
                         f"available: {sorted(_ACT_CODES)}")
    if x.dim() != 2 or kernel.dim() != 2 or x.shape[1] != kernel.shape[0]:
        raise ValueError(f"fused dense: x {tuple(x.shape)} and kernel "
                         f"{tuple(kernel.shape)} do not chain")
    B, N = x.shape[0], kernel.shape[1]
    named = [("x", x, None), ("kernel", kernel, None), ("bias", bias, (N,))]
    if bn is not None:
        named += [(n, a, (N,)) for n, a in zip(("moving_mean", "moving_var", "beta"), bn)]
    if size_factors is not None:
        named.append(("size_factors", size_factors, (B,)))
    for name, t, shape in named:
        if t.dtype != torch.float32:
            raise TypeError(f"fused dense: {name} must be float32, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"fused dense: {name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused dense: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError("fused dense: every operand must be on x's device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused dense: unsupported device {x.device}")


def fused_dense_reference(x, kernel, bias, *, bn=None, activation="linear",
                          size_factors=None):
    """Plain version of K4 and its wrapper: the same folded BN, the same
    epilogue formulas, and under DCA_TPU_MATMUL=bf16 the product of the
    bfloat16-rounded operands accumulated in float32 (a product of two
    bfloat16 values is exact in float32)."""
    if matmul_dtype() is not None:
        x = x.to(torch.bfloat16).to(torch.float32)
        kernel = kernel.to(torch.bfloat16).to(torch.float32)
    z = x @ kernel + bias
    if bn is not None:
        s, t = fold_bn(bn)
        z = z * s + t
    z = EPILOGUES[activation](z)
    if size_factors is not None:
        z = z * size_factors.reshape(-1, 1)
    return z


def _kernel(x, kernel, bias, bn, activation, size_factors):
    """Launch K4 on CUDA tensors; see ``fused_dense_block``."""
    from ._build import library

    lib = library()
    B, N = x.shape[0], kernel.shape[1]
    out = torch.empty((B, N), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    s = t = None
    if bn is not None:
        s, t = fold_bn(bn)
    with torch.cuda.device(x.device):
        err = lib.dca_fused_dense(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            None if s is None else s.data_ptr(), None if t is None else t.data_ptr(),
            None if size_factors is None else size_factors.data_ptr(), out.data_ptr(),
            B, x.shape[1], N, _ACT_CODES[activation], bn is not None,
            size_factors is not None, matmul_dtype() is not None,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.dca_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_dense (K4) launch failed: CUDA error {err} ({msg})")
    launches["fused_dense"] += 1
    return out


def fused_dense_block(x, kernel, bias, *, bn=None, activation="linear",
                      size_factors=None):
    """act(BN(x @ kernel + bias)) [* size_factors] in one fused pass.

    x: (B, K) float32; kernel: (K, N); bias: (N,); bn: None or
    (moving_mean, moving_var, beta), each (N,): inference statistics,
    folded into a per-column affine; activation: one of ``mean``, ``disp``,
    ``sigmoid``, ``relu``, ``selu``, ``elu``, ``tanh``, ``linear``;
    size_factors: None or (B,), the column-wise multiplier.  Every operand
    float32, contiguous and on x's device.

    On CUDA tensors this launches K4, the port of the Pallas kernel
    ``dca_tpu/ops/fused_dense.py::_kernel`` (driven by its
    ``fused_dense_block``).  Bound on the H100 by operations at the main
    path's shapes: 2 B K N flops at 67 TFLOP/s float32 (TF32 is off), 18 us
    for a 64 -> 3451 head or the 3451 -> 64 encoder layer over 2730 rows,
    against about 12 us for their bytes.  Design (``csrc/fused_dense.cu``):
    a shared-memory tiled float32 product with register accumulators, BM x
    64 output tiles (BM 16 for thin outputs so that the blocks fill the 132
    SMs, 64 otherwise), the K loop inside the block, the epilogue on the
    registers, the ragged edges masked by index."""
    _check(x, kernel, bias, bn, activation, size_factors)
    if x.is_cuda:
        return _kernel(x, kernel, bias, bn, activation, size_factors)
    return fused_dense_reference(x, kernel, bias, bn=bn, activation=activation,
                                 size_factors=size_factors)
