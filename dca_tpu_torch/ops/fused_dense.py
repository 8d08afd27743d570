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

from typing import NamedTuple

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

# Launches of the kernel, counted by its wrapper where it launches: all of
# them, and those of each tiling of the plan.
launches = {"fused_dense": 0, "wide": 0, "splitk": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def supported_activation(name) -> bool:
    return name in _ACT_CODES


# ---------------------------------------------------------------------------
# the launch plan: which of the kernel's two tilings, with which split
# ---------------------------------------------------------------------------

SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper, bytes
MAX_CLUSTER = 8  # the portable thread-block cluster size
# csrc/fused_dense.cu's tilings, both with 128 x 64 output tiles, x staged
# as [k][row] (132 floats a row) and w as [k][column], the finished tile as
# [row][column] (66 floats a row): whole K in shared memory for K <= 64
# (256 threads); split-K with 32-deep steps in two buffers and two partial
# tiles a block (512 threads, one block an SM)
WIDE, SPLITK = 0, 1
WIDE_MAX_K = 64
WIDE_TILE = (128, 64)
SPLITK_TILE = (128, 64, 32)


class Plan(NamedTuple):
    """How K4 tiles (M, K) @ (K, N): ``kind`` WIDE or SPLITK; ``bm`` x
    ``bn`` output tiles; ``bk`` the K depth staged at once (all of K for
    WIDE, one step for SPLITK); ``splits`` K slices a tile; ``cluster`` the
    blocks of a thread-block cluster (the splits of one tile)."""
    kind: int
    bm: int
    bn: int
    bk: int
    splits: int
    cluster: int


def _cdiv(a, b):
    return -(-a // b)


def plan(M, K, N, sms=SMS, clusters=None) -> Plan:
    """K4's launch plan for (M, K) @ (K, N), from the shape and the device
    alone: the sum order, and so every output bit, is the same whatever the
    epilogue.

    K <= 64 (the heads, the decoder): the whole-K tiling.  Longer K (the
    encoder): split-K over S slices (at most 8, one per 32-deep step), each
    tile's S blocks one cluster.  ``clusters[S - 1]`` is how many clusters
    of S blocks the device holds at once (``max_clusters``; a cluster must
    sit in one GPC, so it is not ``sms // S``); by default ``sms // S``.
    The plan takes the S that gives the least work to the busiest SM,
    ceil(tiles / clusters[S - 1]) / S waves of 1 / S of the work, the
    smaller S on a tie.  For the encoder (2730, 3451) -> 64 on an H100,
    22 tiles: S = 5, 110 blocks in one wave; S = 6 would need 22 clusters
    of 6 where the card holds 20, and two of them would run in a second
    wave."""
    if K <= WIDE_MAX_K:
        return Plan(WIDE, *WIDE_TILE, K, 1, 1)
    bm, bn, bk = SPLITK_TILE
    tiles = _cdiv(M, bm) * _cdiv(N, bn)
    resident = clusters or [sms // s for s in range(1, MAX_CLUSTER + 1)]
    best = min(range(1, min(MAX_CLUSTER, _cdiv(K, bk)) + 1),
               key=lambda s: (_cdiv(tiles, max(1, resident[s - 1])) / s, s))
    return Plan(SPLITK, bm, bn, bk, best, best)


_resident = {}


def max_clusters(device):
    """Co-resident clusters of 1 .. 8 split-K blocks on a CUDA ``device``
    (cudaOccupancyMaxActiveClusters through the kernel library), asked once
    a device."""
    import ctypes

    from ._build import library

    table = _resident.get(device)
    if table is None:
        lib = library()
        table = []
        with torch.cuda.device(device):
            for s in range(1, MAX_CLUSTER + 1):
                n = ctypes.c_int(0)
                err = lib.dca_fused_dense_max_clusters(s, ctypes.byref(n))
                if err != 0:
                    msg = lib.dca_cuda_error_string(err).decode()
                    raise RuntimeError(f"fused_dense (K4): cluster occupancy query failed: "
                                       f"CUDA error {err} ({msg})")
                table.append(n.value)
        _resident[device] = table
    return table


def device_plan(M, K, N, device) -> Plan:
    """``plan`` with a CUDA ``device``'s SM count and cluster occupancy."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(M, K, N, sms, max_clusters(device))


def plan_blocks(p: Plan, M, K, N):
    """The plan's blocks as (rows, columns, k) ranges, each a ``range``,
    as csrc/fused_dense.cu assigns them: split q of a tile takes the
    32-deep steps [q T / S, (q + 1) T / S) of T."""
    blocks = []
    steps = _cdiv(K, p.bk) if p.kind == SPLITK else 1
    for m0 in range(0, M, p.bm):
        for n0 in range(0, N, p.bn):
            for q in range(p.splits):
                k0 = q * steps // p.splits * p.bk
                k1 = (q + 1) * steps // p.splits * p.bk if p.kind == SPLITK else K
                blocks.append((range(m0, min(m0 + p.bm, M)), range(n0, min(n0 + p.bn, N)),
                               range(k0, min(k1, K))))
    return blocks


def smem_bytes(p: Plan):
    """Dynamic shared memory of one block of the plan, in bytes."""
    staged = p.bm + 4 + p.bn  # floats a k of x and w
    if p.kind == WIDE:  # x and w, or the finished tile, whichever is larger
        return 4 * max(WIDE_MAX_K * staged, p.bm * (p.bn + 2))
    return 4 * max(2 * p.bk * staged, 2 * p.bm * (p.bn + 2))


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


def _kernel(x, kernel, bias, bn, activation, size_factors, launch_plan=None):
    """Launch K4 on CUDA tensors; see ``fused_dense_block``.  ``launch_plan``
    (default ``plan`` for this shape and device) lets a measurement try
    another split."""
    from ._build import library

    lib = library()
    (B, K), N = x.shape, kernel.shape[1]
    out = torch.empty((B, N), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    p = device_plan(B, K, N, x.device) if launch_plan is None else launch_plan
    s = t = None
    if bn is not None:
        s, t = fold_bn(bn)
    with torch.cuda.device(x.device):
        err = lib.dca_fused_dense(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            None if s is None else s.data_ptr(), None if t is None else t.data_ptr(),
            None if size_factors is None else size_factors.data_ptr(), out.data_ptr(),
            B, K, N, _ACT_CODES[activation], bn is not None,
            size_factors is not None, matmul_dtype() is not None, *p,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.dca_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_dense (K4) launch failed: CUDA error {err} ({msg})")
    launches["fused_dense"] += 1
    launches["wide" if p.kind == WIDE else "splitk"] += 1
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
    against 11-12 us for their bytes.  Design (``csrc/fused_dense.cu``),
    two tilings chosen by ``plan`` from the shape alone: for K <= 64 (the
    heads, the decoder) x and W staged whole in shared memory, 128 x 128
    tiles with 8 x 8 register accumulators a thread; for longer K (the
    encoder's 43 row tiles would leave two thirds of the 132 SMs idle)
    split-K, the K range of each 64 x 64 tile cut into slices whose blocks
    form a thread-block cluster, each streaming its slice through a 4-stage
    cp.async ring into 8 x 4 accumulators a thread, the partial tiles
    summed through distributed shared memory in fixed rank order.  The
    epilogue runs on the finished sums, the ragged edges are masked by
    index, and the result is the same bits on every run.  TMA is not used:
    the 3451-float rows of x and the heads' W are not 16-byte strided."""
    _check(x, kernel, bias, bn, activation, size_factors)
    if x.is_cuda:
        return _kernel(x, kernel, bias, bn, activation, size_factors)
    return fused_dense_reference(x, kernel, bias, bn=bn, activation=activation,
                                 size_factors=size_factors)
