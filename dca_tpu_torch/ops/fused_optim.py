"""The RMSprop update of a step's parameters in one launch: CUDA kernel K5
(``csrc/fused_optim.cu``).

``rmsprop(params, grads, accs, lr, clipvalue, rho, eps)`` does, in place on
CUDA float32 tensors, what the plain loop ``train/optim.py::_rmsprop_loop``
does leaf by leaf in 11 PyTorch kernels, with the same float32 operations
in the same order, so the same bits.  No TPU kernel corresponds to it: the
JAX package leaves the update to XLA's fusion.  ``plan`` cuts the leaves
into launches of at most ``MAX_LEAVES``, each block covering ``CHUNK``
elements of one leaf, and picks 16-byte loads for the leaves whose three
tensors are 16-byte aligned; the tables are made anew at every call, from
the tensors' addresses then, so nothing is kept between calls.  The
wrapper reads nothing back and allocates nothing but a contiguous copy of
a gradient that is not contiguous, so a CUDA graph can capture it; a
tensor ``lr`` is read by the kernel from its address at every launch.
The trainers call it through ``train/optim.py::rmsprop`` for parameters on
a card; parameters on the CPU take the plain loop.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import counters

# csrc/fused_optim.cu's kMaxLeaves and kChunk
MAX_LEAVES = 64
CHUNK = 2048
ALIGN = 16  # bytes of a float4 load

# the kernel's launches (``counters.record``): one a step for up to
# MAX_LEAVES leaves, credited at each replay of a graph that captured it
launches = {"rmsprop": 0}


def reset_launches():
    counters.reset(launches)


class Launch(NamedTuple):
    leaves: tuple  # indices into the leaf list
    first_block: tuple  # each leaf's first block, then the launch's blocks
    vector: tuple  # per leaf: 16-byte loads


def plan(sizes, aligned):
    """The launches that update leaves of ``sizes`` elements, where
    ``aligned[i]`` says that leaf i's parameter, gradient and accumulator
    all start on a 16-byte boundary: leaves in order, at most MAX_LEAVES a
    launch, ceil(size / CHUNK) blocks each; empty leaves take no block."""
    out = []
    leaves = [i for i, n in enumerate(sizes) if n > 0]
    for lo in range(0, len(leaves), MAX_LEAVES):
        part = leaves[lo:lo + MAX_LEAVES]
        first = [0]
        for i in part:
            first.append(first[-1] + -(-sizes[i] // CHUNK))
        out.append(Launch(tuple(part), tuple(first), tuple(bool(aligned[i]) for i in part)))
    return out


def _raise_on(lib, err, what):
    if err != 0:
        from ._build import KernelError

        raise KernelError(f"{what} launch failed: CUDA error {err} "
                          f"({lib.dca_cuda_error_string(err).decode()})")


def _check(params, grads, accs, lr):
    device = params[0].device
    if not params[0].is_cuda:
        raise ValueError("the K5 wrapper needs CUDA tensors")
    if not len(params) == len(grads) == len(accs):
        raise ValueError(f"the K5 wrapper: {len(params)} parameters, {len(grads)} gradients "
                         f"and {len(accs)} accumulators")
    for i, (p, g, a) in enumerate(zip(params, grads, accs)):
        for what, t in (("parameter", p), ("gradient", g), ("accumulator", a)):
            if t.device != device or t.dtype != torch.float32 or t.shape != p.shape:
                raise ValueError(f"the K5 wrapper: leaf {i}'s {what} is {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}, not float32 "
                                 f"{tuple(p.shape)} on {device}")
        if not (p.is_contiguous() and a.is_contiguous()):
            raise ValueError(f"the K5 wrapper: leaf {i}'s parameter and accumulator must be "
                             "contiguous")
    if torch.is_tensor(lr) and (lr.device != device or lr.dtype != torch.float32
                                or lr.numel() != 1):
        raise ValueError(f"the K5 wrapper: lr must be one float32 on {device}, not "
                         f"{lr.dtype} {tuple(lr.shape)} on {lr.device}")


def rmsprop(params, grads, accs, lr, clipvalue=None, rho=0.9, eps=1e-7):
    """Update ``params`` and their accumulators ``accs`` in place from
    ``grads``: Keras's RMSprop with elementwise clipping at ``clipvalue``
    (None: none), ``lr`` a 0-d float32 tensor on the card or a float.
    Launches K5 once for every MAX_LEAVES leaves, or raises."""
    from ._build import library

    if not params:
        return
    _check(params, grads, accs, lr)
    grads = [g.contiguous() for g in grads]
    device = params[0].device
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    aligned = [all(t.data_ptr() % ALIGN == 0 for t in leaf)
               for leaf in zip(params, grads, accs)]
    lr_ptr, lr_value = (lr.data_ptr(), 0.0) if torch.is_tensor(lr) else (None, float(lr))
    clipped = clipvalue is not None
    with torch.cuda.device(device):
        for launch in plan([p.numel() for p in params], aligned):
            k = len(launch.leaves)
            ptrs = [(ctypes.c_void_p * k)(*(ts[i].data_ptr() for i in launch.leaves))
                    for ts in (params, grads, accs)]
            err = lib.dca_rmsprop(
                k, *ptrs, (ctypes.c_longlong * k)(*(params[i].numel() for i in launch.leaves)),
                (ctypes.c_int * (k + 1))(*launch.first_block),
                (ctypes.c_int * k)(*launch.vector), CHUNK, lr_ptr, lr_value,
                float(clipvalue) if clipped else 0.0, clipped, rho, 1.0 - rho, eps, stream)
            _raise_on(lib, err, "rmsprop (K5)")
            counters.record(launches, ["rmsprop"], stream)
