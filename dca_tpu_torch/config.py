"""Runtime switches the port reads, under the JAX package's names and with
its defaults (a copy of the three of ``dca_tpu/config.py`` that the denoise
tier and the streaming trainer need).

DCA_TPU_FUSED_DENSE: '1' sends the eval-mode Dense -> BatchNorm ->
activation blocks and the output heads' epilogues through the fused dense
kernel K4 (``ops/fused_dense.py``); '0' and 'auto' (the default) keep the
plain PyTorch layers at every width.  The JAX package measured no gain on
its TPU; the H100 times of K4 are in PERF.md, and the default waits for
them to decide.

DCA_TPU_MATMUL: 'bf16' (or '1') rounds the inputs of the trunk and head
matrix products to bfloat16 and accumulates in float32, in training and
in eval; 'auto' (the default), 'f32' and '0' keep float32 products.
Anything else raises.

DCA_TPU_DEVICE_DENSIFY: '1' ships sparse (CSR) inputs to the device as
compact payloads and scatters them dense there (``ops/densify.py``), in the
streaming trainer and in the block forward; '0' densifies them on the
host.  'auto' (the default) turns it on where the JAX package does, on its
accelerator: here, on a CUDA device, and off on the CPU.

The port always uses its loss kernels on a CUDA device, so the JAX
package's DCA_TPU_FUSED_LOSS has no counterpart here.
"""

from __future__ import annotations

import os

import torch


def use_fused_dense(n_out=None) -> bool:
    """'1' forces the fused dense kernel in eval-mode forwards; '0' and
    'auto' keep the plain layers at every width (``n_out`` is accepted for
    the JAX package's signature and not read)."""
    return os.environ.get("DCA_TPU_FUSED_DENSE", "auto") == "1"


def matmul_dtype():
    """The dtype the matrix products' inputs are rounded to: torch.bfloat16,
    or None for float32.  The products accumulate in float32 either way."""
    mode = os.environ.get("DCA_TPU_MATMUL", "auto")
    if mode in ("auto", "f32", "0"):
        return None
    if mode in ("bf16", "1"):
        return torch.bfloat16
    raise ValueError(
        f"DCA_TPU_MATMUL={mode!r}: expected 'auto', 'bf16'/'1', or 'f32'/'0'"
    )


def use_device_densify(device) -> bool:
    """'1' forces the device densify, '0' the host one; 'auto' (the
    default) chooses it on a CUDA ``device`` (a ``torch.device`` or its
    name) and not on the CPU."""
    mode = os.environ.get("DCA_TPU_DEVICE_DENSIFY", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return torch.device(device).type == "cuda"
