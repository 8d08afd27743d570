"""Where the entry points run: the CUDA device unless the caller asks for
the CPU.  There is no silent fallback: with no CUDA device and no explicit
``"cpu"``, ``resolve_device`` raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device for ``dca()``, ``train_with_args`` and the CLI.

    ``None`` means the current CUDA device.  Float32 matrix products stay
    in full float32, as in the JAX package (its ``config.matmul_dtype()``
    default): TF32 is switched off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dca_tpu_torch runs on a CUDA device unless asked otherwise, "
                "and none is available; pass device='cpu' (CLI: --device cpu) "
                "to run on the CPU"
            )
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: expected 'cuda' or 'cpu'")
    return device
