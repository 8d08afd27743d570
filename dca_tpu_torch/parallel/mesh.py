"""The ranks of a data-parallel fit, from the user's ``devices`` argument.

A port of ``resolve_mesh`` of the JAX package's ``dca_tpu/parallel/mesh.py``
with its spellings.  The JAX package lays a ('data', 'model') mesh over the
devices of one program; the port runs one process per device, so its mesh
is the process group that ``multihost.initialize`` joined: a data axis
only, each rank computing on its network's device.  Gene-dim model
parallelism (``model_parallel > 1``) and one process over several GPUs are
not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import torch.distributed as dist


def resolve_mesh(devices, model_parallel: int = 1):
    """The process group of ``devices``, or None for the single-device
    path.

    None/False/0 mean no mesh; ``"all"``/True the ranks of the initialized
    process group; an int N, or a list of N, exactly those ranks, N of
    them.  A world of one rank is the single-device path.  Raises, naming
    ROADMAP.md, on ``model_parallel > 1`` and on more than one device with
    no process group."""
    if model_parallel is not None and int(model_parallel) > 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: gene-dim model parallelism is not ported to "
            "dca_tpu_torch yet (see ROADMAP.md)")
    if devices is None or devices is False or (
        isinstance(devices, int) and not isinstance(devices, bool) and devices == 0
    ):
        return None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is True or devices == "all":
        n = world
    elif isinstance(devices, int):
        n = devices
    else:
        n = len(list(devices))
    if n < 1:
        raise ValueError(f"resolve_mesh: no devices in {devices!r}")
    if not dist.is_initialized() and n > 1:
        raise NotImplementedError(
            f"devices={devices!r}: {n} devices in one process is not ported to dca_tpu_torch "
            "yet (see ROADMAP.md); run one process per device, e.g. torchrun "
            f"--nproc-per-node {n} -m dca_tpu_torch ... --devices all")
    if n != world:
        raise ValueError(f"devices={devices!r} asks for {n} devices, but the process group "
                         f"has {world} ranks, one per device")
    return None if world == 1 else dist.group.WORLD
