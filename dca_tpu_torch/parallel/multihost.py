"""Process groups and per-rank row blocks over ``torch.distributed``.

A port of the JAX package's ``dca_tpu/parallel/multihost.py``.  The port
trains data parallel as one process per device: ``torchrun
--nproc-per-node N -m dca_tpu_torch in.tsv out/ --devices all`` on one
host, or one process per host with DCA_TPU_COORDINATOR.  ``initialize``
joins the processes into a group; each rank takes its block of each
batch's rows (``process_row_range``); the fit sums what it needs over the
group (``all_reduce_sum``, ``parallel/step.py``); rank 0 alone writes the
output files (``is_primary``).

    from dca_tpu_torch.parallel import multihost
    multihost.initialize()              # from torchrun's RANK/WORLD_SIZE/MASTER_ADDR
    dca_tpu_torch.dca(adata, devices="all")

``gather_to_host`` and ``write_sharded``/``concat_shards`` are there for
outputs computed by row blocks; after a data-parallel fit every rank holds
the same parameters, so ``predict`` gives each rank the full matrix
without them.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None):
    """Join a ``torch.distributed`` process group; return it, or None for
    a run of one process.

    The address is ``coordinator_address`` ("host:port"),
    DCA_TPU_COORDINATOR, or torchrun's MASTER_ADDR/MASTER_PORT; the number
    of processes and this one's rank are ``num_processes``/``process_id``
    or WORLD_SIZE/RANK.  A no-op when a group exists, and when none of
    these is given.

    ``device`` is read as ``resolve_device`` reads it.  On the card each
    rank takes CUDA device LOCAL_RANK % device_count (LOCAL_RANK as
    torchrun sets it, else the rank) and the backend is NCCL; on the CPU
    it is gloo.  NCCL refuses ranks that share a device, so where the
    ranks on this host (LOCAL_WORLD_SIZE, else all of them) outnumber its
    devices this raises, unless the caller asked for ``backend="gloo"``:
    there is no silent switch."""
    if dist.is_initialized():
        return dist.group.WORLD
    env = os.environ
    address = coordinator_address or env.get("DCA_TPU_COORDINATOR")
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if address is None and world is None:
        return None
    if world is None or rank is None:
        raise ValueError("initialize: a process group needs its number of processes and "
                         "this process's rank (num_processes/process_id, or WORLD_SIZE/RANK)")
    world, rank = int(world), int(rank)
    device = resolve_device(device)
    if device.type == "cuda":
        backend = backend or "nccl"
        n_devices = torch.cuda.device_count()
        local = int(env.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local > n_devices:
            raise RuntimeError(
                f"{local} ranks on this host share {n_devices} CUDA device(s), and NCCL "
                "refuses ranks that share a device: run one rank per device, or ask for "
                "backend='gloo' (one process over several GPUs is not ported yet, see "
                "ROADMAP.md)")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)) % n_devices)
    else:
        backend = backend or "gloo"
    # torchrun hosts the rendezvous store itself: env:// joins it
    init = f"tcp://{address}" if address is not None else "env://"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return dist.group.WORLD


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on rank 0, and in a run of one process: the rank that writes."""
    return process_index() == 0


def process_row_range(n_rows: int, rank: Optional[int] = None,
                      world_size: Optional[int] = None) -> tuple[int, int]:
    """[start, stop) of the rows of ``n_rows`` that ``rank`` (default: this
    process) takes: contiguous blocks of ceil(n_rows / world_size), the
    last ones shorter or empty."""
    if rank is None:
        rank, world_size = process_index(), process_count()
    per = -(-n_rows // world_size)
    start = min(rank * per, n_rows)
    stop = min(start + per, n_rows)
    return start, stop


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """``x`` summed over the ranks of ``group``, differentiable: the
    backward sums the cotangents over the ranks too, since every rank's
    loss depends on the sum.  So never all-reduce a loss with it and
    backpropagate that: each rank's gradient would come out summed over
    the ranks once more."""
    return _AllReduceSum.apply(x, group)


def gather_to_host(local_rows, group=None) -> np.ndarray:
    """The rows of every rank, concatenated in rank order, as a numpy array
    on every rank (``local_rows`` a tensor or an array of this rank's
    rows)."""
    arr = (local_rows.detach().cpu().numpy() if torch.is_tensor(local_rows)
           else np.asarray(local_rows))
    if not dist.is_initialized():
        return arr
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, arr, group=group)
    return np.concatenate(parts, axis=0)


def write_sharded(local_rows: np.ndarray, path: str, rownames=None,
                  colnames=None, transpose: bool = False) -> str:
    """Write this rank's row block as ``<path>.part<rank>`` (the %.6f TSV
    format of the global writers), for rank 0 to ``concat_shards`` later.
    Pass ``has_header=colnames is not None`` to ``concat_shards``."""
    from ..data.io import write_text_matrix

    part = f"{path}.part{process_index()}"
    write_text_matrix(np.asarray(local_rows), part, rownames=rownames,
                      colnames=colnames, transpose=transpose)
    return part


def concat_shards(path: str, n_parts: Optional[int] = None,
                  has_header: bool = True) -> str:
    """Concatenate the ``<path>.part*`` row blocks of ``write_sharded``
    (transpose=False) into ``<path>`` and remove them.  ``has_header`` must
    say whether the parts were written with colnames: only then does each
    lead with a header line, which is kept once."""
    n_parts = n_parts if n_parts is not None else process_count()
    with open(path, "wt") as out:
        for p in range(n_parts):
            part = f"{path}.part{p}"
            with open(part, "rt") as f:
                if has_header:
                    header = f.readline()
                    if p == 0:
                        out.write(header)
                for line in f:
                    out.write(line)
            os.remove(part)
    return path
