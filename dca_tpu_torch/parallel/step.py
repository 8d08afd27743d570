"""The training step, on one device or data parallel over a process group.

The counterpart of the JAX package's ``dca_tpu/parallel/step.py``, where
GSPMD inserts the collectives into one compiled step.  Here each rank
computes its block of the global batch (``batch_shard``) and the step sums
what the global batch needs over the ranks:

  * BatchNorm's batch statistics (``models/core.py``, ``all_reduce_sum``);
  * the loss's (sum, count) pair, so that each rank's loss is its share
    of the mean over the whole batch (``losses.py``,
    ``ops/fused_loss.py``); the l1/l2 penalty is added on rank 0 alone;
  * the gradients, as one flat buffer, before the optimizer clips them.

The ranks start from rank 0's parameters (``place_train_state``) and apply
the same summed gradients, so they hold the same parameters after every
step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .multihost import process_row_range


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows [lo, hi) of a global batch of n rows, and the
    group of ranks that share the batch."""

    group: object
    rank: int
    lo: int
    hi: int
    n: int


def batch_shard(group, n):
    """This rank's ``BatchShard`` of a global batch of ``n`` rows."""
    rank = dist.get_rank(group)
    lo, hi = process_row_range(n, rank, dist.get_world_size(group))
    return BatchShard(group, rank, lo, hi, n)


def shard_train_data(group, *arrays):
    """This rank's block of rows of each of ``arrays`` (of one length)."""
    shard = batch_shard(group, len(arrays[0]))
    return tuple(a[shard.lo:shard.hi] for a in arrays)


@torch.no_grad()
def place_train_state(network, group):
    """Broadcast the parameters and the BatchNorm state from rank 0, so
    every rank starts from the same network."""
    for t in list(network.model.parameters()) + list(network.model.buffers()):
        dist.broadcast(t.detach(), src=0, group=group)


def make_sharded_train_step(network, opt, group=None):
    """One training step: ``step(X, T, SF, idx, opt_state, lr, generator)``
    fits ``network`` on the batch of rows ``idx`` of the staged split
    (X, T, SF), updates its parameters, optimizer state and BN state in
    place and returns the loss (detached).  With a process ``group`` this
    rank computes its block of the batch and the loss it returns is its
    share; without one the step is the single-device step."""
    params = list(network.model.parameters())
    sizes = [p.numel() for p in params]

    def step(X, T, SF, idx, opt_state, lr, generator):
        shard = None
        if group is not None:
            shard = batch_shard(group, len(idx))
            idx = idx[shard.lo:shard.hi]
        loss, new_state = network.loss_fn(X[idx], SF[idx], T[idx], True, generator,
                                          shard=shard)
        grads = torch.autograd.grad(loss, params)
        if group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            grads = [g.view_as(p) for g, p in zip(flat.split(sizes), params)]
        opt.update(grads, opt_state, params, lr)
        network.model.load_bn_state(new_state)
        return loss.detach()

    return step
