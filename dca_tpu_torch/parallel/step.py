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

On every path the step takes its rows, its step index and its learning
rate from device buffers and writes its loss there (``StepBuffers``), so
one CUDA device can capture it in a graph and replay it
(``train/graphs.py``); the data-parallel step runs the same body from
Python, its collectives outside any graph.

The streaming trainer stages each part of the epoch into a part buffer,
and under a group each rank stages only its block of each batch
(``part_rows``); ``stream_places`` maps every row of the epoch to its
place in this rank's buffer, so the same step reads its block from there
while its ``BatchShard`` still spans the global batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


def part_rows(idx, batch, rank=0, world=1):
    """This rank's rows of a streamed part ``idx`` whose batches are
    ``batch`` rows each (one batch for a trailing part): its block of each
    batch (``process_row_range``), the batches one after the other.  All
    of ``idx`` for one rank."""
    lo, hi = process_row_range(batch, rank, world)
    return np.asarray(idx).reshape(-1, batch)[:, lo:hi].reshape(-1)


def stream_places(n_train, batch, chunk, rank=0, world=1):
    """The place in this rank's part buffer of each of an epoch's rows, in
    the order of the epoch's permutation: the streaming trainer's
    ``StepBuffers.perm``.  The full batches come in parts of ``chunk``
    rows (a multiple of ``batch``) and the trailing ``n_train mod batch``
    rows in a part of their own, each staged by ``part_rows``; a row of
    another rank's block gets place 0, which the step never reads (it
    takes its block of the batch's places)."""
    n_full = n_train // batch
    rem = n_train - n_full * batch
    place = np.zeros(n_train, np.int64)
    p = np.arange(n_full * batch)
    lo, hi = process_row_range(batch, rank, world)
    col = p % batch
    mine = (col >= lo) & (col < hi)
    place[:n_full * batch][mine] = ((p % chunk) // batch * (hi - lo) + col - lo)[mine]
    lo, hi = process_row_range(rem, rank, world)
    place[n_full * batch + lo:n_full * batch + hi] = np.arange(hi - lo)
    return place


def held_shard(group, n, held):
    """The ``BatchShard`` under which this rank evaluates the ``held``
    rows it staged of a streamed part of ``n`` rows (its block of each of
    the part's batches, not one block of the part): evaluation reads its
    group and its rank alone, the rows are [0, held) of its buffer."""
    return BatchShard(group, dist.get_rank(group), 0, held, n)


@torch.no_grad()
def place_train_state(network, group):
    """Broadcast the parameters and the BatchNorm state from rank 0, so
    every rank starts from the same network."""
    for t in list(network.model.parameters()) + list(network.model.buffers()):
        dist.broadcast(t.detach(), src=0, group=group)


@dataclasses.dataclass(frozen=True)
class StepBuffers:
    """The device tensors a training step reads and writes besides the
    model and the optimizer state, each at a fixed address, so that a
    captured step replays on them (``train/graphs.py``):

      * ``perm`` (n_train,) int64: the epoch's row order, copied in once an
        epoch;
      * ``step_i`` (1,) int64: the full step the next one is, zeroed once an
        epoch and advanced by each full step;
      * ``losses`` (n_full + 1,) float32: each full step's loss at its
        ``step_i``, then the trailing step's (0 while there is none);
      * ``lr`` () float32: the learning rate, which ReduceLROnPlateau
        rewrites between epochs;

    and for the whole fit on the device (``train/compiled.py``), with
    ``perms``:

      * ``perms`` (epochs, n_train): every epoch's row order, uploaded once
        before the first epoch, int32 where n_train < 2**31 (the table
        takes epochs x n_train x 4 bytes: 2.9 MB for 300 epochs of 2457
        rows; at the in-memory gate's largest input, input and target of
        6e9 bytes, e.g. 217,328 cells of 3451 genes, 0.22 GiB for 300
        epochs of its 90% train split);
      * ``epoch`` (1,) int64: the epoch the next one is, from which
        ``start_epoch`` takes its row of ``perms`` into ``perm``.

    They are what ``lax.scan`` feeds the JAX package's ``epoch_fn`` body:
    its ``(idx, step_i)`` inputs, its stacked losses and ``lr_arr``, and
    the ``epoch`` of its whole-fit ``while_loop``."""

    perm: torch.Tensor
    step_i: torch.Tensor
    losses: torch.Tensor
    lr: torch.Tensor
    batch: int
    perms: torch.Tensor | None = None
    epoch: torch.Tensor | None = None

    @classmethod
    def create(cls, n_train, batch, lr, device, perms=None):
        """``perms``: a host (epochs, n_train) array of row orders, for the
        whole fit on the device."""
        table = epoch = None
        if perms is not None:
            dtype = np.int32 if n_train < 2**31 else np.int64
            table = torch.from_numpy(np.ascontiguousarray(perms, dtype=dtype)).to(device)
            epoch = torch.zeros(1, dtype=torch.int64, device=device)
        return cls(perm=torch.zeros(n_train, dtype=torch.int64, device=device),
                   step_i=torch.zeros(1, dtype=torch.int64, device=device),
                   losses=torch.zeros(n_train // batch + 1, device=device),
                   lr=torch.tensor(lr, dtype=torch.float32, device=device),
                   batch=batch, perms=table, epoch=epoch)

    @property
    def n_full(self):
        return self.losses.numel() - 1

    def start_epoch(self):
        """Take the ``epoch``-th row of ``perms`` as the epoch's row order,
        on the device, and zero the step counter."""
        self.perm.copy_(self.perms.index_select(0, self.epoch).view(-1))
        self.step_i.zero_()

    def rows(self, trailing):
        """The rows of the next step: the ``step_i``-th batch of ``perm``
        read on the device, or the trailing rows after the full batches."""
        end = self.n_full * self.batch
        if trailing:
            return self.perm[end:]
        return self.perm[:end].view(self.n_full, self.batch).index_select(
            0, self.step_i).view(-1)


def all_reduce_grads(grads, params, group):
    """The gradients summed over the ranks of ``group``, as one flat
    buffer: each rank's are its share of the batch's."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    return [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]), params)]


def make_sharded_train_step(network, opt, group=None):
    """One training step: ``step(X, T, SF, bufs, opt_state, generator,
    trailing=False)`` fits ``network`` on the next batch of rows of the
    staged split (X, T, SF), chosen through ``bufs`` (a ``StepBuffers``),
    at the learning rate ``bufs.lr``; it updates the parameters, the
    optimizer state and the BN state in place and writes the loss into
    ``bufs.losses``.  A full step takes the ``bufs.step_i``-th batch and
    advances ``step_i``; the trailing step takes the rows after the full
    batches.  Nothing is read back to the host, so the step can be
    captured in a CUDA graph.  With a process ``group`` this rank computes
    its block of the batch and the loss it writes is its share; without
    one the step is the single-device step.  Under a group (X, T, SF) may
    hold this rank's rows alone, the streaming trainer's part buffer, with
    ``bufs.perm`` from ``stream_places``: the places in this rank's block
    of the batch then point at its rows there, and the shard still spans
    the global batch (its BatchNorm sums, loss pair, dropout mask and
    gradients)."""
    params = list(network.model.parameters())

    def step(X, T, SF, bufs, opt_state, generator, trailing=False):
        idx = bufs.rows(trailing)
        shard = None
        if group is not None:
            shard = batch_shard(group, len(idx))
            idx = idx[shard.lo:shard.hi]
        loss, new_state = network.loss_fn(X[idx], SF[idx], T[idx], True, generator,
                                          shard=shard)
        grads = torch.autograd.grad(loss, params)
        if group is not None:
            grads = all_reduce_grads(grads, params, group)
        opt.update(grads, opt_state, params, bufs.lr)
        network.model.load_bn_state(new_state)
        loss = loss.detach().view(1)
        if trailing:
            bufs.losses[bufs.n_full:].copy_(loss)
        else:
            bufs.losses.index_copy_(0, bufs.step_i, loss)
            bufs.step_i.add_(1)

    return step
