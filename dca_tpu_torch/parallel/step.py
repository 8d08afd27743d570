"""The training step, on one device or over a ('data', 'model') grid of
ranks.

The counterpart of the JAX package's ``dca_tpu/parallel/step.py``, where
GSPMD inserts the collectives into one compiled step.  Here each rank
computes its block of the global batch (``batch_shard``, by its data
index) and the step sums what the global batch needs over the ranks:

  * BatchNorm's batch statistics, over the data group (``models/core.py``,
    ``all_reduce_sum``);
  * the loss's (sum, count) pair over every rank, so that each rank's loss
    is its share of the mean over the whole batch (``losses.py``,
    ``ops/fused_loss.py``); the l1/l2 penalty is added once
    (``network.loss_fn``);
  * the gradients, as flat buffers, before the optimizer clips them
    (``all_reduce_grads``).

With gene-dim model parallelism (``parallel/mesh.py``, M > 1) each rank
also holds only its gene shard of the input kernel and of the heads
(``shard_params``), and stages its gene columns of the input and the
target: the input layer's partial products are summed over the model
group, the heads give this rank's columns, and a rank's loss share is
that of its (data block x gene shard).  The gradients of gene shards are
then summed over the data group and those of whole tensors over every
rank: each rank's autograd sees only its own shard's path to them.  Where
M does not divide a gene dimension the tensors of it stay whole on every
rank, and each of the M copies of a head counts once in the loss's sum
and once in its count, so the mean is unchanged.

The ranks start from rank 0's parameters (``place_train_state``) and apply
the same summed gradients, so they hold the same parameters (or blocks of
them) after every step.

On every path the step takes its rows, its step index and its learning
rate from device buffers and writes its loss there (``StepBuffers``), and
reads nothing back to the host: its shard bounds come from the static
length of the batch (``batch_shard``), so a CUDA device captures it in a
graph and replays it (``train/graphs.py``), with or without a group.
Over NCCL its collectives are captured with it (the flat gradient
buffers of ``all_reduce_grads`` allocate from the graph's pool); over
gloo, whose collectives run on the host, it runs from Python.

The streaming trainer stages each part of the epoch into a part buffer,
and under a group each rank stages only its data index's block of each
batch (``part_rows``: the M ranks of a data index stage the same rows);
``stream_places`` maps every row of the epoch to its place in this rank's
buffer, so the same step reads its block from there while its
``BatchShard`` still spans the global batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .mesh import shard_params
from .multihost import process_row_range


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """This rank's rows [lo, hi) of a global batch of n rows: ``group``
    the ranks that share the batch's rows (the mesh's data group) and
    ``rank`` this one's index among them; ``mesh`` the whole grid
    (``parallel/mesh.py``), whose every rank holds a share of the loss."""

    group: object
    rank: int
    lo: int
    hi: int
    n: int
    mesh: object

    @property
    def world(self):
        """The group the loss's (sum, count) pair is summed over."""
        return self.mesh.world


def batch_shard(mesh, n):
    """This rank's ``BatchShard`` of a global batch of ``n`` rows: the
    block of its data index."""
    lo, hi = process_row_range(n, mesh.data_index, mesh.n_data)
    return BatchShard(mesh.data, mesh.data_index, lo, hi, n, mesh)


def shard_train_data(mesh, *arrays):
    """This rank's block of rows of each of ``arrays`` (of one length), by
    its data index."""
    shard = batch_shard(mesh, len(arrays[0]))
    return tuple(a[shard.lo:shard.hi] for a in arrays)


def part_rows(idx, batch, data_index=0, n_data=1):
    """The rows of a streamed part ``idx`` whose batches are ``batch`` rows
    each (one batch for a trailing part) that data index ``data_index`` of
    ``n_data`` stages: its block of each batch (``process_row_range``, the
    rows' one layout rule, as ``batch_shard``'s), the batches one after the
    other.  All of ``idx`` for one data index."""
    lo, hi = process_row_range(batch, data_index, n_data)
    return np.asarray(idx).reshape(-1, batch)[:, lo:hi].reshape(-1)


def stream_places(n_train, batch, chunk, data_index=0, n_data=1):
    """The place in the part buffer of data index ``data_index`` of
    ``n_data`` of each of an epoch's rows, in the order of the epoch's
    permutation: the streaming trainer's ``StepBuffers.perm``.  The full
    batches come in parts of ``chunk`` rows (a multiple of ``batch``) and
    the trailing ``n_train mod batch`` rows in a part of their own, each
    staged by ``part_rows``; a row of another data index's block gets
    place 0, which the step never reads (it takes its block of the batch's
    places)."""
    n_full = n_train // batch
    rem = n_train - n_full * batch
    place = np.zeros(n_train, np.int64)
    p = np.arange(n_full * batch)
    lo, hi = process_row_range(batch, data_index, n_data)
    col = p % batch
    mine = (col >= lo) & (col < hi)
    place[:n_full * batch][mine] = ((p % chunk) // batch * (hi - lo) + col - lo)[mine]
    lo, hi = process_row_range(rem, data_index, n_data)
    place[n_full * batch + lo:n_full * batch + hi] = np.arange(hi - lo)
    return place


def held_shard(mesh, n, held):
    """The ``BatchShard`` under which this rank evaluates the ``held``
    rows it staged of a streamed part of ``n`` rows (its data index's
    block of each of the part's batches, not one block of the part):
    evaluation reads its data group and its data index alone, the rows
    are [0, held) of its buffer."""
    return BatchShard(mesh.data, mesh.data_index, 0, held, n, mesh)


@torch.no_grad()
def place_train_state(network, mesh):
    """Broadcast the whole parameters and the BatchNorm state from rank 0,
    so every rank starts from the same network, then keep this rank's gene
    shards (``mesh.shard_params``) where the mesh has a model axis: shard
    m of a tensor is the slice m of the whole network's, as the JAX
    package shards its whole initial network."""
    for t in list(network.model.parameters()) + list(network.model.buffers()):
        dist.broadcast(t.detach(), src=0, group=mesh.world)
    if mesh.n_model > 1:
        shard_params(network, mesh)


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


def _all_reduce_flat(grads, group):
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def all_reduce_grads(grads, mesh, sharded=None):
    """The gradients summed over the ranks of ``mesh``: each rank's are its
    share of the batch's.  Without ``sharded`` (a bool per gradient: its
    parameter is a gene shard) as one flat buffer over every rank; with
    it, the gene shards' over the data group and the whole tensors' over
    every rank, one flat buffer each."""
    if sharded is None or not any(sharded):
        return _all_reduce_flat(grads, mesh.world)
    out = list(grads)
    for keep, group in ((True, mesh.data), (False, mesh.world)):
        idx = [i for i, s in enumerate(sharded) if s == keep]
        if idx:
            for i, g in zip(idx, _all_reduce_flat([grads[i] for i in idx], group)):
                out[i] = g
    return out


def sharded_params(network):
    """A bool per parameter of ``network``: a gene shard it holds
    (``network.sharded``; ``all_reduce_grads``' ``sharded``), None where
    it holds none."""
    if not network.sharded:
        return None
    return [name in network.sharded for name, _ in network.model.named_parameters()]


def make_sharded_train_step(network, opt, mesh=None):
    """One training step: ``step(X, T, SF, bufs, opt_state, generator,
    trailing=False)`` fits ``network`` on the next batch of rows of the
    staged split (X, T, SF), chosen through ``bufs`` (a ``StepBuffers``),
    at the learning rate ``bufs.lr``; it updates the parameters, the
    optimizer state and the BN state in place and writes the loss into
    ``bufs.losses``.  A full step takes the ``bufs.step_i``-th batch and
    advances ``step_i``; the trailing step takes the rows after the full
    batches.  Nothing is read back to the host, so the step can be
    captured in a CUDA graph, its collectives too over NCCL.  Over a
    ``mesh`` (``parallel/mesh.py``) this rank computes its block of the
    batch and the loss it writes is its share; without one the step is
    the single-device step.  With a model
    axis (X, T) hold this rank's gene columns of the input and the target
    (``Mesh.gene_block``).  Under a group (X, T, SF) may
    hold this rank's rows alone, the streaming trainer's part buffer, with
    ``bufs.perm`` from ``stream_places``: the places in this rank's block
    of the batch then point at its rows there, and the shard still spans
    the global batch (its BatchNorm sums, loss pair, dropout mask and
    gradients)."""
    params = list(network.model.parameters())
    sharded = sharded_params(network)

    def step(X, T, SF, bufs, opt_state, generator, trailing=False):
        idx = bufs.rows(trailing)
        shard = None
        if mesh is not None:
            shard = batch_shard(mesh, len(idx))
            idx = idx[shard.lo:shard.hi]
        loss, new_state = network.loss_fn(X[idx], SF[idx], T[idx], True, generator,
                                          shard=shard)
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            grads = all_reduce_grads(grads, mesh, sharded)
        opt.update(grads, opt_state, params, bufs.lr)
        network.model.load_bn_state(new_state)
        loss = loss.detach().view(1)
        if trailing:
            bufs.losses[bufs.n_full:].copy_(loss)
        else:
            bufs.losses.index_copy_(0, bufs.step_i, loss)
            bufs.step_i.add_(1)

    return step
