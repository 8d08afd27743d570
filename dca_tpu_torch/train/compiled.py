"""The whole fit on the device: the port of the JAX package's
``dca_tpu/train/compiled.py`` (``build_fit_fn``), which compiles the
epochs, the per-epoch shuffle, the minibatch steps, the validation,
EarlyStopping, ReduceLROnPlateau and the best-weights tracking into one XLA
program (a ``lax.while_loop`` over the epochs, a ``lax.scan`` over the
steps) that the host calls once and reads back once.

Here the fit's state lives in device tensors (``FitState``): the
parameters, BN statistics and optimizer state of the network, updated in
place by the step of ``parallel/step.py``; the learning rate and the
epoch index of the step's ``StepBuffers``; the callbacks' counters, the
stop flag and the (epochs,) histories, NaN where no epoch ran; with
``track_best`` a copy of every parameter and BN statistic at its best
monitor, which starts at the initial values.  One epoch of the fit
(``epoch``) is the body of the JAX package's ``epoch_body`` line by line:
the n_full full steps and the trailing step on the epoch's row of the
permutation table, the validation loss, the callbacks as ``torch.where``
arithmetic in float32 (EarlyStopping min_delta 0, ReduceLROnPlateau factor
0.1 and min_delta 1e-4, min_lr 0) and the history writes at the device
epoch index; nothing of it reads back to the host.  The fit then runs the
epochs:

  * on one CUDA device, as one CUDA graph replayed once an epoch
    (``train/graphs.py::GraphFit``): the epoch is the body of a conditional
    IF node that runs only while ``stop`` is false, so the host enqueues
    every epoch with no wait between them and reads back once after the
    last; a replay after the early stop changes nothing;
  * as a rank of an NCCL group, as one CUDA graph replayed once an epoch
    too, its collectives (the steps' and the losses' sum) in the graph as
    NCCL kernel nodes: the counterpart of the JAX package's whole-fit
    program jitted over the mesh (``dca_tpu/train/loop.py::
    _train_compiled`` with ``mesh``).  CUDA refuses NCCL's collectives in
    a conditional node's body (``GraphFit``), so the epoch is the graph
    itself: the host waits for each replay by polling its event, posts a
    point of progress for each epoch the device completed (so the group's
    progress rule follows the device and a dead or silent peer ends the
    fit, ``parallel/launch.py``), then reads ``stop``, and replays again
    while it is false;
  * on the CPU, over gloo (whose collectives run on the host), in
    ``debug`` and with ``graphs=False``, the same epoch from Python, with
    one read of ``stop`` an epoch.

Differences from the JAX package's program (documented, tested): the row
orders are drawn on the host, from ``np.random.RandomState(seed)`` as the
Python-epoch loop draws them, and uploaded once as an (epochs, n_train)
table before the first epoch, where the JAX package draws them with
``jax.random`` inside the program (the tests inject those through the
table); as there, ModelCheckpoint writes the best state once after the fit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from .. import timeline
from ..parallel.launch import check_failed, post_progress
from ..parallel.step import StepBuffers, make_sharded_train_step
from .graphs import GraphFit
from .optim import state_tensors

RLR_FACTOR, RLR_MIN_DELTA = 0.1, 1e-4


@dataclasses.dataclass
class FitResult:
    """What the fit reads back once, after its last epoch: the (epochs,)
    histories with NaN past the epochs run, the number of epochs run, and
    with ``track_best`` the best state (device tensors in the order of
    ``network.model.parameters()`` then ``buffers()``).  ``epoch_s``: each
    epoch run's time (from CUDA events between the replays on the graph
    path, else the host's wall time of its steps, validation, callbacks and
    read of ``stop``, the span ``dca.fit.epoch``); ``after_stop_s``: each
    replay's after the stop, on the graph path; ``capture_s``: the graph's
    warm-up and capture (``dca.graphs.capture``), and ``enqueue_s``: the
    host's enqueue of every replay (the sum of the spans
    ``dca.fit.replay``), None without a graph."""

    loss: np.ndarray
    val_loss: np.ndarray
    lr: np.ndarray
    epochs_run: int
    best: list | None
    epoch_s: list
    after_stop_s: list
    capture_s: float | None
    enqueue_s: float | None


@dataclasses.dataclass
class FitState:
    """The callbacks' state of the fit, the carry of the JAX package's
    ``while_loop`` beside the network's tensors: ``lr`` and ``epoch`` are
    the step buffers' own."""

    lr: torch.Tensor
    epoch: torch.Tensor
    best_monitor: torch.Tensor
    rlr_best: torch.Tensor
    es_wait: torch.Tensor
    rlr_wait: torch.Tensor
    stop: torch.Tensor
    loss_h: torch.Tensor
    val_h: torch.Tensor
    lr_h: torch.Tensor
    best: list | None

    @classmethod
    def create(cls, bufs, epochs, live=None):
        device = bufs.lr.device

        def full(value, dtype=torch.float32, n=()):
            return torch.full(n, value, dtype=dtype, device=device)

        return cls(lr=bufs.lr, epoch=bufs.epoch, best_monitor=full(np.inf),
                   rlr_best=full(np.inf), es_wait=full(0, torch.int32),
                   rlr_wait=full(0, torch.int32), stop=full(False, torch.bool, (1,)),
                   loss_h=full(np.nan, n=(max(epochs, 1),)),
                   val_h=full(np.nan, n=(max(epochs, 1),)),
                   lr_h=full(np.nan, n=(max(epochs, 1),)),
                   best=None if live is None else [t.detach().clone() for t in live])

    def tensors(self):
        """Every tensor an epoch writes."""
        return [self.lr, self.epoch, self.best_monitor, self.rlr_best, self.es_wait,
                self.rlr_wait, self.stop, self.loss_h, self.val_h, self.lr_h,
                *(self.best or [])]


def build_fit_fn(network, opt, *, n_train, batch_size, epochs, has_val, reduce_lr,
                 early_stop, track_best, mesh=None):
    """Returns ``fit(X_tr, T_tr, sf_tr, val, lr0, perms, opt_state,
    generator, graphs=True, after_epoch=None, val_shard=None) ->
    FitResult``, which fits ``network`` in place on the staged train split
    (X_tr, T_tr, sf_tr) and ``val`` ((X, T, sf) of the validation split,
    None without one) from learning rate ``lr0``, with the row orders
    ``perms`` (a host (epochs, n_train) array), the optimizer state
    ``opt_state`` of ``opt`` and the dropout ``generator``.  ``graphs``:
    replay the epoch from a CUDA graph (``GraphFit``; the caller's
    ``graphs.capture_steps``), else run it from Python; ``after_epoch()``
    is called after each epoch is run or enqueued.

    Over a ``mesh`` of ranks (``parallel/mesh.py``; with a model axis the
    network holds this rank's gene shards and the splits its gene columns)
    each rank computes its block of every batch
    and, given as ``val`` with its ``val_shard`` (``batch_shard``), of the
    validation split, and the losses are summed over the ranks before the
    callbacks, so every rank takes the same decisions."""
    bs = min(batch_size, max(n_train, 1))
    n_full = n_train // bs
    rem = n_train - n_full * bs
    train_step = make_sharded_train_step(network, opt, mesh)

    def fit(X_tr, T_tr, sf_tr, val, lr0, perms, opt_state, generator, graphs=True,
            after_epoch=None, val_shard=None):
        device = X_tr.device
        live = list(network.model.parameters()) + list(network.model.buffers())
        bufs = StepBuffers.create(n_train, bs, lr0, device, perms=perms)
        st = FitState.create(bufs, epochs, live if track_best else None)

        def step(trailing=False):
            train_step(X_tr, T_tr, sf_tr, bufs, opt_state, generator, trailing)

        @torch.no_grad()
        def end_epoch():
            """The epoch's losses, callbacks and history: the JAX package's
            compiled.py:116-151."""
            sums = [bufs.losses[:n_full].sum(), bufs.losses[n_full]]
            if has_val:
                X_val, T_val, sf_val = val
                sums.append(network.loss_fn(X_val, sf_val, T_val, False, shard=val_shard)[0])
            sums = torch.stack(sums)
            if mesh is not None:
                # each rank's losses are its shares
                dist.all_reduce(sums, group=mesh.world)
            total = torch.zeros((), device=device)
            if n_full > 0:
                total = total + sums[0] * bs
            if rem > 0:
                total = total + sums[1] * rem
            train_loss = total / max(n_train, 1)
            monitor = sums[2] if has_val else train_loss
            i = st.epoch
            st.loss_h.index_copy_(0, i, train_loss.view(1))
            if has_val:
                st.val_h.index_copy_(0, i, sums[2:])
            st.lr_h.index_copy_(0, i, st.lr.view(1))

            improved = monitor < st.best_monitor  # a NaN monitor never improves
            st.best_monitor.copy_(torch.where(improved, monitor, st.best_monitor))
            st.es_wait.copy_(torch.where(improved, 0, st.es_wait + 1))
            if early_stop:
                st.stop.copy_((st.es_wait >= early_stop).view(1))
            if track_best:
                for b, t in zip(st.best, live):
                    b.copy_(torch.where(improved, t, b))
            if reduce_lr:
                rlr_improved = monitor < st.rlr_best - RLR_MIN_DELTA
                st.rlr_best.copy_(torch.where(rlr_improved, monitor, st.rlr_best))
                st.rlr_wait.copy_(torch.where(rlr_improved, 0, st.rlr_wait + 1))
                trigger = st.rlr_wait >= reduce_lr
                st.lr.copy_(torch.where(trigger, st.lr * RLR_FACTOR, st.lr))
                st.rlr_wait.copy_(torch.where(trigger, 0, st.rlr_wait))
            st.epoch.add_(1)

        def epoch():
            bufs.start_epoch()
            for _ in range(n_full):
                step()
            if rem:
                step(trailing=True)
            end_epoch()

        epoch_s, after_stop_s, capture_s, enqueue_s = [], [], None, None
        if epochs > 0 and graphs:
            written = (live + state_tensors(opt_state)
                       + [bufs.perm, bufs.step_i, bufs.losses] + st.tensors())
            # over a group the epoch's collectives make it a plain graph,
            # each replay waited for (``GraphFit``)
            runner = GraphFit(epoch, written, generator, st.stop, device,
                              conditional=mesh is None)
            capture_s = runner.capture_s
            if mesh is None:
                events = runner.run(epochs, after_epoch)
            else:
                events = runner.run_each(epochs, post_progress, check_failed, after_epoch)
            enqueue_s = runner.enqueue_s
            with timeline.span("dca.fit.fetch"):
                host = _read_back(st)  # the fit's one read-back
            runner.credit(len(events) - 1, host[3])
            times = [a.elapsed_time(b) / 1e3 for a, b in zip(events[:-1], events[1:])]
            epoch_s, after_stop_s = times[:host[3]], times[host[3]:]
        else:
            for e in range(epochs):
                timeline.begin_epoch(e)
                with timeline.timed("dca.fit.epoch", leaf=False) as span:
                    epoch()
                    stop = bool(st.stop)  # the epoch's one read
                epoch_s.append(span.dur)
                post_progress()
                if after_epoch is not None:
                    after_epoch()
                if stop:
                    break
            with timeline.span("dca.fit.fetch"):
                host = _read_back(st)
        loss, val_loss, lr, n_run = host
        return FitResult(loss=loss, val_loss=val_loss, lr=lr, epochs_run=n_run,
                         best=st.best, epoch_s=epoch_s, after_stop_s=after_stop_s,
                         capture_s=capture_s, enqueue_s=enqueue_s)

    return fit


def _read_back(st):
    """The histories and the epochs run, in one copy to the host."""
    n = st.loss_h.numel()
    host = torch.cat([st.loss_h, st.val_h, st.lr_h, st.epoch.to(torch.float32)]).cpu().numpy()
    return host[:n], host[n:2 * n], host[2 * n:3 * n], int(host[3 * n])
