"""Training loop with Keras-parity callbacks, and the CLI's run.

A port of the JAX package's fit on every backend but the TPU
(``dca_tpu/train/loop.py::_train_inner``), whose epoch is one jitted
``epoch_fn`` (a ``lax.scan`` over the full steps) and one jitted
``rem_step_fn`` for the trailing batch:

  * the train split lives on the device, and each minibatch is gathered
    there from a per-epoch permutation drawn from
    ``np.random.RandomState(seed)``, the same stream the JAX loop draws;
    the step reads its rows, its step index and its learning rate from
    device buffers and writes its loss there (``parallel/step.py``,
    ``StepBuffers``), so nothing of an epoch's steps goes through the host;
  * on a CUDA device, outside ``debug``, with no process group or over
    NCCL, the full step and the trailing step are captured once a fit as
    two CUDA graphs and replayed, n_full times and once an epoch: the
    counterpart of ``epoch_fn`` and ``rem_step_fn``, and over a group of
    the JAX package's one jitted step over the mesh (``train/graphs.py``,
    ``capture_steps``).  A failed capture raises; it never falls back to
    the eager loop.  The CPU fit, the ``debug`` fit (its sanitizer reads
    values back, and the JAX package leaves jit there too) and a fit over
    gloo (its collectives run on the host) call the same step from
    Python;
  * the trailing partial batch keeps its own shape (no padding);
  * validation follows Keras ``validation_split``: the last fraction of the
    rows is held out before any shuffling, and is evaluated eagerly once
    an epoch;
  * the per-step losses stay on the device and are read once per epoch;
  * ReduceLROnPlateau (factor 0.1, min_delta 1e-4) and EarlyStopping
    (min_delta 0) are plain Python state between epochs, and the learning
    rate reaches the step as a device scalar rewritten between epochs; as
    in the JAX package, the final weights are kept (no restore of the best
    ones).

A deferred z-scale (``normalize(lazy_scale=True)``) is applied when the
host arrays are assembled.  The CLI's run writes its outputs from the
in-memory predict, or, for ``--outputformat h5ad`` and outputs above
DCA_TPU_HOST_DENSE_BYTES (default 2 GB), streams them block by block
(``write_streaming``).

With ``devices`` the fit is data parallel over the ranks of a
``torch.distributed`` process group, one process per device
(``parallel/``): the ranks of torchrun, or, without a group, ranks that
the call starts itself, the caller as rank 0 (``parallel/launch.py``, the
counterpart of the JAX package's one program over several devices); every
rank stages the whole train split, draws the same
permutation and computes its block of each global batch, the trailing one
included; the batch statistics, the loss's (sum, count) pair and the
gradients are summed over the ranks, so the fit is the single-device fit
up to the order of the sums.  The validation split is cut into one block
per data index; where its length does not divide them it is padded with
copies of its row 0 at sample weight 0 (the JAX package's multi-process
padding), and the blocks are evaluated through the weighted loss kernels.
The per-step and validation losses are summed over the ranks once per
epoch, so every rank sees the same history and takes the same callback
decisions.  With ``model_parallel`` M > 1 the ranks form a grid of
D x M (``parallel/mesh.py``): rows shard over the D data indices, and
each rank holds its gene shard of the input kernel and of the heads and
stages only its gene columns of the input and of the target, as the
JAX package's ('data', 'model') mesh lays them out; after the fit every
rank holds the whole network again.

Inputs larger than the device, by the JAX package's gate (more than
``max_device_cells`` cells or, without it, input and target above
DCA_TPU_DEVICE_BYTES), take the streaming trainer (``_train_streaming``):
the matrix stays on the host and shuffled parts of it are staged, by one
of the JAX package's tiers, into two part buffers on the device while the
captured steps run on the other; its epochs print ``[streaming]``.  Under
a process group each rank stages only its block of each batch and runs
the data-parallel step on it (replayed from CUDA graphs over NCCL); with
``model_parallel`` the M ranks of a data index stage the same rows and
each steps on its gene columns.

The fit's artefacts, on every trainer, as the JAX package writes them
under ``output_dir``: ``checkpoint_every=N`` saves the whole training
state every N epochs (``checkpoints/``, ``train/checkpoint.py``: the
parameters, BN statistics, optimizer state, learning rate, callback
counters and the dropout generator) and ``resume=True`` restores the
latest in place before the steps are captured, replaying the permutation
stream, so the resumed epochs are the uninterrupted fit's; a checkpoint of
either package resumes in the other.  ``save_weights`` writes
``weights.hdf5`` at every improved monitor (``network.save_weights``).
``tensorboard`` writes ``tb/events.out.tfevents.*`` (``_TBLogger``:
scalars, weight and gradient histograms, the gradient taken on the
validation split in eval mode through the loss kernels) and a
``torch.profiler`` trace of the fit's set-up and first epochs beside it
(``_fit_trace``).  Under a process group only
the primary rank writes; every rank takes part in the collectives.

``compiled=True`` runs the whole fit on the device (``_train_compiled``,
``train/compiled.py``: the JAX package's whole-fit program, which its
``"auto"`` takes on a TPU): the epochs, their steps, the validation, the
callbacks and the histories without a host hop, one CUDA graph replayed
once an epoch on a CUDA device, alone or as a rank of an NCCL group (its
collectives in the graph), read back once after the fit.  Here
``"auto"`` keeps the Python-epoch loop (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
import os
import random
import threading
import time
from collections import deque
from typing import NamedTuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from .. import native
from ..bridge import copy_tree_into, flatten_tree, unflatten_tree
from ..config import use_device_densify
from ..data.io import densify, scale_stats, size_factors
from ..data.loader import Flat8Chunk, FlatChunk, SparseChunk, StreamingData, canonicalize_csr
from ..device import resolve_device
from ..losses import nb_terms
from ..ops.densify import device_densify, device_densify_flat, device_densify_flat8, upload
from ..ops.resident import PART_BYTES_PER_SLOT, ResidentCSR, derive_input
from ..parallel.mesh import (gather_params, gather_tensor, rank_devices, resolve_mesh,
                             shard_named)
from ..parallel.launch import post_progress, watching
from ..parallel.multihost import initialize, is_primary
from ..parallel.step import (StepBuffers, all_reduce_grads, batch_shard, held_shard,
                             make_sharded_train_step, part_rows, place_train_state,
                             shard_train_data, sharded_params, stream_places)
from ..tbevents import EventWriter
from .checkpoint import TrainCheckpoint, optimizer_tree
from .graphs import EagerEpoch, GraphEpoch, GraphSteps, capture_steps
from .optim import get_optimizer, state_tensors


class History:
    """Keras-style history object (.history dict of per-epoch lists).
    ``epoch_s``: each epoch's wall time, the steps, the validation and the
    read-back of its losses; ``capture_s``: the wall time of the CUDA
    graphs' warm-up and capture before the first epoch, None for an eager
    fit; ``tb_s``: each epoch's TensorBoard logging (gradient, read-back,
    histograms and write; the streaming trainer takes its gradient inside
    the epoch); ``checkpoint_s`` and ``weights_s``: each checkpoint's and
    each ``weights.hdf5``'s save (read-back and file); ``restore_s``: a
    resume's restore (file read and copies in place), None without one;
    ``fit``: the ``compiled.FitResult`` of a ``compiled=True`` fit (its
    histories NaN past the epochs run, the device times of the replays
    after the stop), None for the Python-epoch loop; such a fit's
    ``epoch_s`` and ``capture_s`` are its own (``FitResult``); ``launch``:
    for a fit whose ranks the call started (``parallel/launch.py``), the
    ranks, the backend, the seconds until their group was formed and the
    bytes of its shared inputs, else None."""

    def __init__(self):
        self.history = {}
        self.epoch_s = []
        self.capture_s = None
        self.restore_s = None
        self.tb_s = []
        self.checkpoint_s = []
        self.weights_s = []
        self.fit = None
        self.launch = None

    def append(self, key, value):
        self.history.setdefault(key, []).append(float(value))


class _TBLogger:
    """Per-epoch TensorBoard logging, the counterpart of the reference's
    Keras ``TensorBoard(histogram_freq=1, write_grads=True)``, written with
    the TensorFlow-free writer of ``tbevents.py`` under the JAX package's
    tags: scalars ``loss``, ``val_loss`` and ``lr``, histograms
    ``weights/<path>`` and ``grads/<path>`` (the "/"-joined pytree paths of
    the parameters), and under ``debug`` ``debug/t1`` and ``debug/t2``, the
    NB summands of the reference's debug summaries.  The primary rank
    alone holds one."""

    def __init__(self, logdir):
        self.writer = EventWriter(logdir)

    def epoch(self, step, scalars, params, grads):
        """``params``/``grads``: {path: tensor}."""
        for k, v in scalars.items():
            if v is not None:
                self.writer.scalar(k, float(v), step)
        for prefix, tree in (("weights/", params), ("grads/", grads)):
            for path, t in tree.items():
                self.writer.histogram(prefix + path, t.detach().cpu().numpy(), step)
        self.writer.flush()

    def loss_terms(self, step, t1, t2):
        self.writer.histogram("debug/t1", t1.cpu().numpy(), step)
        self.writer.histogram("debug/t2", t2.cpu().numpy(), step)
        self.writer.flush()

    def close(self):
        self.writer.close()


def _tb_grads(network, x, sf, t, w=None, shard=None):
    """{path: gradient} of the eval-mode loss on (x, sf, t), as the JAX
    package's ``jax.grad`` of ``loss_fn(..., training=False)``: no dropout,
    BN on its moving statistics, nothing accumulated into ``.grad``, no BN
    statistics moved and no draw from the fit's generator, so the fit
    trains as it would without it.  On a CUDA device the NB/ZINB loss's
    backward is K2, K2w with ``w``.  Under a ``shard`` each rank's
    gradient is its share, summed over the ranks (``all_reduce_grads``),
    and the gene shards' gradients of a model-parallel fit are gathered
    whole: every rank of the fit calls it."""
    named = list(network.model.named_parameters())
    params = [p for _, p in named]
    loss, _ = network.loss_fn(x, sf, t, False, sample_weights=w, shard=shard)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    if shard is not None:
        grads = all_reduce_grads(grads, shard.mesh, sharded_params(network))
    return network.whole_named({name.replace(".", "/"): g
                                for (name, _), g in zip(named, grads)})


@torch.no_grad()
def _loss_terms(network, x, sf, t, shard=None):
    """The NB summands (t1, t2) of the eval forward on (x, sf, t), this
    rank's block of them under a ``shard``, or None for a likelihood or a
    network without a dispersion."""
    if network.definition.likelihood not in ("nb", "zinb"):
        return None
    out, _ = network.apply(x, sf, shard=shard)
    if out["disp"] is None:
        return None
    return nb_terms(t, out["output"], out["disp"])


# epochs of a TensorBoard fit that its profiler trace records
TRACE_EPOCHS = 2


def _fit_trace(logdir, device):
    """The counterpart of the JAX package's ``jax.profiler`` trace of a
    TensorBoard fit (``_FitTrace``), or a null context without
    ``logdir``."""
    return contextlib.nullcontext() if logdir is None else _FitTrace(logdir, device)


class _FitTrace:
    """A ``torch.profiler`` trace, the card's kernels included, of the
    fit's set-up (the graphs' capture among it) and its first
    ``TRACE_EPOCHS`` epochs (the trainers call ``step()`` after each
    epoch), written into ``logdir`` as a ``*.pt.trace.json`` when they
    end.  Not the whole fit: on the card the trace grows by ~25 MB and
    slows a replayed epoch by 25-90% for every epoch it records, and an
    eager data-parallel one eightfold (PERF.md)."""

    def __init__(self, logdir, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.logdir = logdir
        self.epochs = 0
        # one recording: acc_events keeps it from warning that a second
        # would drop the first's events
        self.prof = profile(activities=acts, acc_events=True)

    def __enter__(self):
        self.prof.start()
        return self

    def step(self):
        self.epochs += 1
        if self.epochs == TRACE_EPOCHS:
            self._finish()

    def _finish(self):
        if self.prof is not None:
            from torch.profiler import tensorboard_trace_handler

            self.prof.stop()
            tensorboard_trace_handler(self.logdir)(self.prof)
            self.prof = None

    def __exit__(self, *exc):
        self._finish()


class _FitCallbacks:
    """Keras-parity per-epoch callbacks: EarlyStopping (patience),
    ReduceLROnPlateau (factor=0.1, min_delta=1e-4, min_lr=0) and the
    best-monitor ``weights.hdf5`` of ``save_weights``; with ``restore`` and
    ``state_dict`` for the checkpoints."""

    FACTOR, MIN_DELTA, MIN_LR = 0.1, 1e-4, 0.0

    def __init__(self, lr, reduce_lr, early_stop, save_weights, output_dir, network,
                 verbose, monitor_name, hist):
        self.lr = lr
        self.reduce_lr = reduce_lr
        self.early_stop = early_stop
        self.save_weights = save_weights
        self.output_dir = output_dir
        self.network = network
        self.verbose = verbose
        self.monitor_name = monitor_name
        self.hist = hist
        self.best_monitor = math.inf
        self.es_wait = 0
        self.rlr_best = math.inf  # ReduceLROnPlateau tracks its own best
        self.rlr_wait = 0

    def restore(self, meta):
        self.lr = meta["lr"]
        cb = meta.get("callback_state", {})
        self.best_monitor = cb.get("best_monitor", self.best_monitor)
        self.es_wait = cb.get("es_wait", 0)
        self.rlr_best = cb.get("rlr_best", self.rlr_best)
        self.rlr_wait = cb.get("rlr_wait", 0)

    def state_dict(self):
        return dict(best_monitor=self.best_monitor, es_wait=self.es_wait,
                    rlr_best=self.rlr_best, rlr_wait=self.rlr_wait)

    def end_epoch(self, epoch, monitor) -> bool:
        """Apply all callbacks for one finished epoch; True => stop.  An
        improved monitor writes ``weights.hdf5`` from the live parameters,
        after the epoch's read-back.  Posts the epoch as the rank's
        progress where the launcher runs it (``launch.post_progress``)."""
        post_progress()
        stop = False
        if monitor < self.best_monitor:
            self.best_monitor = monitor
            self.es_wait = 0
            if self.save_weights and self.output_dir is not None:
                t0 = time.perf_counter()
                self.network.save_weights(os.path.join(self.output_dir, "weights.hdf5"))
                self.hist.weights_s.append(time.perf_counter() - t0)
        else:
            self.es_wait += 1
            if self.early_stop and self.es_wait >= self.early_stop:
                if self.verbose:
                    print(f"Epoch {epoch + 1}: early stopping "
                          f"({self.monitor_name})")
                stop = True
        if self.reduce_lr:
            if monitor < self.rlr_best - self.MIN_DELTA:
                self.rlr_best = monitor
                self.rlr_wait = 0
            else:
                self.rlr_wait += 1
                if self.rlr_wait >= self.reduce_lr:
                    new_lr = max(self.lr * self.FACTOR, self.MIN_LR)
                    if self.verbose and new_lr < self.lr:
                        print(f"Epoch {epoch + 1}: ReduceLROnPlateau "
                              f"reducing lr to {new_lr:.2e}")
                    self.lr = new_lr
                    self.rlr_wait = 0
        return stop


class _Checkpoints:
    """The fit's checkpoints (``checkpoint.TrainCheckpoint`` under
    ``<output_dir>/checkpoints``): the live training state as the JAX
    package's trees, restored in place (before any CUDA graph is captured
    on it) and saved with the JAX package's rule."""

    def __init__(self, output_dir, every, network, opt_state, generator, cbs, seed, hist):
        self.ckpt = TrainCheckpoint(os.path.join(output_dir, "checkpoints"))
        self.every = every
        self.network = network
        self.opt_state = opt_state
        self.generator = generator
        self.cbs = cbs
        self.seed = seed
        self.hist = hist

    def _tree(self, whole=False):
        """The live training state as the JAX package's trees; ``whole``:
        the gene shards of a model-parallel fit gathered (a collective)."""
        params, state = self.network.trees()
        names = [n for n, _ in self.network.model.named_parameters()]
        tree = {"params": params, "state": state,
                "opt_state": optimizer_tree(self.opt_state, names)}
        if whole and self.network.mesh is not None:
            tree = unflatten_tree(self.network.whole_named(flatten_tree(tree)))
        return tree

    def restore(self):
        """Restore the latest checkpoint in place: the parameters, the BN
        statistics, every optimizer state tensor, the dropout generator
        (where the checkpoint has it), the learning rate and the callback
        counters; a model-parallel fit takes its slices of the whole
        tensors.  Returns the epoch to start from (0 without one)."""
        live = self._tree()
        tree, meta = self.ckpt.restore({**live, "rng": {"generator": self.generator.get_state()}})
        if tree is None:
            return 0
        new = flatten_tree({k: tree.get(k, {}) for k in live})
        copy_tree_into(flatten_tree(live),
                       shard_named(new, self.network, self.network.mesh))
        if "rng" in tree:
            self.generator.set_state(tree["rng"]["generator"])
        self.cbs.restore(meta)
        return int(meta["step"]) + 1

    def after_epoch(self, epoch, epochs, stop):
        """Save after the callbacks, every ``every`` epochs, at a stop and
        at the last epoch."""
        if self.every and ((epoch + 1) % self.every == 0 or stop or epoch == epochs - 1):
            t0 = time.perf_counter()
            tree = self._tree(whole=True)
            self.ckpt.save(epoch, tree["params"], tree["state"], tree["opt_state"],
                           lr=self.cbs.lr, seed=self.seed, callback_state=self.cbs.state_dict(),
                           extra={"rng/generator": self.generator.get_state()})
            self.hist.checkpoint_s.append(time.perf_counter() - t0)


def _start_fit(output_dir, checkpoint_every, resume, network, opt_state, generator, cbs,
               seed, hist, rng_np, n_train, verbose, tag=""):
    """The fit's checkpoints (None without ``output_dir``, or when neither
    ``checkpoint_every`` nor ``resume`` is given) and the epoch to start
    from: with ``resume``, the epoch after the latest checkpoint, whose
    state is restored in place, and ``rng_np`` replays the permutations of
    the epochs before it, so the resumed epochs see the same row orders."""
    if not (checkpoint_every or resume) or output_dir is None:
        return None, 0
    ckpts = _Checkpoints(output_dir, checkpoint_every, network, opt_state, generator, cbs,
                         seed, hist)
    start = 0
    if resume:
        t0 = time.perf_counter()
        start = ckpts.restore()
        hist.restore_s = time.perf_counter() - t0
    for _ in range(start):
        rng_np.permutation(n_train)
    if start and verbose:
        print(f"dca_tpu_torch: resumed from epoch {start}{tag}")
    return ckpts, start


def _backend(group):
    """The backend of process group ``group``, None for no group."""
    return None if group is None else dist.get_backend(group)


def _pad_rows(arr, n_pad):
    """Append ``n_pad`` copies of row 0 (the padding rows carry sample
    weight 0 through the loss)."""
    if n_pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], n_pad, axis=0)], axis=0)


def train(
    adata,
    network,
    output_dir=None,
    optimizer="RMSprop",
    learning_rate=None,
    epochs=300,
    reduce_lr=10,
    output_subset=None,
    use_raw_as_output=True,
    early_stop=15,
    batch_size=32,
    clip_grad=5.0,
    save_weights=False,
    validation_split=0.1,
    tensorboard=False,
    verbose=True,
    threads=None,
    seed=42,
    compiled="auto",
    checkpoint_every=0,
    resume=False,
    max_device_cells=None,
    devices=None,
    model_parallel=1,
    _graphs=True,
    _perms=None,
    _one_card=False,
    **kwds,
):
    """Fit ``network`` (built) on ``adata``, on the network's device.
    Returns a History.

    The keywords are the JAX package's ``train``'s, in its order; unknown
    ones are accepted and ignored, as there.  ``compiled`` "auto" or False
    runs the Python-epoch loop, whose steps are jitted in the JAX package
    and replayed from CUDA graphs here (the JAX package's "auto" takes its
    whole-fit program only on a TPU); True runs the whole fit on the device
    (``_train_compiled``), except in ``debug`` mode and with
    ``checkpoint_every``/``resume``, which set it to False as in the JAX
    package, for a padded data-parallel split (as there, with a verbose
    line) and on the streaming trainer.  ``checkpoint_every``/``resume``
    with ``output_dir`` save and restore ``<output_dir>/checkpoints``,
    without it they do nothing.
    ``save_weights`` and ``tensorboard`` write ``weights.hdf5`` and ``tb/``
    under ``output_dir`` (see the module's docstring).  The size gate of the
    JAX package: an input of more than ``max_device_cells`` cells, or
    without it one whose input and target, n_cells * n_genes * 4 * 2
    bytes, exceed DCA_TPU_DEVICE_BYTES (default 6e9), takes the streaming
    trainer (``_train_streaming``, parts of ``max_device_cells`` cells,
    default 131072), under a process group too, where it raises
    ValueError for a batch smaller than the ranks.

    ``devices``/``model_parallel`` as the JAX package's: None for one
    device; ``"all"``, an int or a list for the ranks of the initialized
    process group (``parallel.mesh.resolve_mesh``; every rank calls
    ``train`` with the same data and seed), data parallel, or with
    ``model_parallel`` M > 1 over a grid of (ranks / M) x M, each rank
    holding its gene shard of the input kernel and the heads, in memory
    and on the streaming trainer; the network is whole again on every rank
    after the fit.  Without a group, more than one device (an int N, the
    first N CUDA devices; ``"all"``, every visible one; a list of them,
    the network's first; on the CPU N gloo ranks) starts a rank a device
    from this process, which is rank 0 and returns its History
    (``parallel/launch.py``, ``mesh.rank_devices``).

    On a CUDA device, outside ``debug``, with no process group or over
    NCCL, the steps are replayed from CUDA graphs captured at the start of
    the fit (``train/graphs.py::capture_steps``); ``_graphs=False``, for
    the tests, calls them from Python there too.
    ``_perms``, for the tests, an (epochs, n_train) array of row orders,
    replaces the ones a ``compiled=True`` fit draws.  ``_one_card``, for
    the tests and ``chip_smoke.py``: the ranks that ``devices`` starts all
    share the network's CUDA device, over gloo.  Every rank of a group
    posts its progress from the fit loop (``launch.post_progress``: each
    epoch ended, each eager step, each streamed part, each epoch of the
    whole-fit graph that the device completed): to the launcher's store
    on the ranks it starts, else to the group's own store
    (``launch.watching``); a rank that dies or falls silent ends every
    other rank's fit with ``launch.LaunchError`` naming it."""
    assert network.model is not None, "network.build() must be called before train()"
    ranks = rank_devices(devices, network.device, _one_card)
    if ranks is not None:
        from ..parallel.launch import launch_train

        args = locals()
        kwargs = {k: args[k] for k in inspect.signature(train).parameters
                  if k not in ("adata", "network", "kwds")}
        return launch_train(train, adata, network, {**kwargs, **kwds}, ranks)
    if checkpoint_every or resume or network.definition.debug:
        compiled = False  # as in the JAX package: the Python-epoch loop
    compiled = compiled != "auto" and bool(compiled)
    n_cells, n_genes = adata.n_obs, adata.n_vars
    if max_device_cells is not None:
        stream = n_cells > max_device_cells
    else:
        stream = n_cells * n_genes * 4 * 2 > int(os.environ.get("DCA_TPU_DEVICE_BYTES",
                                                                6_000_000_000))
    if threads:
        # the CPU path computes in torch; the host loops of the native tier
        # (text parse and format, row gathers) take the same cap, as the
        # JAX package's train() gives them
        torch.set_num_threads(threads)
        native.set_threads(threads)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    mesh = resolve_mesh(devices, model_parallel)
    opt = get_optimizer(optimizer, clipvalue=clip_grad)
    lr = float(learning_rate) if learning_rate is not None else opt.default_lr
    device = network.device
    verbose = verbose and is_primary()
    # TensorBoard: every rank computes the gradients (their sum is a
    # collective), the primary rank alone writes
    tb_dir = os.path.join(output_dir, "tb") if tensorboard and output_dir is not None else None
    tb = _TBLogger(tb_dir) if tb_dir is not None and is_primary() else None
    artefacts = dict(output_dir=output_dir, save_weights=save_weights,
                     checkpoint_every=checkpoint_every, resume=resume, tb_log=tb)
    try:
        with watching(mesh), _fit_trace(tb_dir if tb is not None else None, device) as trace:
            if stream:
                hist = _train_streaming(
                    adata, network, opt, lr, epochs=epochs, reduce_lr=reduce_lr,
                    early_stop=early_stop, batch_size=batch_size,
                    validation_split=validation_split, use_raw_as_output=use_raw_as_output,
                    output_subset=output_subset, seed=seed, verbose=verbose,
                    max_device_cells=max_device_cells or 131072, mesh=mesh,
                    graphs=_graphs, tb=tb_dir is not None, trace=trace, **artefacts)
            else:
                hist = _train_in_memory(
                    adata, network, opt, lr, mesh, epochs=epochs, reduce_lr=reduce_lr,
                    early_stop=early_stop, batch_size=batch_size,
                    validation_split=validation_split, use_raw_as_output=use_raw_as_output,
                    output_subset=output_subset, seed=seed, verbose=verbose, graphs=_graphs,
                    tb=tb_dir is not None, trace=trace, compiled=compiled, perms=_perms,
                    **artefacts)
            if network.mesh is not None:
                gather_params(network, network.mesh)
            return hist
    finally:
        if tb is not None:
            tb.close()


def _train_in_memory(adata, network, opt, lr, mesh, *, epochs, reduce_lr, early_stop,
                     batch_size, validation_split, use_raw_as_output, output_subset, seed,
                     verbose, graphs, output_dir, save_weights, checkpoint_every, resume, tb,
                     tb_log, trace=None, compiled=False, perms=None):
    """The fit of a split that the device holds (the JAX package's
    ``_train_inner``): see the module's docstring.  ``tb``: log to
    TensorBoard (``tb_log``, the primary rank's logger, or None on the
    other ranks); ``trace``: the fit's profiler (``_fit_trace``), stepped
    after each epoch; ``compiled``: the whole fit on the device
    (``_train_compiled``), with the row orders ``perms`` if given.
    ``mesh``: the ranks' grid (``parallel/mesh.py``), or None."""
    device = network.device
    group = None if mesh is None else mesh.world
    # ----- host arrays -----
    X = densify(adata.X)
    mean, std = scale_stats(adata)
    if mean is not None:
        # the deferred z-scale of normalize(lazy_scale=True)
        X = (X - mean) / std
    sf = size_factors(adata)
    if output_subset:
        gene_idx = [np.where(adata.raw.var_names == x)[0][0] for x in output_subset]
        target = adata.raw.X[:, gene_idx] if use_raw_as_output else X[:, gene_idx]
    else:
        target = adata.raw.X if use_raw_as_output else X
    target = densify(target)

    n = X.shape[0]
    split_at = int(n * (1.0 - validation_split))  # Keras tail split
    n_train, n_val = split_at, n - split_at
    has_val = n_val > 0
    bs = min(batch_size, max(n_train, 1))
    n_full = n_train // bs
    rem = n_train - n_full * bs

    if mesh is not None and mesh.n_model > 1:
        # this rank's gene columns of the input and of the target
        X = X[:, slice(*mesh.gene_block(X.shape[1]))]
        target = target[:, slice(*mesh.gene_block(target.shape[1]))]

    def dev(a):
        # np.array copies: the tensor owns writable memory, not a view of adata
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    X_tr, T_tr, sf_tr = dev(X[:split_at]), dev(target[:split_at]), dev(sf[:split_at])
    val_shard = w_val = None
    if has_val:
        X_val, T_val, sf_val = X[split_at:], target[split_at:], sf[split_at:]
        if mesh is not None:
            # one block per data index, padded to a multiple of them with
            # copies of row 0 at weight 0
            pad = (-n_val) % mesh.n_data
            w = np.ones((n_val + pad,), np.float32)
            w[n_val:] = 0.0
            X_val, T_val, sf_val, w = shard_train_data(
                mesh, *(_pad_rows(a, pad) for a in (X_val, T_val, sf_val)), w)
            w_val = dev(w) if pad else None
            val_shard = batch_shard(mesh, n_val + pad)
        X_val, T_val, sf_val = dev(X_val), dev(T_val), dev(sf_val)

    if mesh is not None:
        place_train_state(network, mesh)
    params = list(network.model.parameters())
    opt_state = opt.init(params)
    generator = torch.Generator(device=device).manual_seed(seed)
    if compiled and mesh is not None:
        if n_train % mesh.n_data or (has_val and n_val % mesh.n_data):
            # as the JAX package: its one-program fit has no weighted
            # validation
            compiled = False
            if verbose:
                print("dca_tpu_torch: padded multi-process split -> python-epoch fit")
    if compiled:
        if perms is None:
            rng_np = np.random.RandomState(seed)
            perms = np.array([rng_np.permutation(n_train) for _ in range(epochs)],
                             dtype=np.int64).reshape(epochs, n_train)
        return _train_compiled(
            network, opt, lr, mesh, (X_tr, T_tr, sf_tr),
            (X_val, T_val, sf_val) if has_val else None, val_shard, perms, opt_state,
            generator, n_train=n_train, batch_size=bs, epochs=epochs, reduce_lr=reduce_lr,
            early_stop=early_stop, save_weights=save_weights, output_dir=output_dir,
            verbose=verbose, graphs=graphs, tb=tb, tb_log=tb_log, trace=trace)
    bufs = StepBuffers.create(n_train, bs, lr, device)
    train_step = make_sharded_train_step(network, opt, mesh)

    def step(trailing=False):
        train_step(X_tr, T_tr, sf_tr, bufs, opt_state, generator, trailing)

    def tb_grads():
        """The gradients on the validation split (its padded block and
        weights under a process group), or without one on the train split
        (this rank's block of it)."""
        if has_val:
            return _tb_grads(network, X_val, sf_val, T_val, w_val, val_shard)
        if mesh is None:
            return _tb_grads(network, X_tr, sf_tr, T_tr)
        shard = batch_shard(mesh, n_train)
        rows = slice(shard.lo, shard.hi)
        return _tb_grads(network, X_tr[rows], sf_tr[rows], T_tr[rows], shard=shard)

    rng_np = np.random.RandomState(seed)
    hist = History()
    cbs = _FitCallbacks(lr, reduce_lr, early_stop, save_weights, output_dir, network, verbose,
                        "val_loss" if has_val else "loss", hist)
    # a resumed state is in place before the graphs capture the steps on it
    ckpts, start_epoch = _start_fit(output_dir, checkpoint_every, resume, network, opt_state,
                                    generator, cbs, seed, hist, rng_np, n_train, verbose)
    if epochs > start_epoch and capture_steps(device, _backend(group),
                                              network.definition.debug, graphs):
        written = params + list(network.model.buffers()) + state_tensors(opt_state)
        run_epoch = GraphEpoch(step, bufs, rem, written, generator)
        hist.capture_s = run_epoch.capture_s
    else:
        run_epoch = EagerEpoch(step, bufs, rem)

    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        bufs.lr.fill_(cbs.lr)
        run_epoch(rng_np.permutation(n_train))

        with torch.no_grad():
            sums = [bufs.losses[:n_full].sum(), bufs.losses[n_full]]
            if has_val:
                sums.append(network.loss_fn(X_val, sf_val, T_val, False, sample_weights=w_val,
                                            shard=val_shard)[0])
            sums = torch.stack(sums)
            if group is not None:
                # each rank's losses are its shares: their sums are the means
                dist.all_reduce(sums, group=group)
            sums = sums.tolist()  # the epoch's one read-back
        hist.epoch_s.append(time.perf_counter() - t0)
        train_loss = (sums[0] * bs + sums[1] * rem) / max(n_train, 1)
        hist.append("loss", train_loss)
        hist.append("lr", cbs.lr)
        val_loss = None
        if has_val:
            val_loss = sums[2]
            hist.append("val_loss", val_loss)
            monitor = val_loss
        else:
            monitor = train_loss

        if verbose:
            msg = f"Epoch {epoch + 1}/{epochs} - loss: {train_loss:.4f}"
            if has_val:
                msg += f" - val_loss: {val_loss:.4f}"
            print(msg + f" - lr: {cbs.lr:.2e}")

        if tb:
            t_tb = time.perf_counter()
            grads = tb_grads()
            weights = network.whole_named(flatten_tree(network.trees()[0]))
            terms = None
            if network.definition.debug and has_val:
                terms = _loss_terms(network, X_val, sf_val, T_val, val_shard)
                if terms is not None and mesh is not None:
                    terms = [_gather_terms(t, mesh, n_val, network.definition.output_size)
                             for t in terms]
            if tb_log is not None:
                tb_log.epoch(epoch, {"loss": train_loss, "lr": cbs.lr, "val_loss": val_loss},
                             weights, grads)
                if terms is not None:
                    tb_log.loss_terms(epoch, *terms)
            hist.tb_s.append(time.perf_counter() - t_tb)

        stop = cbs.end_epoch(epoch, monitor)
        if ckpts is not None:
            ckpts.after_epoch(epoch, epochs, stop)
        if trace is not None:
            trace.step()
        if stop:
            break
    return hist


def _train_compiled(network, opt, lr, mesh, train_split, val, val_shard, perms, opt_state,
                    generator, *, n_train, batch_size, epochs, reduce_lr, early_stop,
                    save_weights, output_dir, verbose, graphs, tb, tb_log, trace):
    """The whole fit on the device (``train/compiled.py``), then what the
    JAX package's ``_train_compiled`` does after its one read-back: the
    History of the epochs run, their verbose lines, the TensorBoard scalars
    of each epoch and, at the last, the histograms of the final parameters
    and of their eval-mode gradient on the validation split, and with
    ``save_weights`` the best state written once to ``weights.hdf5``, the
    network keeping the final one."""
    from .compiled import build_fit_fn

    has_val = val is not None
    track_best = bool(save_weights and output_dir is not None)
    graphs = capture_steps(network.device, _backend(None if mesh is None else mesh.world),
                           network.definition.debug, graphs)
    fit = build_fit_fn(network, opt, n_train=n_train, batch_size=batch_size, epochs=epochs,
                       has_val=has_val, reduce_lr=reduce_lr, early_stop=early_stop,
                       track_best=track_best, mesh=mesh)
    res = fit(*train_split, val, lr, perms, opt_state, generator, graphs=graphs,
              after_epoch=trace.step if trace is not None else None, val_shard=val_shard)
    hist = History()
    hist.fit, hist.capture_s, hist.epoch_s = res, res.capture_s, res.epoch_s
    for e in range(res.epochs_run):
        hist.append("loss", res.loss[e])
        hist.append("lr", res.lr[e])
        if has_val:
            hist.append("val_loss", res.val_loss[e])
        if verbose:
            msg = f"Epoch {e + 1}/{epochs} - loss: {res.loss[e]:.4f}"
            if has_val:
                msg += f" - val_loss: {res.val_loss[e]:.4f}"
            print(msg + f" - lr: {res.lr[e]:.2e}")
        if tb_log is not None:
            tb_log.epoch(e, {"loss": res.loss[e], "lr": res.lr[e],
                             "val_loss": res.val_loss[e] if has_val else None}, {}, {})
    if tb and res.epochs_run > 0:
        # the final parameters, and their gradient on the validation split
        # (a collective under a group: every rank takes part)
        t_tb = time.perf_counter()
        grads = {}
        if has_val:
            grads = _tb_grads(network, val[0], val[2], val[1], shard=val_shard)
        weights = network.whole_named(flatten_tree(network.trees()[0]))
        if tb_log is not None:
            tb_log.epoch(res.epochs_run - 1, {}, weights, grads)
        hist.tb_s.append(time.perf_counter() - t_tb)
    if track_best:
        t0 = time.perf_counter()
        live = list(network.model.parameters()) + list(network.model.buffers())
        with torch.no_grad():
            final = [t.detach().clone() for t in live]
            for t, b in zip(live, res.best):
                t.copy_(b)
            try:
                network.save_weights(os.path.join(output_dir, "weights.hdf5"))
            finally:
                for t, f in zip(live, final):
                    t.copy_(f)
        hist.weights_s.append(time.perf_counter() - t0)
    return hist


def _gather_terms(t, mesh, n, width):
    """The whole (n, ``width``) matrix of the ranks' blocks ``t``: the
    model group's gene columns side by side where they shard ``width``,
    then the first ``n`` rows of the data group's equal blocks, in rank
    order."""
    if mesh.shards(width):
        t = gather_tensor(t, 1, mesh)
    blocks = [torch.empty_like(t) for _ in range(mesh.n_data)]
    dist.all_gather(blocks, t.contiguous(), group=mesh.data)
    return torch.cat(blocks)[:n]


# ---------------------------------------------------------------------------
# the streaming trainer
# ---------------------------------------------------------------------------


def _derivable_row_scale(Xn, raw):
    """Per-row multiplier ``m`` with ``Xn == log1p(raw * m)`` elementwise,
    or None when the normalized input is not derivable from the raw target
    that way (another pattern, a subset target, other normalize flags, ...).

    The multiplier is recovered from the first nonzero of each row and
    verified on a random sample of entries, so any "per-row scale, then
    log1p" pipeline qualifies and anything else falls back to shipping both
    payloads.  A copy of the JAX package's."""
    if Xn is raw:
        return None
    if not (sp.isspmatrix_csr(Xn) and sp.isspmatrix_csr(raw)):
        return None
    if Xn.shape != raw.shape or Xn.nnz != raw.nnz or Xn.nnz == 0:
        return None
    canonicalize_csr(Xn)
    canonicalize_csr(raw)
    if not (np.array_equal(Xn.indptr, raw.indptr)
            and np.array_equal(Xn.indices, raw.indices)):
        return None
    lens = np.diff(Xn.indptr)
    nonempty = lens > 0
    first = Xn.indptr[:-1][nonempty]
    with np.errstate(divide="ignore", invalid="ignore"):
        m = np.ones(Xn.shape[0], np.float64)
        m[nonempty] = np.expm1(Xn.data[first].astype(np.float64)) / raw.data[first]
    if not np.all(np.isfinite(m)) or np.any(m <= 0):
        return None
    k = min(50000, Xn.nnz)
    sel = np.random.RandomState(0).randint(0, Xn.nnz, k)
    rows_of = np.searchsorted(Xn.indptr, sel, side="right") - 1
    recon = np.log1p(raw.data[sel].astype(np.float64) * m[rows_of])
    if not np.allclose(recon, Xn.data[sel], rtol=1e-5, atol=1e-6):
        return None
    return m.astype(np.float32)


class _StreamTimeline:
    """Opt-in (``DCA_TPU_TIMELINE=<path>``) event log of streaming epochs,
    one JSON line per (epoch, part, stage) with absolute perf_counter
    stamps, so that an epoch's stages add up to its wall time (the JAX
    package's format; ``scripts/timeline_report.py`` summarizes it).
    Stages:

      prep      host payload build or densify      (prefetch thread)
      ship      upload and device scatter enqueued (prefetch thread)
      wait      main thread blocked on the staged part
      dispatch  main thread enqueueing the part's steps or evaluation
      fetch     the epoch's one read-back of its losses
      epoch     the whole epoch
      device    on a CUDA device: the main stream's time from the part's
                first to its last operation (CUDA events; t0 is the
                dispatch's start, t1 = t0 + dur)
      stage     on a CUDA device: the staging stream's time for the part's
                writes, likewise

    Σ device / epoch is the main stream's busy share of the epoch."""

    def __init__(self, path, cuda):
        self.path = path
        self.cuda = cuda
        self.events = []
        self.pending = []  # (part, kind, stage, t0, start event, end event)
        self.epoch = -1

    def rec(self, part, kind, stage, t0, t1):
        self.events.append((self.epoch, part, kind, stage, t0, t1))

    def start_event(self):
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def device_span(self, part, kind, stage, t0, start):
        """Close the span opened by ``start_event`` on the current stream."""
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.pending.append((self.epoch, part, kind, stage, t0, start, end))

    def flush(self):
        import json

        for e, part, kind, stage, t0, start, end in self.pending:
            dur = start.elapsed_time(end) / 1e3
            self.events.append((e, part, kind, stage, t0, t0 + dur))
        self.pending = []
        with open(self.path, "a") as f:
            for e, part, kind, stage, t0, t1 in self.events:
                f.write(json.dumps(dict(
                    epoch=e, part=part, kind=kind, stage=stage,
                    t0=round(t0, 4), t1=round(t1, 4),
                    dur=round(t1 - t0, 6))) + "\n")
        self.events = []


class _PartSlot:
    """One of the streaming trainer's two part buffers: x, t and sf of up
    to ``rows`` cells at fixed addresses, which the captured steps read.
    ``x_flat``/``t_flat`` hold one spare last element that takes the device
    scatters' padding (``ops/densify.py``).  The rows are staged whole;
    ``x``/``t`` are the columns ``cols_in``/``cols_out`` ([lo, hi)) of
    them that the step reads, a model-parallel rank's gene block, all of
    them by default.

    Hand-over: the staging side takes ``free`` (released by the main
    thread once it has enqueued the part's last reader) and, on a CUDA
    device, makes its stream wait for ``done`` (recorded after that
    reader) before it writes, and records ``ready`` after; the main stream
    waits for ``ready`` before the part's first step.  So a replay never
    reads a part still being written, and no part is overwritten while a
    replay still reads it."""

    def __init__(self, rows, g_in, g_out, device, cols_in=None, cols_out=None):
        self.x_flat = torch.zeros(rows * g_in + 1, device=device)
        self.t_flat = torch.zeros(rows * g_out + 1, device=device)
        self.sf = torch.ones(rows, device=device)
        self.x = self.x_flat[:rows * g_in].view(rows, g_in)[:, slice(*(cols_in or (0, g_in)))]
        self.t = self.t_flat[:rows * g_out].view(rows, g_out)[:, slice(*(cols_out or (0, g_out)))]
        self.free = threading.Semaphore(1)
        self.cuda = device.type == "cuda"
        self.ready = None
        self.done = torch.cuda.Event() if self.cuda else None

    def head(self, k):
        """(x, sf, t) of the first ``k`` staged rows, x and t contiguous
        (a gene block is copied out of the whole rows)."""
        return self.x[:k].contiguous(), self.sf[:k], self.t[:k].contiguous()


class _Task(NamedTuple):
    """One part of a streamed epoch: its ``kind`` ("full", "rem" or
    "val"), its StreamingData ``sd``, its ``n`` rows over every rank and
    ``rows``, those this rank stages."""
    kind: str
    sd: StreamingData
    n: int
    rows: np.ndarray


def _stream_tasks(tr, va, perm, bs, data_index=0, n_data=1):
    """An epoch's staging schedule: the train parts, the full batches of
    each chunk apart from its trailing rows, then the validation chunks.
    Data index ``data_index`` of ``n_data`` stages its block of each batch of a
    train part (``parallel.step.part_rows``), of the trailing batch too,
    where its share may be empty; a validation chunk is padded to a
    multiple of the data indices with copies of its first row (weight 0,
    ``_val_weights``) and each stages its block.  One data index stages
    every row."""
    tasks = []
    for idx in tr.index_chunks(perm):
        nb = len(idx) // bs
        if nb > 0:
            full = idx[:nb * bs]
            tasks.append(_Task("full", tr, len(full), part_rows(full, bs, data_index, n_data)))
        if len(idx) > nb * bs:
            trail = idx[nb * bs:]
            tasks.append(_Task("rem", tr, len(trail),
                               part_rows(trail, len(trail), data_index, n_data)))
    if va is not None:
        for idx in va.index_chunks(np.arange(va.n)):
            padded = _pad_rows(idx, (-len(idx)) % n_data)
            tasks.append(_Task("val", va, len(idx),
                               part_rows(padded, len(padded), data_index, n_data)))
    return tasks


def _val_weights(n, data_index, n_data):
    """Data index ``data_index``'s sample weights of a validation chunk of
    ``n`` rows padded to a multiple of the ``n_data`` data indices (1, and 0 on
    the padding), or None where the chunk needs no padding."""
    pad = (-n) % n_data
    if pad == 0:
        return None
    w = np.ones(n + pad, np.float32)
    w[n:] = 0.0
    return part_rows(w, n + pad, data_index, n_data)


def _train_streaming(adata, network, opt, lr, *, epochs, reduce_lr, early_stop, batch_size,
                     validation_split, use_raw_as_output, output_subset, seed, verbose,
                     max_device_cells, mesh=None, graphs=True, output_dir=None,
                     save_weights=False, checkpoint_every=0, resume=False, tb=False,
                     tb_log=None, trace=None):
    """The fit for inputs larger than the device (the JAX package's
    ``_train_streaming``).  The count matrix stays on the host, sparse as
    it came; each epoch, shuffled parts of ``chunk`` cells (a multiple of
    the batch) are staged into one of two part buffers while the steps run
    on the other.

    ``chunk`` is a multiple of the batch, so the epoch's full batches are
    exactly those of the in-memory fit under the same permutation, and its
    trailing step holds the same ``n_train mod batch`` rows.  So the step
    is the in-memory fit's (``parallel/step.py``): ``StepBuffers`` hold a
    fixed map from the epoch's step to its rows' places in the part buffer
    and one epoch-long loss buffer, and the step counter runs over the
    whole epoch.  On one CUDA device outside ``debug`` (and unless
    ``graphs`` is False) the full and the trailing step on each part
    buffer are CUDA graphs captured once a fit and replayed
    (``train/graphs.py::GraphSteps``), the counterpart of the JAX package's
    ``chunk_fn``/``rem_fn``; on the CPU and in ``debug`` they run eagerly.
    The validation chunks are evaluated unweighted through
    ``network.loss_fn``; every loss stays on the device until the epoch's
    one read-back.

    Over a ``mesh`` of ranks (the JAX package's multi-process staging, one
    process per device; ``parallel/mesh.py``) every rank draws the same
    permutation, and stages, materializes and uploads only the rows it
    computes on: its data index's block of each batch of each part
    (``_stream_tasks``), into part buffers sized for its share, so
    ``max_device_cells`` still counts the cells of a part and every part's
    batches are the single-process fit's.  With a model axis the M ranks
    of a data index stage the same rows, whole as the JAX package stages
    them (``P('data', None)``), and each steps on its gene block of the
    input's and the target's columns (``Mesh.gene_block``, views of the
    part buffer), holding its gene shard of the network
    (``place_train_state``); the fit gathers the network whole after it.
    Its ``StepBuffers.perm`` places its block of each batch in its buffer
    (``parallel/step.py::stream_places``), and the data-parallel step sums
    BatchNorm's statistics, the loss pair and the gradients over the
    global batch, whose dropout mask each rank draws whole and slices.
    The trailing batch is split the same way, a rank's share possibly
    empty; the JAX package stages it whole on every process, because its
    one program partitions the rows itself, where each rank here computes
    its own block.  A validation chunk is padded to a multiple of the
    data indices with copies of its first row at weight 0 and each rank
    evaluates its block through the weighted loss (K1w on a card),
    unweighted (K1) where the chunk divides them; the losses are summed
    over the ranks once an epoch, in its one read-back.  The steps are
    replayed from CUDA graphs over NCCL and run eagerly over gloo, as the
    in-memory data-parallel fit's (``graphs.capture_steps``); the prefetch
    thread stages and uploads, which takes no collective, and the main
    thread alone issues the collectives and the replays, in the same order
    on every rank.  Tiers as in the JAX package: the host
    densify, or the device densify with padded payloads; no derived input
    and no resident corpus.

    Staging tiers, as in the JAX package:
      * host: parts densified on the host (``native.densify_rows``, the
        deferred z-scale applied there) and copied whole;
      * device densify (DCA_TPU_DEVICE_DENSIFY, ``config.use_device_densify``):
        payloads (padded, flat or flat8, ``data/loader.py``) scattered dense
        on the device with the z-scale fused; input and target share the
        index stream when they share the pattern;
      * derived input: when the normalized input is log1p of a per-row
        multiple of the raw target (``_derivable_row_scale``, on both
        splits or neither) only the target crosses and the input is derived
        on the device (DCA_TPU_DERIVE_INPUT=0 turns it off);
      * resident (``ops/resident.py``): with the derived input, the target
        corpus is uploaded once and every part is gathered on the device;
        DCA_TPU_RESIDENT=1/0 forces it, 'auto' engages it when the payload
        is within DCA_TPU_RESIDENT_MIN_BYTES .. DCA_TPU_RESIDENT_BYTES and a
        part's transient (``resident.PART_BYTES_PER_SLOT`` a padded slot)
        within DCA_TPU_RESIDENT_PART_BYTES.
    A prefetch thread stages DCA_TPU_PREFETCH parts ahead (default 1; 0
    stages on the main thread), on a side stream on a CUDA device; the
    resident tier stages on the main thread, at most
    DCA_TPU_RESIDENT_AHEAD parts (default 1) ahead of the device.

    Checkpoints, ``weights.hdf5`` and TensorBoard as in the in-memory fit;
    the TensorBoard gradients are taken on the first validation chunk, or
    without a split on the last staged train part, as in the JAX package,
    while the part is in its buffer: after its last step or its loss and
    before the buffer is handed back to the staging; under a group on this
    rank's block (with its weights), summed over the ranks, and with the
    weights' histograms gathered whole over the model axis.  ``tb``: take
    them (on every rank; ``tb_log``, the primary rank's logger, writes)."""
    device = network.device
    cuda = device.type == "cuda"
    X = adata.X
    sf = size_factors(adata)
    if output_subset:
        gene_idx = [np.where(adata.raw.var_names == x)[0][0] for x in output_subset]
        target = adata.raw.X[:, gene_idx] if use_raw_as_output else X[:, gene_idx]
    else:
        target = adata.raw.X if use_raw_as_output else X
    scale_mean, scale_std = scale_stats(adata)
    mean_d = std_d = None
    if scale_mean is not None:
        mean_d = torch.from_numpy(scale_mean).to(device)
        std_d = torch.from_numpy(scale_std).to(device)

    n = X.shape[0]
    split_at = int(n * (1.0 - validation_split))
    bs = min(batch_size, max(split_at, 1))
    chunk = max((min(max_device_cells, split_at) // bs) * bs, bs)
    dev_densify = use_device_densify(device)
    group = None if mesh is None else mesh.world
    # the rows go by data index: the M ranks of one stage the same rows
    data_index, n_data = (0, 1) if mesh is None else (mesh.data_index, mesh.n_data)
    if n_data > bs:
        raise ValueError(f"streaming under a process group needs batch_size >= the number of "
                         f"ranks on the data axis ({n_data}); got batch_size {bs}: data "
                         "parallelism needs at least one row per rank per batch")
    # a rank stages (B, K) slabs of its own rows: the padded payload
    pmode = "padded" if group is not None else "auto"

    X_tr, X_va = X[:split_at], X[split_at:]
    T_tr, T_va = target[:split_at], target[split_at:]
    m_tr = m_va = None
    if (dev_densify and group is None and scale_mean is not None
            and os.environ.get("DCA_TPU_DERIVE_INPUT", "1") != "0"):
        m_tr = _derivable_row_scale(X_tr, T_tr)
        if m_tr is not None and split_at < n:
            m_va = _derivable_row_scale(X_va, T_va)
            if m_va is None:
                m_tr = None  # both splits or neither

    tr = StreamingData(X_tr, T_tr, sf[:split_at], chunk, scale_mean, scale_std,
                       device_densify=dev_densify, payload_mode=pmode,
                       derive_input=m_tr is not None)
    tr.derive_m = m_tr
    has_val = split_at < n
    va = None
    if has_val:
        va = StreamingData(X_va, T_va, sf[split_at:], chunk, scale_mean, scale_std,
                           device_densify=dev_densify, payload_mode=pmode,
                           derive_input=m_va is not None)
        va.derive_m = m_va
    n_train = split_at
    g_in, g_out = X.shape[1], target.shape[1]

    resident = None
    if m_tr is not None and sp.isspmatrix_csr(target):
        rmode = os.environ.get("DCA_TPU_RESIDENT", "auto")
        rlo = int(os.environ.get("DCA_TPU_RESIDENT_MIN_BYTES", 64_000_000))
        rhi = int(os.environ.get("DCA_TPU_RESIDENT_BYTES", 4_000_000_000))
        rest = ResidentCSR.payload_bytes(target)
        # a part's transient grows with K (the widest row), so one heavy
        # row can blow a part past the device on a wide panel even when
        # the payload is small: auto declines those (force with
        # DCA_TPU_RESIDENT=1 after shrinking max_device_cells)
        kmax = int(np.diff(target.indptr).max()) if target.shape[0] else 0
        part_b = int(os.environ.get("DCA_TPU_RESIDENT_PART_BYTES", 6_000_000_000))
        auto_ok = rlo <= rest <= rhi and chunk * kmax * PART_BYTES_PER_SLOT <= part_b
        if rmode == "1" or (rmode != "0" and auto_ok):
            m_full = np.concatenate([m_tr, m_va]) if has_val else m_tr
            resident = ResidentCSR(target, m_full, sf, scale_mean, scale_std, device)
            if verbose:
                print(f"dca_tpu_torch: corpus resident on device "
                      f"({rest / 1e6:.0f} MB payload) [streaming]")

    # ----- the step, on two part buffers -----
    if group is not None:
        place_train_state(network, mesh)
    params = list(network.model.parameters())
    opt_state = opt.init(params)
    generator = torch.Generator(device=device).manual_seed(seed)
    bufs = StepBuffers.create(n_train, bs, lr, device)
    n_full = bufs.n_full
    rem = n_train - n_full * bs
    bufs.perm.copy_(torch.from_numpy(stream_places(n_train, bs, chunk, data_index, n_data)))
    # the epoch's schedule, but for the row orders, is the same every
    # epoch: the buffers take this rank's largest part, and each (part
    # buffer, kind) it uses is captured once
    schedule = _stream_tasks(tr, va, np.arange(n_train), bs, data_index, n_data)
    cols = (None, None) if mesh is None else (mesh.gene_block(g_in), mesh.gene_block(g_out))
    slots = [_PartSlot(max(len(t.rows) for t in schedule), g_in, g_out, device, *cols)
             for _ in range(2)]
    train_step = make_sharded_train_step(network, opt, mesh)
    kinds = {(i % 2, t.kind == "rem") for i, t in enumerate(schedule) if t.kind != "val"}
    steps = {key: functools.partial(train_step, slots[key[0]].x, slots[key[0]].t,
                                    slots[key[0]].sf, bufs, opt_state, generator, key[1])
             for key in sorted(kinds)}
    hist = History()
    rng_np = np.random.RandomState(seed)
    cbs = _FitCallbacks(lr, reduce_lr, early_stop, save_weights, output_dir, network, verbose,
                        "val_loss" if has_val else "loss", hist)
    ckpts, start_epoch = _start_fit(output_dir, checkpoint_every, resume, network, opt_state,
                                    generator, cbs, seed, hist, rng_np, n_train, verbose,
                                    " [streaming]")
    if epochs > start_epoch and capture_steps(device, _backend(group),
                                              network.definition.debug, graphs):
        written = params + list(network.model.buffers()) + state_tensors(opt_state)
        runner = GraphSteps(steps, written + [bufs.step_i, bufs.losses], generator, device)
        hist.capture_s = runner.capture_s
        run = runner.replay
    else:
        def run(key, times=1):
            for _ in range(times):
                steps[key]()

    # ----- staging -----
    stage_stream = torch.cuda.Stream(device) if cuda else None
    if cuda:
        stage_stream.wait_stream(torch.cuda.current_stream(device))
    tl_path = os.environ.get("DCA_TPU_TIMELINE")
    tl = _StreamTimeline(tl_path, cuda) if tl_path else None
    closing = threading.Event()

    def to_device(c, out, mean=None, std=None):
        """Part ``c`` (a payload or dense rows) dense in ``out``, z-scaled
        on the device when given ``mean`` and ``std``."""
        if isinstance(c, SparseChunk):
            return device_densify(c.idx, c.dat, c.n_cols, mean, std, out=out)
        if isinstance(c, Flat8Chunk):
            return device_densify_flat8(c, mean, std, out=out)
        if isinstance(c, FlatChunk):
            return device_densify_flat(c.counts, c.col, c.val, c.n_rows, c.n_cols, mean, std,
                                       out=out)
        B, G = c.shape
        dense = out[:B * G].view(B, G)
        dense.copy_(torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32)),
                    non_blocking=True)
        return dense

    def write_part(slot, xc, tc, sfc, m_part):
        if m_part is not None and xc is tc:
            # one payload: densify the target, derive the input from it
            t = to_device(tc, slot.t_flat)
            derive_input(t, upload(m_part, device), mean_d, std_d,
                         slot.x_flat[:t.numel()].view(t.shape))
        elif (isinstance(xc, FlatChunk) and isinstance(tc, FlatChunk)
              and xc.counts is tc.counts and xc.col is tc.col):
            # a shared pattern: its index stream crosses once
            cnt, col = upload(xc.counts, device), upload(xc.col, device)
            device_densify_flat(cnt, col, xc.val, xc.n_rows, xc.n_cols, mean_d, std_d,
                                out=slot.x_flat)
            device_densify_flat(cnt, col, tc.val, tc.n_rows, tc.n_cols, out=slot.t_flat)
        elif (isinstance(xc, SparseChunk) and isinstance(tc, SparseChunk)
              and xc.idx is tc.idx):
            idx = upload(xc.idx, device)
            device_densify(idx, xc.dat, xc.n_cols, mean_d, std_d, out=slot.x_flat)
            device_densify(idx, tc.dat, tc.n_cols, out=slot.t_flat)
        else:
            # a dense part comes z-scaled from the loader, a payload is
            # scaled on the device
            scale = (None, None) if isinstance(xc, np.ndarray) else (mean_d, std_d)
            to_device(xc, slot.x_flat, *scale)
            to_device(tc, slot.t_flat)
        slot.sf[:len(sfc)].copy_(torch.from_numpy(np.ascontiguousarray(sfc, np.float32)),
                                 non_blocking=True)

    def stage(pi, kind, slot, write):
        """Write a part into ``slot`` once it is free (nothing when the fit
        is being torn down)."""
        slot.free.acquire()
        if closing.is_set():
            slot.free.release()
            return
        if not cuda:
            write()
            return
        t0 = time.perf_counter()
        with torch.cuda.stream(stage_stream):
            stage_stream.wait_event(slot.done)
            start = tl.start_event() if tl is not None else None
            write()
            if tl is not None:
                tl.device_span(pi, kind, "stage", t0, start)
            slot.ready = torch.cuda.Event()
            slot.ready.record(stage_stream)

    def prepare(sd, rows):
        if len(rows) == 0:
            return None  # an empty share of the trailing batch
        m = getattr(sd, "derive_m", None)
        return sd.materialize(rows), (m[rows] if m is not None else None)

    def ship(pi, kind, slot, prep):
        if prep is None:
            stage(pi, kind, slot, lambda: None)
            return
        (xc, tc, sfc), m_part = prep
        stage(pi, kind, slot, lambda: write_part(slot, xc, tc, sfc, m_part))

    pf = os.environ.get("DCA_TPU_PREFETCH", "1")
    depth = max(int(pf) if pf.isdigit() else 1, 0)
    if resident is not None:
        depth = 0  # no host staging to hide
    pool = ThreadPoolExecutor(max_workers=1) if depth > 0 else None

    def staged(tasks):
        """Yield each task's slot once its part is staged (on the
        prefetch thread, ``depth`` parts ahead, when there is one)."""
        if resident is not None:
            ahead = max(int(os.environ.get("DCA_TPU_RESIDENT_AHEAD", "1")), 0)
            window = []
            for pi, (kind, sd, _, idx) in enumerate(tasks):
                slot = slots[pi % 2]
                t0 = time.perf_counter()
                if cuda and ahead and len(window) >= ahead:
                    window.pop(0).synchronize()
                rows = idx if sd is tr else np.asarray(idx) + split_at
                stage(pi, kind, slot, lambda: resident.part(rows, slot.x_flat, slot.t_flat,
                                                            slot.sf))
                if cuda and ahead:
                    window.append(slot.ready)
                if tl is not None:
                    tl.rec(pi, kind, "wait", t0, time.perf_counter())
                yield slot
            return
        if pool is None:
            for pi, (kind, sd, _, rows) in enumerate(tasks):
                t0 = time.perf_counter()
                ship(pi, kind, slots[pi % 2], prepare(sd, rows))
                if tl is not None:
                    tl.rec(pi, kind, "wait", t0, time.perf_counter())
                yield slots[pi % 2]
            return

        def work(pi, kind, sd, rows):
            t0 = time.perf_counter()
            p = prepare(sd, rows)
            t1 = time.perf_counter()
            ship(pi, kind, slots[pi % 2], p)
            if tl is not None:
                tl.rec(pi, kind, "prep", t0, t1)
                tl.rec(pi, kind, "ship", t1, time.perf_counter())

        pending = deque()
        for pi, (kind, sd, _, rows) in enumerate(tasks):
            pending.append((pi, kind, pool.submit(work, pi, kind, sd, rows)))
            while len(pending) > depth:
                yield _take(pending)
        while pending:
            yield _take(pending)

    def _take(pending):
        ppi, pkind, fut = pending.popleft()
        t0 = time.perf_counter()
        fut.result()
        if tl is not None:
            tl.rec(ppi, pkind, "wait", t0, time.perf_counter())
        return slots[ppi % 2]

    # the validation chunks' weights on the device, by part: the same
    # every epoch
    val_w = {pi: torch.from_numpy(_val_weights(t.n, data_index, n_data)).to(device)
             for pi, t in enumerate(schedule) if t.kind == "val" and t.n % n_data}
    try:
        for epoch in range(start_epoch, epochs):
            t_ep = time.perf_counter()
            perm = rng_np.permutation(n_train)
            bufs.lr.fill_(cbs.lr)
            bufs.step_i.zero_()
            tasks = _stream_tasks(tr, va, perm, bs, data_index, n_data)
            if tl is not None:
                tl.epoch = epoch
            val_losses, val_rows = [], []
            grads = None
            # the part whose rows the TensorBoard gradients are taken on:
            # the first validation chunk, or the last train part
            n_parts = sum(t.kind != "val" for t in tasks)
            grad_part = (n_parts if has_val else n_parts - 1) if tb else -1
            for pi, ((kind, _, n_rows, rows), slot) in enumerate(zip(tasks, staged(tasks))):
                t0 = time.perf_counter()
                if cuda:
                    torch.cuda.current_stream(device).wait_event(slot.ready)
                start = tl.start_event() if tl is not None else None
                k, w, shard = len(rows), val_w.get(pi), None
                if group is not None:
                    shard = (batch_shard(mesh, k * n_data) if kind == "val"
                             else held_shard(mesh, n_rows, k))
                if kind == "full":
                    run((pi % 2, False), n_rows // bs)
                elif kind == "rem":
                    run((pi % 2, True))
                else:
                    with torch.no_grad():
                        loss, _ = network.loss_fn(*slot.head(k), False, sample_weights=w,
                                                  shard=shard)
                    val_losses.append(loss.detach().reshape(1))
                    val_rows.append(n_rows)
                if pi == grad_part:
                    grads = _tb_grads(network, *slot.head(k), w, shard)
                if tl is not None:
                    tl.device_span(pi, kind, "device", t0, start)
                if cuda:
                    slot.done.record()
                slot.free.release()
                if tl is not None:
                    tl.rec(pi, kind, "dispatch", t0, time.perf_counter())
                post_progress()

            t0 = time.perf_counter()
            with torch.no_grad():
                sums = torch.cat([bufs.losses[:n_full].sum().view(1),
                                  bufs.losses[n_full:]] + val_losses)
                if group is not None:
                    # each rank's losses are its shares: their sums are the means
                    dist.all_reduce(sums, group=group)
                sums = sums.tolist()  # the epoch's one read-back
            hist.epoch_s.append(time.perf_counter() - t_ep)
            if tl is not None:
                now = time.perf_counter()
                tl.rec(-1, "", "fetch", t0, now)
                tl.rec(-1, "", "epoch", t_ep, now)
                tl.flush()
            # the in-memory fit's arithmetic, so the same steps give the
            # same history
            train_loss = (sums[0] * bs + sums[1] * rem) / max(n_train, 1)
            hist.append("loss", train_loss)
            hist.append("lr", cbs.lr)
            if has_val:
                # each chunk's mean, weighted by its rows; one chunk gives
                # its loss exactly
                val_loss = sum(v * k for v, k in zip(sums[2:], val_rows)) / max(sum(val_rows), 1)
                hist.append("val_loss", val_loss)
                monitor = val_loss
            else:
                monitor = train_loss
            if verbose:
                msg = f"Epoch {epoch + 1}/{epochs} - loss: {train_loss:.4f}"
                if has_val:
                    msg += f" - val_loss: {val_loss:.4f}"
                print(msg + f" - lr: {cbs.lr:.2e} [streaming]")
            if tb:
                t_tb = time.perf_counter()
                # whole over the model axis: a collective every rank calls
                weights = network.whole_named(flatten_tree(network.trees()[0]))
                if tb_log is not None:
                    tb_log.epoch(epoch, {"loss": train_loss, "lr": cbs.lr,
                                         "val_loss": val_loss if has_val else None},
                                 weights, grads or {})
                hist.tb_s.append(time.perf_counter() - t_tb)
            stop = cbs.end_epoch(epoch, monitor)
            if ckpts is not None:
                ckpts.after_epoch(epoch, epochs, stop)
            if trace is not None:
                trace.step()
            if stop:
                break
    finally:
        closing.set()
        for slot in slots:
            slot.free.release()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
        if cuda:
            torch.cuda.current_stream(device).wait_stream(stage_stream)
    return hist


def train_with_args(args):
    """The CLI's run: read -> normalize -> build -> train -> predict ->
    write, or, for h5ad output and outputs above DCA_TPU_HOST_DENSE_BYTES,
    train -> streaming denoise and write; with ``--hyper`` the search of
    ``hyper.py`` instead."""
    from ..data import io as dio
    from ..models.network import get_ae_type

    random.seed(42)
    np.random.seed(42)
    os.environ["PYTHONHASHSEED"] = "0"

    if args.hyper:
        from ..hyper import hyper

        hyper(args)
        return
    ae_cls = get_ae_type(args.type)
    devices = args.devices
    joined = False
    if devices is not None:
        # torchrun's ranks join their process group before the network is
        # built on each rank's device
        joined = not dist.is_initialized()
        initialize(device=args.device)
        joined = joined and dist.is_initialized()
        if devices != "all":
            devices = int(devices)
    device = resolve_device(args.device)

    adata = dio.read_dataset(
        args.input,
        transpose=(not args.transpose),  # gene x cell on disk by default
        check_counts=args.checkcounts,
        test_split=args.testsplit,
    )
    adata = dio.normalize(
        adata,
        size_factors=args.sizefactors,
        logtrans_input=args.loginput,
        normalize_input=args.norminput,
        # large sparse inputs stay sparse, their z-scale deferred
        lazy_scale=dio.auto_lazy_scale(adata),
    )

    if args.denoisesubset:
        genelist = list(set(dio.read_genelist(args.denoisesubset)))
        assert len(set(genelist) - set(adata.var_names.values)) == 0, (
            "Gene list is not overlapping with genes from the dataset"
        )
        output_size = len(genelist)
    else:
        genelist = None
        output_size = adata.n_vars

    hidden_size = [int(x) for x in args.hiddensize.split(",")]
    hidden_dropout = [float(x) for x in args.dropoutrate.split(",")]
    if len(hidden_dropout) == 1:
        hidden_dropout = hidden_dropout[0]

    net = ae_cls(
        input_size=adata.n_vars,
        output_size=output_size,
        hidden_size=hidden_size,
        l2_coef=args.l2,
        l1_coef=args.l1,
        l2_enc_coef=args.l2enc,
        l1_enc_coef=args.l1enc,
        ridge=args.ridge,
        hidden_dropout=hidden_dropout,
        input_dropout=args.inputdropout,
        batchnorm=args.batchnorm,
        activation=args.activation,
        init=args.init,
        debug=args.debug,
        file_path=args.outputdir,
        device=device,
    )
    net.save()
    net.build()

    train(
        adata[adata.obs.dca_split == "train"],
        net,
        output_dir=args.outputdir,
        learning_rate=args.learningrate,
        epochs=args.epochs,
        batch_size=args.batchsize,
        early_stop=args.earlystop,
        reduce_lr=args.reducelr,
        output_subset=genelist,
        optimizer=args.optimizer,
        clip_grad=args.gradclip,
        save_weights=args.saveweights,
        tensorboard=args.tensorboard,
        threads=args.threads,
        devices=devices,
        model_parallel=args.modelparallel,
    )

    if genelist:
        predict_columns = adata.var_names[
            [np.where(adata.var_names == x)[0][0] for x in genelist]
        ]
    else:
        predict_columns = adata.var_names
    # outputs too large for the host stream block by block to disk
    out_bytes = adata.n_obs * output_size * 4
    limit = int(os.environ.get("DCA_TPU_HOST_DENSE_BYTES", 2_000_000_000))
    if args.outputformat == "h5ad" or out_bytes > limit:
        net.write_streaming(adata, args.outputdir, mode="full", colnames=predict_columns,
                            return_info=True, output_format=args.outputformat)
    else:
        net.predict(adata, mode="full", return_info=True)
        net.write(adata, args.outputdir, mode="full", colnames=predict_columns)
    if joined:
        # the ranks end together, rank 0 after its writes, and leave the
        # group they joined: a rank that exits first with the group alive
        # can abort in the interpreter's teardown, and torchrun then stops
        # the others, rank 0 in the middle of its writes
        dist.barrier()
        dist.destroy_process_group()
