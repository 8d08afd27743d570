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
  * on one CUDA device, outside ``debug``, the full step and the trailing
    step are captured once a fit as two CUDA graphs and replayed, n_full
    times and once an epoch: the counterpart of ``epoch_fn`` and
    ``rem_step_fn`` (``train/graphs.py``).  A failed capture raises; it
    never falls back to the eager loop.  The CPU fit, the ``debug`` fit
    (its sanitizer reads values back, and the JAX package leaves jit there
    too) and the data-parallel fit call the same step from Python;
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
(``parallel/``): every rank stages the whole train split, draws the same
permutation and computes its block of each global batch, the trailing one
included; the batch statistics, the loss's (sum, count) pair and the
gradients are summed over the ranks, so the fit is the single-device fit
up to the order of the sums.  The validation split is cut into one block
per rank; where its length does not divide the ranks it is padded with
copies of its row 0 at sample weight 0 (the JAX package's multi-process
padding), and the blocks are evaluated through the weighted loss kernels.
The per-step and validation losses are summed over the ranks once per
epoch, so every rank sees the same history and takes the same callback
decisions.

The streaming trainer, the whole-fit-as-one-program path
(``dca_tpu/train/compiled.py``), checkpoint/resume, TensorBoard, saved
weights and gene-dim model parallelism wait for later slices (ROADMAP.md,
Queue 1): ``train`` takes the JAX package's keywords for them and raises
``NotImplementedError`` where the JAX package would run one of those
paths, before anything is densified or copied to the device.
"""

from __future__ import annotations

import math
import os
import random
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..data.io import densify, scale_stats, size_factors
from ..device import resolve_device
from ..parallel.mesh import resolve_mesh
from ..parallel.multihost import initialize, is_primary
from ..parallel.step import (StepBuffers, batch_shard, make_sharded_train_step,
                             place_train_state, shard_train_data)
from .graphs import EagerEpoch, GraphEpoch
from .optim import get_optimizer, state_tensors


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to dca_tpu_torch yet (see ROADMAP.md, Queue 1)")


class History:
    """Keras-style history object (.history dict of per-epoch lists).
    ``epoch_s``: each epoch's wall time, the steps, the validation and the
    read-back of its losses; ``capture_s``: the wall time of the CUDA
    graphs' warm-up and capture before the first epoch, None for an eager
    fit."""

    def __init__(self):
        self.history = {}
        self.epoch_s = []
        self.capture_s = None

    def append(self, key, value):
        self.history.setdefault(key, []).append(float(value))


class _FitCallbacks:
    """Keras-parity per-epoch callbacks: EarlyStopping (patience) and
    ReduceLROnPlateau (factor=0.1, min_delta=1e-4, min_lr=0)."""

    FACTOR, MIN_DELTA, MIN_LR = 0.1, 1e-4, 0.0

    def __init__(self, lr, reduce_lr, early_stop, verbose, monitor_name):
        self.lr = lr
        self.reduce_lr = reduce_lr
        self.early_stop = early_stop
        self.verbose = verbose
        self.monitor_name = monitor_name
        self.best_monitor = math.inf
        self.es_wait = 0
        self.rlr_best = math.inf  # ReduceLROnPlateau tracks its own best
        self.rlr_wait = 0

    def end_epoch(self, epoch, monitor) -> bool:
        """Apply all callbacks for one finished epoch; True => stop."""
        stop = False
        if monitor < self.best_monitor:
            self.best_monitor = monitor
            self.es_wait = 0
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
    **kwds,
):
    """Fit ``network`` (built) on ``adata``, on the network's device.
    Returns a History.

    The keywords are the JAX package's ``train``'s, in its order; unknown
    ones are accepted and ignored, as there.  ``compiled`` "auto" or False
    runs this loop, whose steps are jitted in the JAX package and replayed
    from CUDA graphs here (the JAX package's "auto" takes its whole-fit
    program only on a TPU); True raises, unless the network is in
    ``debug`` mode, where the JAX package runs its eager loop too.
    ``checkpoint_every > 0`` and ``resume`` raise.  The size gate of the
    JAX package: an input of more than ``max_device_cells`` cells, or
    without it one whose input and target, n_cells * n_genes * 4 * 2
    bytes, exceed DCA_TPU_DEVICE_BYTES (default 6e9), would take its
    streaming trainer, and raises here.

    ``devices``/``model_parallel`` as the JAX package's: None for one
    device; ``"all"``, an int or a list for data parallelism over the
    ranks of the initialized process group (``parallel.mesh.resolve_mesh``;
    every rank calls ``train`` with the same data and seed).
    ``model_parallel > 1`` raises (ROADMAP.md).

    On one CUDA device, outside ``debug``, the steps are replayed from
    CUDA graphs captured at the start of the fit (``train/graphs.py``);
    ``_graphs=False``, for the tests, calls them from Python there too."""
    assert network.model is not None, "network.build() must be called before train()"
    if save_weights:
        raise _not_ported("save_weights (weights.hdf5)")
    if tensorboard:
        raise _not_ported("TensorBoard logging")
    if checkpoint_every or resume:
        raise _not_ported("checkpoint/resume (checkpoint_every, resume)")
    if compiled != "auto" and compiled and not network.definition.debug:
        raise _not_ported("the whole-fit compiled program (train/compiled.py)")
    n_cells, n_genes = adata.n_obs, adata.n_vars
    if max_device_cells is not None:
        stream = n_cells > max_device_cells
    else:
        stream = n_cells * n_genes * 4 * 2 > int(os.environ.get("DCA_TPU_DEVICE_BYTES",
                                                                6_000_000_000))
    if stream:
        raise _not_ported("the streaming trainer for inputs above the device budget")
    if threads:
        # the CPU path computes in torch; the host loops of the native tier
        # (text parse and format, row gathers) take the same cap, as the
        # JAX package's train() gives them
        torch.set_num_threads(threads)
        native.set_threads(threads)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    group = resolve_mesh(devices, model_parallel)
    opt = get_optimizer(optimizer, clipvalue=clip_grad)
    lr = float(learning_rate) if learning_rate is not None else opt.default_lr
    device = network.device
    verbose = verbose and is_primary()

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

    def dev(a):
        # np.array copies: the tensor owns writable memory, not a view of adata
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    X_tr, T_tr, sf_tr = dev(X[:split_at]), dev(target[:split_at]), dev(sf[:split_at])
    val_shard = w_val = None
    if has_val:
        X_val, T_val, sf_val = X[split_at:], target[split_at:], sf[split_at:]
        if group is not None:
            # one block per rank, padded to a multiple of the ranks with
            # copies of row 0 at weight 0
            pad = (-n_val) % dist.get_world_size(group)
            w = np.ones((n_val + pad,), np.float32)
            w[n_val:] = 0.0
            X_val, T_val, sf_val, w = shard_train_data(
                group, *(_pad_rows(a, pad) for a in (X_val, T_val, sf_val)), w)
            w_val = dev(w) if pad else None
            val_shard = batch_shard(group, n_val + pad)
        X_val, T_val, sf_val = dev(X_val), dev(T_val), dev(sf_val)

    if group is not None:
        place_train_state(network, group)
    params = list(network.model.parameters())
    opt_state = opt.init(params)
    generator = torch.Generator(device=device).manual_seed(seed)
    bufs = StepBuffers.create(n_train, bs, lr, device)
    train_step = make_sharded_train_step(network, opt, group)

    def step(trailing=False):
        train_step(X_tr, T_tr, sf_tr, bufs, opt_state, generator, trailing)

    rng_np = np.random.RandomState(seed)
    hist = History()
    cbs = _FitCallbacks(lr, reduce_lr, early_stop, verbose,
                        "val_loss" if has_val else "loss")
    if (_graphs and epochs > 0 and device.type == "cuda" and group is None
            and not network.definition.debug):
        written = params + list(network.model.buffers()) + state_tensors(opt_state)
        run_epoch = GraphEpoch(step, bufs, rem, written, generator)
        hist.capture_s = run_epoch.capture_s
    else:
        run_epoch = EagerEpoch(step, bufs, rem)

    for epoch in range(epochs):
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

        if cbs.end_epoch(epoch, monitor):
            break
    return hist


def train_with_args(args):
    """The CLI's run: read -> normalize -> build -> train -> predict ->
    write, or, for h5ad output and outputs above DCA_TPU_HOST_DENSE_BYTES,
    train -> streaming denoise and write."""
    from ..data import io as dio
    from ..models.network import get_ae_type

    for flag, what in (("hyper", "--hyper"), ("tensorboard", "--tensorboard"),
                       ("saveweights", "--saveweights")):
        if getattr(args, flag):
            raise _not_ported(what)
    ae_cls = get_ae_type(args.type)
    devices = args.devices
    if devices is not None:
        # torchrun's ranks join their process group before the network is
        # built on each rank's device
        initialize(device=args.device)
        if devices != "all":
            devices = int(devices)
    device = resolve_device(args.device)

    random.seed(42)
    np.random.seed(42)
    os.environ["PYTHONHASHSEED"] = "0"

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
