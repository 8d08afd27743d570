"""Training loop with Keras-parity callbacks, and the CLI's run.

A port of the JAX package's Python-epoch fit (``dca_tpu/train/loop.py``,
the path it takes on every backend but the TPU):

  * the train split lives on the device, and each minibatch is gathered
    there from a per-epoch permutation drawn from
    ``np.random.RandomState(seed)``, the same stream the JAX loop draws;
  * the trailing partial batch keeps its own shape (no padding);
  * validation follows Keras ``validation_split``: the last fraction of the
    rows is held out before any shuffling;
  * the per-step losses stay on the device and are read once per epoch;
  * ReduceLROnPlateau (factor 0.1, min_delta 1e-4) and EarlyStopping
    (min_delta 0) are plain Python state between epochs; as in the JAX
    package, the final weights are kept (no restore of the best ones).

Streaming, the whole-fit-as-one-program path, checkpoint/resume,
TensorBoard, saved weights and device meshes wait for later slices
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch

from ..data.io import densify, size_factors
from ..device import resolve_device
from .optim import get_optimizer

# dense outputs above this many bytes need the streaming writer, which
# waits for a later slice
_HOST_DENSE_BYTES = 2_000_000_000


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to dca_tpu_torch yet (see ROADMAP.md, Queue 1)")


class History:
    """Keras-style history object (.history dict of per-epoch lists)."""

    def __init__(self):
        self.history = {}

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
):
    """Fit ``network`` (built) on ``adata``, on the network's device.
    Returns a History."""
    assert network.model is not None, "network.build() must be called before train()"
    if save_weights:
        raise _not_ported("save_weights (weights.hdf5)")
    if tensorboard:
        raise _not_ported("TensorBoard logging")
    if threads:
        torch.set_num_threads(threads)
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    opt = get_optimizer(optimizer, clipvalue=clip_grad)
    lr = float(learning_rate) if learning_rate is not None else opt.default_lr
    device = network.device

    # ----- host arrays -----
    X = densify(adata.X)
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
    if has_val:
        X_val, T_val, sf_val = dev(X[split_at:]), dev(target[split_at:]), dev(sf[split_at:])

    params = list(network.model.parameters())
    opt_state = opt.init(params)
    generator = torch.Generator(device=device).manual_seed(seed)

    def step(idx, lr_now):
        xb, tb, sfb = X_tr[idx], T_tr[idx], sf_tr[idx]
        loss, new_state = network.loss_fn(xb, sfb, tb, True, generator)
        grads = torch.autograd.grad(loss, params)
        opt.update(grads, opt_state, params, lr_now)
        network.model.load_bn_state(new_state)
        return loss.detach()

    rng_np = np.random.RandomState(seed)
    hist = History()
    cbs = _FitCallbacks(lr, reduce_lr, early_stop, verbose,
                        "val_loss" if has_val else "loss")

    for epoch in range(epochs):
        perm = torch.from_numpy(rng_np.permutation(n_train)).to(device)
        lr_now = cbs.lr
        full_losses = torch.zeros(n_full, device=device)
        for i in range(n_full):
            full_losses[i] = step(perm[i * bs:(i + 1) * bs], lr_now)
        rem_loss = step(perm[n_full * bs:], lr_now) if rem > 0 else \
            torch.zeros((), device=device)

        with torch.no_grad():
            sums = [full_losses.sum(), rem_loss]
            if has_val:
                sums.append(network.loss_fn(X_val, sf_val, T_val, False)[0])
            sums = torch.stack(sums).tolist()  # the epoch's one read-back
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
    """The CLI's run: read -> normalize -> build -> train -> predict -> write."""
    from ..data import io as dio
    from ..models.network import get_ae_type

    for flag, what in (("hyper", "--hyper"), ("tensorboard", "--tensorboard"),
                       ("saveweights", "--saveweights")):
        if getattr(args, flag):
            raise _not_ported(what)
    if args.outputformat != "tsv":
        raise _not_ported("--outputformat h5ad")
    if args.devices is not None or args.modelparallel != 1:
        raise _not_ported("training over several devices (--devices, --modelparallel)")
    ae_cls = get_ae_type(args.type)
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
    if adata.n_obs * output_size * 4 > _HOST_DENSE_BYTES:
        raise _not_ported("the streaming write of outputs above 2 GB")

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
    )

    if genelist:
        predict_columns = adata.var_names[
            [np.where(adata.var_names == x)[0][0] for x in genelist]
        ]
    else:
        predict_columns = adata.var_names
    net.predict(adata, mode="full", return_info=True)
    net.write(adata, args.outputdir, mode="full", colnames=predict_columns)
