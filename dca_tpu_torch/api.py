"""Scanpy-compatible single-function API.

A port of the JAX package's ``dca()`` (``dca_tpu/api.py``): the same
signature and defaults (``ae_type='nb-conddisp'``, 64-32-64, epochs=300,
batch 32, RMSprop, reduce_lr=10, early_stop=15), the same side effects
(``adata.X`` overwritten in denoise mode, ``obsm['X_dca']`` in latent mode;
with ``return_info`` the dispersion in ``obsm['X_dca_dispersion']``, or
``var['X_dca_dispersion']`` for the constant-dispersion ``nb``/``zinb``,
and the ZINB dropout in ``obsm['X_dca_dropout']``; the loss history in
``uns['dca_loss_history']``) and the same return values (copy x
return_model), for every ``ae_type``, hidden ``activation`` (PReLU
included) and ``optimizer`` of the JAX package, plus ``device``: the CUDA
device unless ``device="cpu"``.

``devices``/``model_parallel`` as the JAX package's: with ``devices``
(``"all"``, an int or a list) the fit is data parallel over the ranks of a
``torch.distributed`` process group, one process per device, each calling
``dca`` on the same data (``parallel/``); under torchrun the ranks join
their group here.  With ``model_parallel`` M > 1 the ranks form a
(ranks / M) x M grid and each holds its gene shard of the input kernel
and of the heads during the fit (gene-dim model parallelism).  After the
fit every rank holds the same parameters and the full denoised matrix.
One process over several GPUs is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import random

import numpy as np

from .data.adata import is_anndata_like
from .data.io import _col_sums, auto_lazy_scale, normalize, read_dataset
from .device import resolve_device
from .models.network import get_ae_type
from .parallel.multihost import initialize
from .train.loop import train


def dca(
    adata,
    mode="denoise",
    ae_type="nb-conddisp",
    normalize_per_cell=True,
    scale=True,
    log1p=True,
    hidden_size=(64, 32, 64),  # network args
    hidden_dropout=0.0,
    batchnorm=True,
    activation="relu",
    init="glorot_uniform",
    network_kwds={},
    epochs=300,  # training args
    reduce_lr=10,
    early_stop=15,
    batch_size=32,
    optimizer="RMSprop",
    learning_rate=None,
    random_state=0,
    threads=None,
    verbose=False,
    training_kwds={},
    return_model=False,
    return_info=False,
    copy=False,
    check_counts=True,
    devices=None,
    model_parallel=1,
    device=None,
):
    """Deep count autoencoder: denoise ``adata`` or embed it in the latent
    space.  Arguments and return values as the JAX package's ``dca``;
    ``device`` is ``None`` (the CUDA device; raises when there is none) or
    ``"cpu"``."""
    assert is_anndata_like(adata), "adata must be an AnnData instance"
    assert mode in ("denoise", "latent"), "%s is not a valid mode." % mode
    ae_cls = get_ae_type(ae_type)
    if devices is not None:
        # before the network is built: each rank takes its own device
        initialize(device=device)
    device = resolve_device(device)

    random.seed(random_state)
    np.random.seed(random_state)
    os.environ["PYTHONHASHSEED"] = "0"

    adata = read_dataset(
        adata, transpose=False, test_split=False, copy=copy, check_counts=check_counts
    )

    nonzero_genes = _col_sums(adata.X) >= 1
    assert nonzero_genes.all(), "Please remove all-zero genes before using DCA."

    adata = normalize(
        adata,
        filter_min_counts=False,  # no filtering, keep cell and gene idxs same
        size_factors=normalize_per_cell,
        normalize_input=scale,
        logtrans_input=log1p,
        # large sparse inputs stay sparse, their z-scale deferred to the fit's
        # assembly and the predict's blocks
        lazy_scale=auto_lazy_scale(adata),
    )

    network_kwds = {
        **network_kwds,
        "hidden_size": hidden_size,
        "hidden_dropout": hidden_dropout,
        "batchnorm": batchnorm,
        "activation": activation,
        "init": init,
    }

    input_size = output_size = adata.n_vars
    net = ae_cls(input_size=input_size, output_size=output_size, seed=random_state,
                 device=device, **network_kwds)
    net.save()
    net.build()

    training_kwds = {
        "devices": devices,
        "model_parallel": model_parallel,
        **training_kwds,  # may override the mesh arguments
        "epochs": epochs,
        "reduce_lr": reduce_lr,
        "early_stop": early_stop,
        "batch_size": batch_size,
        "optimizer": optimizer,
        "verbose": verbose,
        "threads": threads,
        "learning_rate": learning_rate,
        "seed": random_state,
    }

    hist = train(adata[adata.obs.dca_split == "train"], net, **training_kwds)
    res = net.predict(adata, mode, return_info, copy)
    adata = res if copy else adata

    if return_info:
        adata.uns["dca_loss_history"] = hist.history

    if return_model:
        return (adata, net) if copy else net
    return adata if copy else None
