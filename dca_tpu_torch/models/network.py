"""The autoencoder's object surface: build / loss / forward / predict /
write / save, on top of the functional core in ``core.py``.

A port of the JAX package's ``dca_tpu/models/network.py`` for all 11
architectures of its ``AE_types``, with the reference's predict-order
quirks: ``nb-conddisp`` (and ``nb-shared``, ``nb-fork``) compute the
dispersion after denoising, from the denoised matrix; the ZINB classes take
dispersion and dropout from the pre-denoise forward, the same forward that
denoises; the constant-dispersion classes (``nb``, ``zinb``) expose their
per-gene theta.  The NB and ZINB losses go through the fused CUDA kernels
(``ops/fused_loss.py``) for every dispersion and dropout shape the
architectures give; MSE and Poisson, which have no kernel in the JAX
package either, are the plain losses of ``losses.py``.

Outputs follow the reference's TSV contract (mean.tsv, latent.tsv,
dispersion.tsv, dropout.tsv) with the README-era aliases ``mean_norm.tsv``,
``reduced.tsv`` and ``pi.tsv``, written either from the in-memory predict
(``predict`` then ``write``) or block by block (``write_streaming``, also
as one ``denoised.h5ad``), for outputs too large to hold on the host.

The eval forward runs in blocks of rows (``iter_forward_blocks``),
pipelined: the next block's host preparation runs on a thread, and its
upload and forward are dispatched before this block's outputs are copied
back.  It reads the JAX package's switches: DCA_TPU_PREDICT_BLOCK_BYTES
(the block size), DCA_TPU_PREFETCH=0 (no pipelining), DCA_TPU_FETCH_DTYPE
(bf16/f16: outputs downcast on the device before the copy, lossy),
DCA_TPU_WRITE_ALIASES=0 (``write_streaming`` without the alias outputs),
DCA_TPU_DEVICE_DENSIFY (a CSR input scattered dense on the device from
compact payloads), and, in the model, DCA_TPU_FUSED_DENSE and
DCA_TPU_MATMUL.

Under a ``torch.distributed`` process group (a data-parallel fit) every
rank holds the same parameters, so each predicts the whole matrix; rank 0
alone writes files (``save``, ``write``, ``write_streaming``), and the
other ranks return from them at once.  During a fit with gene-dim model
parallelism each rank holds its gene shards (``mesh`` is then the fit's
``parallel.mesh.Mesh``): ``save_weights`` and ``whole_named`` gather the
whole tensors over the model group first, so the files keep the
single-device format; after the fit every rank holds the whole network
again (``parallel.mesh.gather_params``).
"""

from __future__ import annotations

import collections
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch

from .. import losses, timeline
from ..bridge import copy_tree_into, flatten_tree
from ..config import use_device_densify
from ..data.io import densify, scale_stats, size_factors, write_text_matrix
from ..device import resolve_device
from ..ops.densify import device_densify_flat, flat_payload_from_csr, flat_slots_for
from ..ops.fused_loss import nb_nll_fused, nb_nll_fused_w, zinb_nll_fused, zinb_nll_fused_w
from ..parallel.mesh import gather_named
from ..parallel.multihost import is_primary
from . import core


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _fetch_dtype():
    """The dtype forward outputs cross to the host in:
    DCA_TPU_FETCH_DTYPE=bf16 or f16 halves the copy (lossy: about 3
    significant digits for bf16, where the TSVs print 6 decimals); the
    default, f32, is exact."""
    mode = os.environ.get("DCA_TPU_FETCH_DTYPE", "f32")
    if mode in ("f32", "0", ""):
        return None
    if mode == "bf16":
        return torch.bfloat16
    if mode == "f16":
        return torch.float16
    raise ValueError(f"DCA_TPU_FETCH_DTYPE={mode!r}: expected f32/bf16/f16")


# the page-locked staging ring of fetch_to_host: two chunks of this many
# bytes, allocated at the first fetch and kept by the process
FETCH_CHUNK_BYTES = 32 << 20
_rings = {}


def _ring(chunk_bytes):
    """The two page-locked chunks of ``chunk_bytes`` bytes."""
    if chunk_bytes not in _rings:
        _rings[chunk_bytes] = [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True)
                               for _ in range(2)]
    return _rings[chunk_bytes]


def fetch_to_host(outputs):
    """{key: float32 numpy array} of a dict of forward outputs (tensors or
    None), downcast on the device first under DCA_TPU_FETCH_DTYPE and cast
    back on the host.

    The CUDA outputs cross in chunks of ``FETCH_CHUNK_BYTES`` through a ring
    of two page-locked chunks: each chunk's copy is queued without blocking
    and followed by an event, and while it runs the host copies the chunk
    before it, once its event has completed, into the output's pageable
    array.  The page-locked memory is the ring's two chunks whatever the
    size of the block, and the arrays handed out are pageable and own
    their memory.  A CPU output is read as it is."""
    dt = _fetch_dtype()
    fetched, pieces = {}, []
    for k, v in outputs.items():
        if v is not None and dt is not None and v.dtype == torch.float32:
            v = v.to(dt)
        if v is None or not v.is_cuda:
            fetched[k] = v
            continue
        v = v.contiguous()
        fetched[k] = torch.empty(v.shape, dtype=v.dtype)
        src, dst = v.view(-1).view(torch.uint8), fetched[k].view(-1).view(torch.uint8)
        pieces += [(src[i:i + FETCH_CHUNK_BYTES], dst[i:i + FETCH_CHUNK_BYTES])
                   for i in range(0, src.numel(), FETCH_CHUNK_BYTES)]
    ring, queued = _ring(FETCH_CHUNK_BYTES) if pieces else [], []

    def drain():
        done, staged, dst = queued.pop(0)
        done.synchronize()
        dst.copy_(staged)

    for i, (src, dst) in enumerate(pieces):
        if len(queued) == len(ring):
            drain()  # the piece that holds the chunk this one takes
        staged = ring[i % len(ring)][:src.numel()]
        staged.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(src.device))
        queued.append((done, staged, dst))
    while queued:
        drain()
    return {k: None if v is None else v.to(torch.float32).numpy() for k, v in fetched.items()}


class Autoencoder:
    """Base class: the constructor arguments, the parameters
    (``self.model``, a ``core.DCANetwork``) and the device they live on:
    the CUDA device unless ``device="cpu"`` (``device.resolve_device``)."""

    ae_type = "normal"

    def __init__(
        self,
        input_size,
        output_size=None,
        hidden_size=(64, 32, 64),
        l2_coef=0.0,
        l1_coef=0.0,
        l2_enc_coef=0.0,
        l1_enc_coef=0.0,
        ridge=0.0,
        hidden_dropout=0.0,
        input_dropout=0.0,
        batchnorm=True,
        activation="relu",
        init="glorot_uniform",
        file_path=None,
        debug=False,
        seed=42,
        device=None,
        **kwargs,
    ):
        self.input_size = input_size
        self.output_size = input_size if output_size is None else output_size
        self.hidden_size = tuple(hidden_size)
        self.l2_coef = l2_coef
        self.l1_coef = l1_coef
        self.l2_enc_coef = l2_enc_coef
        self.l1_enc_coef = l1_enc_coef
        self.ridge = ridge
        self.hidden_dropout = hidden_dropout
        self.input_dropout = input_dropout
        self.batchnorm = batchnorm
        self.activation = activation
        self.init = init
        self.file_path = file_path
        self.debug = debug
        self.seed = seed
        self.device = resolve_device(device)
        self.extra_kwargs = kwargs

        self.definition: core.NetworkDef | None = None
        self.model: core.DCANetwork | None = None
        # the Mesh of a model-parallel fit while the model holds gene shards,
        # and the state-dict names of those shards (parallel.mesh.shard_params)
        self.mesh = None
        self.sharded = frozenset()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def _definition_kwargs(self):
        return dict(
            ae_type=self.ae_type,
            input_size=self.input_size,
            output_size=self.output_size,
            hidden_size=self.hidden_size,
            l2_coef=self.l2_coef,
            l1_coef=self.l1_coef,
            l2_enc_coef=self.l2_enc_coef,
            l1_enc_coef=self.l1_enc_coef,
            ridge=self.ridge,
            hidden_dropout=self.hidden_dropout,
            input_dropout=self.input_dropout,
            batchnorm=self.batchnorm,
            activation=self.activation,
            init=self.init,
            debug=self.debug,
        )

    def build(self, generator=None):
        """Define the network and draw its initial weights from
        ``generator`` (default: a generator on the device seeded with
        ``self.seed``)."""
        self.definition = core.build_definition(**self._definition_kwargs())
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model = core.DCANetwork(self.definition, generator, self.device)
        return self

    # ------------------------------------------------------------------
    # functional pieces used by the trainer
    # ------------------------------------------------------------------
    def apply(self, count, size_factors, training=False, generator=None, keys=None,
              shard=None):
        return core.apply(self.definition, self.model, count, size_factors,
                          training=training, generator=generator, keys=keys, shard=shard)

    def likelihood_loss(self, outputs, target, sample_weights=None, group=None):
        """Negative log-likelihood of the forward outputs (no weight penalty).

        MSE and Poisson are the plain losses.  NB and ZINB go through the
        fused kernels (``ops/fused_loss.py``), which take every dispersion
        and dropout shape the architectures give ((B, G), (1, G), (B, 1))
        and raise on any other; ``debug`` (the finite-ness sanitizer) uses
        the plain ``losses.nb_nll``/``zinb_nll``, as in the JAX package.
        Masking is on: identical to the reference's default on finite
        targets, and NaN targets are masked by the reference's rules.
        ``sample_weights``, a vector of one weight per row (the padded
        validation of a data-parallel fit), gives the weighted mean: a
        (B, 1) column for the weighted kernels K1w/K2w.  ``group``: this
        rank's share of the mean over a distributed batch."""
        lk = self.definition.likelihood
        out = outputs["output"]
        w = None
        if sample_weights is not None:
            if tuple(sample_weights.shape) != (out.shape[0],):
                raise ValueError(f"sample_weights must be one weight per row, shape "
                                 f"{(out.shape[0],)}; got {tuple(sample_weights.shape)}")
            w = sample_weights.to(torch.float32).reshape(-1, 1).contiguous()
        if lk == "mse":
            return losses.mse_loss(target, out, sample_weights=sample_weights, group=group)
        if lk == "poisson":
            return losses.poisson_loss(target, out, sample_weights=sample_weights, group=group)
        disp, pi = outputs["disp"], outputs["pi"]
        if self.definition.debug:
            kw = dict(masking=sample_weights is None, sample_weights=sample_weights,
                      debug=True, group=group)
            if lk == "nb":
                return losses.nb_nll(target, out, disp, **kw)
            return losses.zinb_nll(target, out, disp, pi, ridge_lambda=self.ridge, **kw)
        y = target.to(torch.float32).contiguous()
        if lk == "nb":
            if w is not None:
                return nb_nll_fused_w(y, out, disp, w, group)
            return nb_nll_fused(y, out, disp, group)
        if w is not None:
            return zinb_nll_fused_w(y, out, disp, pi, w, self.ridge, group)
        return zinb_nll_fused(y, out, disp, pi, self.ridge, group)

    def loss_fn(self, count, size_factors, target, training, generator=None,
                sample_weights=None, shard=None):
        """Total loss = NLL + l1/l2 weight penalties.  Returns (loss,
        new batch-norm state).  ``shard`` (a ``parallel.step.BatchShard``):
        this rank's rows (and, with a model axis, gene columns) of a
        distributed batch; the loss is then this rank's share, and each
        penalty enters the summed gradient once: the whole kernels' on
        rank 0 alone, each gene shard's on data index 0 of its model
        index."""
        outputs, new_state = self.apply(count, size_factors, training=training,
                                        generator=generator, shard=shard)
        loss = self.likelihood_loss(outputs, target, sample_weights,
                                    None if shard is None else shard.world)
        if shard is None:
            loss = loss + core.regularization_loss(self.definition, self.model)
        else:
            sharded = self.sharded
            if shard.mesh.rank == 0:
                loss = loss + core.regularization_loss(self.definition, self.model,
                                                       lambda name: name not in sharded)
            if sharded and shard.rank == 0:
                loss = loss + core.regularization_loss(self.definition, self.model,
                                                       sharded.__contains__)
        return loss, new_state

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _auto_chunk_rows(self, n_keys):
        """Rows per forward block: about DCA_TPU_PREDICT_BLOCK_BYTES (default
        2 GB) of input and outputs on the device per block, between 1024 and
        32768 rows."""
        budget = int(os.environ.get("DCA_TPU_PREDICT_BLOCK_BYTES", 2_000_000_000))
        G = max(self.input_size, self.output_size, 1)
        rows = budget // (4 * G * (max(n_keys, 1) + 1))
        return int(max(1024, min(32768, rows)))

    def iter_forward_blocks(self, count, size_factors=None, scale_mean=None,
                            scale_std=None, chunk_rows=None, keys=None):
        """Yield ``(lo, hi, {key: np.ndarray})``: the eval forward of rows
        [lo, hi) of ``count`` (dense or scipy sparse), block by block.

        Pipelined: while block k's outputs are copied back, block k+1's
        rows are already densified (and z-scaled) on a worker thread, which
        runs no torch, and its upload and forward are queued on the device.
        DCA_TPU_PREFETCH=0 runs the blocks one after another.
        ``scale_mean``/``scale_std``: the deferred z-scale of
        ``normalize(lazy_scale=True)``, applied to each block.  A CSR
        ``count`` with DCA_TPU_DEVICE_DENSIFY on (``config.use_device_densify``:
        by default on a CUDA device) crosses as flat payloads built on the
        worker thread and scattered dense on the device, the z-scale fused
        there (``ops/densify.py``).
        ``chunk_rows=None`` sizes the blocks from DCA_TPU_PREDICT_BLOCK_BYTES;
        ``keys`` restricts the outputs, and the heads computed, to those.
        Each block's host half, device half and fetch are the recorder's
        spans ``dca.predict.prep``, ``dca.predict.compute`` and
        ``dca.predict.fetch`` (``timeline.py``; ``part`` the block's index)."""
        assert self.model is not None, "call build() first"
        with timeline.session():
            yield from self._forward_blocks(count, size_factors, scale_mean, scale_std,
                                            chunk_rows, keys)

    def _forward_blocks(self, count, size_factors, scale_mean, scale_std, chunk_rows, keys):
        n = count.shape[0]
        sf = (np.ones((n,), np.float32) if size_factors is None
              else np.asarray(size_factors, np.float32))
        keys = tuple(keys) if keys is not None else None

        # a CSR count with the device densify on crosses as flat payloads,
        # scattered dense on the device with the z-scale fused
        # (ops/densify.py, the streaming trainer's tier)
        use_payload = sp.isspmatrix_csr(count) and use_device_densify(self.device)
        if use_payload:
            nnz = np.diff(count.indptr)
            nnz_moments = (float(nnz.mean()), float(nnz.std()))
            mean_d = std_d = None
            if scale_mean is not None:
                mean_d = torch.tensor(np.asarray(scale_mean, np.float32), device=self.device)
                std_d = torch.tensor(np.asarray(scale_std, np.float32), device=self.device)

        def prep(i, lo, hi):
            """Host half, on the worker thread: the payload, or the dense
            and scaled rows."""
            with timeline.span("dca.predict.prep", part=i, rows=hi - lo):
                if use_payload:
                    rows = np.arange(lo, hi, dtype=np.int64)
                    return flat_payload_from_csr(count, rows,
                                                 flat_slots_for(count, rows, nnz_moments, nnz))
                x = densify(count[lo:hi])
                if scale_mean is not None:
                    x = (x - scale_mean) / scale_std
                return x

        def compute(x, i, lo, hi):
            """Device half: upload and forward, queued on the device."""
            with timeline.span("dca.predict.compute", part=i, rows=hi - lo), torch.no_grad():
                if use_payload:
                    x = device_densify_flat(*x, hi - lo, count.shape[1], mean_d, std_d,
                                            device=self.device)
                else:
                    # torch.tensor copies: adata's arrays may be read-only views
                    x = torch.tensor(x, device=self.device)
                out, _ = self.apply(x, torch.tensor(sf[lo:hi], device=self.device),
                                    keys=keys)
            return out

        if chunk_rows is None:
            chunk_rows = self._auto_chunk_rows(len(keys) if keys is not None else 5)
        blocks = [(lo, min(lo + chunk_rows, n))
                  for lo in range(0, n, chunk_rows)] or [(0, 0)]

        def fetch(i, lo, hi, dev):
            with timeline.span("dca.predict.fetch", part=i, rows=hi - lo):
                return fetch_to_host(dev)

        if len(blocks) == 1 or os.environ.get("DCA_TPU_PREFETCH", "1") == "0":
            for i, (lo, hi) in enumerate(blocks):
                yield lo, hi, fetch(i, lo, hi, compute(prep(i, lo, hi), i, lo, hi))
            return

        pool = ThreadPoolExecutor(max_workers=1)
        try:
            prep_fut = pool.submit(prep, 0, *blocks[0])
            pending = None
            for i, (lo, hi) in enumerate(blocks):
                prepped = prep_fut.result()
                if i + 1 < len(blocks):
                    prep_fut = pool.submit(prep, i + 1, *blocks[i + 1])
                dev = compute(prepped, i, lo, hi)
                if pending is not None:
                    yield pending[1], pending[2], fetch(*pending)
                pending = (i, lo, hi, dev)
            yield pending[1], pending[2], fetch(*pending)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def forward(self, count, size_factors=None, scale_mean=None, scale_std=None,
                chunk_rows=None, keys=None):
        """Eval-mode forward over a full matrix; returns a dict of numpy
        outputs (only ``keys`` when given).  See ``iter_forward_blocks``."""
        pieces = []
        rows0 = None
        for lo, hi, out in self.iter_forward_blocks(count, size_factors, scale_mean,
                                                    scale_std, chunk_rows, keys):
            if rows0 is None:
                rows0 = hi - lo
            pieces.append(out)
        if len(pieces) == 1:
            return pieces[0]
        # per-row outputs are concatenated; per-gene constants (the constant
        # dispersion head's (1, G)) are the same in every block
        return {k: v if v is None or v.shape[0] != rows0
                else np.concatenate([p[k] for p in pieces], axis=0)
                for k, v in pieces[0].items()}

    def get_encoder(self):
        """Callable (count, size_factors) -> latent: the center layer's
        Dense output, before BN and activation."""

        def encode(count, size_factors=None):
            return self.forward(count, size_factors, keys=("latent",))["latent"]

        return encode

    def get_decoder(self):
        """Callable (latent_activation, size_factors) -> denoised output,
        from the center layer's output after BN and activation
        (``core.apply_decoder``)."""

        def decode(latent_act, size_factors=None):
            latent_act = np.asarray(latent_act, np.float32)
            if size_factors is None:
                size_factors = np.ones((latent_act.shape[0],), np.float32)
            with torch.no_grad():
                out, _ = core.apply_decoder(
                    self.definition, self.model,
                    torch.tensor(latent_act, device=self.device),
                    torch.tensor(np.asarray(size_factors, np.float32), device=self.device))
            return out["output"].cpu().numpy()

        return decode

    def _set_denoised(self, adata, denoised):
        if denoised.shape[1] == adata.n_vars:
            adata.X = denoised
        else:
            # denoise-subset path: keep the narrow matrix out of band
            adata.obsm["X_dca_mean"] = denoised

    _PREDICT_KEYS = {"denoise": ("output", "mean_norm"),
                     "latent": ("latent",),
                     "full": ("output", "mean_norm", "latent")}

    def predict(self, adata, mode="denoise", return_info=False, copy=False,
                _forward_out=None):
        """Denoise and/or embed ``adata``.  ``_forward_out``: a subclass's
        forward over the same pre-denoise input, which the info quirks
        share instead of running the whole matrix again."""
        assert mode in ("denoise", "latent", "full"), "Unknown mode"
        adata = adata.copy() if copy else adata

        out = _forward_out
        if out is None:
            out = self.forward(adata.X, size_factors(adata), *scale_stats(adata),
                               keys=self._PREDICT_KEYS[mode])

        if mode in ("latent", "full"):
            print("dca_tpu_torch: Calculating low dimensional representations...")
            adata.obsm["X_dca"] = out["latent"]
        if mode in ("denoise", "full"):
            print("dca_tpu_torch: Calculating reconstructions...")
            # the unscaled mean of the model input, captured before
            # denoising overwrites X; write() emits it as mean_norm.tsv
            adata.obsm["X_dca_mean_norm"] = out["mean_norm"]
            self._set_denoised(adata, out["output"])
        if mode == "latent":
            adata.X = adata.raw.X.copy()

        return adata if copy else None

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def trees(self):
        """(params, state): the module's tensors, the live ones, in the JAX
        package's two trees: params ``{'trunk': {layer: {'kernel', 'bias',
        'bn_beta', 'prelu_alpha'}}, 'branches': {branch: {layer: ...}},
        'heads': {head: {'kernel', 'bias'} or {'theta'}}}``, state the BN
        statistics of each trunk and branch layer (an empty dict for a layer
        without BN).  Their "/"-joined paths are the keys of
        ``weights.hdf5`` and of the checkpoints; joined by dots, the
        module's state-dict names."""
        assert self.model is not None, "call build() first"
        m = self.model

        def stack(layers, p, s):
            for name, d in layers.items():
                p[name] = dict(d.named_parameters(recurse=False))
                s[name] = dict(d.named_buffers(recurse=False))

        params = {"trunk": {}, "branches": {}, "heads": {}}
        state = {"trunk": {}, "branches": {}}
        stack(m.trunk, params["trunk"], state["trunk"])
        for b, layers in m.branches.items():
            stack(layers, params["branches"].setdefault(b, {}),
                  state["branches"].setdefault(b, {}))
        for h, head in m.heads.items():
            params["heads"][h] = dict(head.named_parameters(recurse=False))
        return params, state

    def numpy_trees(self):
        """``trees()`` as numpy copies on the host."""
        return tuple(_map_tree(lambda t: t.detach().cpu().numpy(), tree)
                     for tree in self.trees())

    def _live(self):
        """{path: tensor} of ``trees()`` under ``params/`` and ``state/``:
        the keys of ``weights.hdf5``."""
        params, state = self.trees()
        return flatten_tree({"params": params, "state": state})

    def whole_named(self, named):
        """``named`` ({path: tensor} of parameters, of their gradients or
        of ``_live()``) with each gene shard of a model-parallel fit
        gathered whole over the model group, a collective every rank of
        the fit calls; ``named`` itself outside such a fit."""
        return gather_named(named, self, self.mesh)

    def load_trees(self, params, state):
        """Copy the arrays of a (params, state) pair of trees (numpy or
        tensors, the layout of ``trees()``) into the module's tensors, in
        place: a CUDA graph captured before reads them at its next replay.
        Every tensor must have its array, of its shape."""
        copy_tree_into(self._live(), flatten_tree({"params": params, "state": state}))

    def save(self):
        """Pickle the network to <file_path>/model.pickle, in the JAX
        package's payload format (ae_type, constructor arguments, and the
        params/state trees as numpy arrays, or None before build).  Rank 0
        alone writes."""
        if not self.file_path or not is_primary():
            return
        params = state = None
        if self.model is not None:
            params, state = self.numpy_trees()
        payload = dict(ae_type=self.ae_type, ctor=self._ctor_config(),
                       params=params, state=state)
        os.makedirs(self.file_path, exist_ok=True)
        with open(os.path.join(self.file_path, "model.pickle"), "wb") as f:
            pickle.dump(payload, f)

    def save_weights(self, filename):
        """The flat HDF5 of the JAX package's ``save_weights``: one dataset a
        tensor, keyed by its "/"-joined path under ``params/`` or
        ``state/``.  Needs h5py; rank 0 alone writes, the whole tensors
        of a model-parallel fit (every rank calls it)."""
        import h5py

        flat = {key: t.detach().cpu().numpy()
                for key, t in self.whole_named(self._live()).items()}
        if not is_primary():
            return
        with h5py.File(filename, "w") as f:
            for key, leaf in flat.items():
                f.create_dataset(key, data=leaf)

    def load_weights(self, filename):
        """Read either weights file into the built network, in place:

        * the flat HDF5 of ``save_weights`` (this package's or the JAX
          package's), or
        * a Keras ``weights.hdf5`` written by the reference implementation
          (``model.save_weights``), detected by the Keras root attribute
          ``layer_names`` and mapped layer by layer (``_load_keras_hdf5``).

        The tensors keep their addresses (``load_trees``)."""
        import h5py

        live = self._live()
        with h5py.File(filename, "r") as f:
            if "layer_names" in f.attrs:
                self._load_keras_hdf5(f)
                return
            flat = {key: np.asarray(f[key]) for key in live}
        copy_tree_into(live, flat)

    def _load_keras_hdf5(self, f):
        """Map a reference Keras ``weights.hdf5`` onto the parameters (the
        JAX package's mapping, on numpy copies of the trees).

        Layer names are shared with the reference by construction
        (``core.build_definition``): trunk ``enc*/center/dec*``, fork
        branches ``*_last_{mean,disp,pi}``, heads ``mean``/``dispersion``/
        ``pi``.  Keras's unnamed BatchNormalization layers are assigned to
        dense layers in model order (Keras lists layers topologically, and
        each trunk BN immediately follows its Dense)."""
        params, state = self.numpy_trees()

        by_name = {}  # keras layer name -> (param dict, state dict)
        for lname, p in params["trunk"].items():
            by_name[lname] = (p, state["trunk"][lname])
        for bname, branch in params.get("branches", {}).items():
            for lname, p in branch.items():
                by_name[lname] = (p, state["branches"][bname][lname])
        for hname, head in self.definition.heads.items():
            by_name[head.name] = (params["heads"][hname], None)

        def _s(x):
            return x.decode() if isinstance(x, bytes) else str(x)

        layer_names = [_s(n) for n in f.attrs["layer_names"]]
        # dense layers awaiting their following BatchNormalization, in order
        bn_queue = collections.deque()
        matched = set()
        for lname in layer_names:
            weight_names = [_s(w) for w in f[lname].attrs.get("weight_names", [])]
            if not weight_names:
                continue
            arrays = {w: np.asarray(f[lname][w]) for w in weight_names}
            if any(w.rsplit("/", 1)[-1].startswith(("beta", "moving_mean"))
                   for w in weight_names):
                assert bn_queue, (
                    f"BatchNormalization layer {lname!r} has no preceding "
                    f"dense layer to attach to")
                p, s = bn_queue.popleft()
                for w, arr in arrays.items():
                    leaf = w.rsplit("/", 1)[-1].split(":")[0]
                    if leaf == "beta":
                        p["bn_beta"] = arr.astype(np.float32)
                    elif leaf == "moving_mean":
                        s["moving_mean"] = arr.astype(np.float32)
                    elif leaf == "moving_variance":
                        s["moving_var"] = arr.astype(np.float32)
                    else:
                        raise ValueError(
                            f"unexpected BatchNorm weight {w!r} in {lname!r} "
                            f"(reference uses center=True, scale=False)")
                continue
            if lname not in by_name:
                raise ValueError(
                    f"Keras layer {lname!r} has weights but no counterpart "
                    f"in this {self.ae_type!r} network — wrong ae_type or "
                    f"architecture for this weights file?")
            p, s = by_name[lname]
            matched.add(lname)
            for w, arr in arrays.items():
                leaf = w.rsplit("/", 1)[-1].split(":")[0]
                if leaf not in p:
                    raise ValueError(f"unexpected weight {w!r} in layer {lname!r}")
                if p[leaf].shape != arr.shape:
                    raise ValueError(
                        f"shape mismatch for {lname}/{leaf}: file "
                        f"{arr.shape} vs model {p[leaf].shape}")
                p[leaf] = arr.astype(np.float32)
            if s is not None and "moving_mean" in s:
                bn_queue.append((p, s))

        missing = {n for n, (p, _) in by_name.items()
                   if "kernel" in p or "theta" in p} - matched
        if missing:
            raise ValueError(
                f"weights file is missing layers {sorted(missing)} for "
                f"ae_type {self.ae_type!r}")
        self.load_trees(params, state)

    def _ctor_config(self):
        return dict(
            input_size=self.input_size,
            output_size=self.output_size,
            hidden_size=self.hidden_size,
            l2_coef=self.l2_coef,
            l1_coef=self.l1_coef,
            l2_enc_coef=self.l2_enc_coef,
            l1_enc_coef=self.l1_enc_coef,
            ridge=self.ridge,
            hidden_dropout=self.hidden_dropout,
            input_dropout=self.input_dropout,
            batchnorm=self.batchnorm,
            activation=self.activation,
            init=self.init,
            file_path=self.file_path,
            debug=self.debug,
            seed=self.seed,
            **self.extra_kwargs,
        )

    # ------------------------------------------------------------------
    # output files
    # ------------------------------------------------------------------
    def write(self, adata, file_path, mode="denoise", colnames=None):
        """Write the TSV contract of ``predict``'s outputs (rank 0 alone)."""
        if not is_primary():
            return
        colnames = adata.var_names.values if colnames is None else colnames
        rownames = adata.obs_names.values

        print("dca_tpu_torch: Saving output(s)...")
        os.makedirs(file_path, exist_ok=True)

        if mode in ("denoise", "full"):
            print("dca_tpu_torch: Saving denoised expression...")
            denoised = (
                adata.obsm["X_dca_mean"] if "X_dca_mean" in adata.obsm else adata.X
            )
            write_text_matrix(denoised, os.path.join(file_path, "mean.tsv"),
                              rownames=rownames, colnames=colnames,
                              transpose=True)  # gene x cell on disk
            if "X_dca_mean_norm" in adata.obsm:
                mean_norm = adata.obsm["X_dca_mean_norm"]
            else:  # write() without a prior predict(): X still is the input
                mean_norm = self.forward(adata.X, size_factors(adata), *scale_stats(adata),
                                         keys=("mean_norm",))["mean_norm"]
            write_text_matrix(mean_norm, os.path.join(file_path, "mean_norm.tsv"),
                              rownames=rownames, colnames=colnames, transpose=True)

        if mode in ("latent", "full") and "X_dca" in adata.obsm:
            print("dca_tpu_torch: Saving latent representations...")
            for fname in ("latent.tsv", "reduced.tsv"):
                write_text_matrix(adata.obsm["X_dca"], os.path.join(file_path, fname),
                                  rownames=rownames, transpose=False)
        self._write_info(adata, file_path, colnames)

    def _write_info(self, adata, file_path, colnames):
        """The info outputs of ``predict(return_info=True)``: none here."""

    # ------------------------------------------------------------------
    # streaming predict -> write (corpus scale)
    # ------------------------------------------------------------------
    def write_streaming(self, adata, file_path, mode="full", colnames=None,
                        return_info=False, output_format="tsv", chunk_rows=None):
        """Denoise and write in one pass, block by block.

        ``predict`` then ``write`` holds every (N, G) output on the host;
        this streams the blocks of ``iter_forward_blocks`` into incremental
        writers (``data/stream_write.py``), so host memory stays O(block +
        gene strip) whatever N.  ``output_format='tsv'`` writes the TSV
        contract byte for byte as ``predict(mode, return_info)`` then
        ``write(mode)`` do; ``'h5ad'`` writes one
        ``<file_path>/denoised.h5ad`` with ``X`` = the denoised matrix and
        the obsm/var layers of ``predict``'s side effects.

        On ``adata`` only the small outputs are stored (``obsm['X_dca']``
        when the mode covers the latent; the constant dispersion in var or
        uns); ``adata.X`` is not overwritten.  ``return_info`` keeps the
        predict-order quirks: the ZINB classes' dispersion and dropout come
        from the same pre-denoise pass; the NB conditional classes'
        dispersion is computed from each denoised block (per block, as eval
        BatchNorm uses running statistics), or, on a denoise-subset run,
        from the unscaled input block, as the in-memory predict does.
        Outputs are routed by the heads' built widths, never by a block's
        shape: a width-1 latent still reaches its streaming writers.  On a
        failure every writer is aborted and its scratch files removed."""
        from ..data.stream_write import H5ADStreamWriter, RowStreamTSV, TransposedSpillTSV

        if not is_primary():
            return
        assert mode in ("denoise", "latent", "full"), "Unknown mode"
        assert output_format in ("tsv", "h5ad"), output_format
        colnames = adata.var_names.values if colnames is None else np.asarray(colnames)
        rownames = adata.obs_names.values

        disp_kind, has_pi, _ = core._STAGE_HEADS[self.ae_type]
        lk = self.definition.likelihood
        want_denoise = mode in ("denoise", "full")
        want_latent = mode in ("latent", "full")
        if output_format == "h5ad" and not want_denoise:
            raise ValueError("output_format='h5ad' needs mode 'denoise' or "
                             "'full' (X holds the denoised matrix)")

        # DCA_TPU_WRITE_ALIASES=0 drops the alias outputs (mean_norm.tsv,
        # reduced.tsv, pi.tsv and the mean_norm h5ad layer) that the
        # reference does not write: mean_norm alone doubles the (N, G) copy
        aliases = os.environ.get("DCA_TPU_WRITE_ALIASES", "1") != "0"
        keys = [k for k in self._PREDICT_KEYS[mode] if aliases or k != "mean_norm"]
        info_same_pass_disp = (return_info and lk == "zinb"
                               and disp_kind in ("conddisp", "shared"))
        info_pi = return_info and has_pi
        info_post_disp = (return_info and lk == "nb"
                          and disp_kind in ("conddisp", "shared") and want_denoise)
        if info_same_pass_disp:
            keys.append("disp")
        if info_pi:
            keys.append("pi")

        heads = self.definition.heads
        # (N, 1) outputs of the *-shared heads: gathered, written at the end
        small_keys = {key for key, head in (("disp", "dispersion"), ("pi", "pi"))
                      if head in heads and heads[head].units == 1}
        small_acc = {}
        writers = {}  # key -> incremental writers
        h5 = None
        print("dca_tpu_torch: Saving output(s)... [streaming]")
        os.makedirs(file_path, exist_ok=True)

        def _transposed(fname, header=True):
            # mean.tsv and mean_norm.tsv carry the cell names as header;
            # dispersion, dropout and pi do not (write() passes no rownames)
            return TransposedSpillTSV(os.path.join(file_path, fname), rownames=colnames,
                                      colnames=rownames if header else None)

        h5_keys = {"output": "X", "latent": "X_dca", "mean_norm": "X_dca_mean_norm",
                   "disp": "X_dca_dispersion", "pi": "X_dca_dropout"}
        pi_files = ("dropout.tsv", "pi.tsv") if aliases else ("dropout.tsv",)
        try:
            if output_format == "h5ad":
                h5 = H5ADStreamWriter(os.path.join(file_path, "denoised.h5ad"),
                                      n_obs=adata.n_obs, n_vars=len(colnames),
                                      obs_index=rownames, var_index=colnames)
            else:
                if want_denoise:
                    writers["output"] = [_transposed("mean.tsv")]
                    if aliases:
                        writers["mean_norm"] = [_transposed("mean_norm.tsv")]
                if want_latent:
                    writers["latent"] = [
                        RowStreamTSV(os.path.join(file_path, f), rownames=rownames)
                        for f in (("latent.tsv", "reduced.tsv") if aliases
                                  else ("latent.tsv",))]
                if (info_same_pass_disp or info_post_disp) and disp_kind == "conddisp":
                    writers["disp"] = [_transposed("dispersion.tsv", header=False)]
                if info_pi and "pi" not in small_keys:
                    writers["pi"] = [_transposed(f, header=False) for f in pi_files]

            def sink(key, block):
                if key in small_keys:
                    small_acc.setdefault(key, []).append(block)
                    return
                for w in writers.get(key, ()):
                    w.append(block)
                if h5 is not None and key in h5_keys:
                    h5.append(h5_keys[key], block)

            sf = size_factors(adata)
            latent_acc = []
            for lo, hi, out in self.iter_forward_blocks(adata.X, sf, *scale_stats(adata),
                                                        chunk_rows=chunk_rows,
                                                        keys=tuple(keys)):
                for k in keys:
                    sink(k, out[k])
                if want_latent:
                    latent_acc.append(out["latent"])
                if info_post_disp:
                    # the NB quirk: dispersion from the denoised block, or, on
                    # a denoise-subset run (where predict leaves X as it is),
                    # from the unscaled input block
                    if out["output"].shape[1] == self.input_size:
                        x_post = out["output"]
                    else:
                        x_post = densify(adata.X[lo:hi])
                    with torch.no_grad():
                        d, _ = self.apply(torch.tensor(x_post, device=self.device),
                                          torch.tensor(sf[lo:hi], device=self.device),
                                          keys=("disp",))
                    sink("disp", fetch_to_host(d)["disp"])
            for ws in writers.values():
                for w in ws:
                    w.close()
        except BaseException:
            for ws in writers.values():
                for w in ws:
                    (w.abort_spill if hasattr(w, "abort_spill") else w.abort)()
            if h5 is not None:
                h5.abort()
            raise

        # small and per-gene outputs, and the side effects on adata
        if want_latent:
            adata.obsm["X_dca"] = np.concatenate(latent_acc, axis=0)
        if return_info and disp_kind == "constant":
            self._store_dispersion(adata)
        if output_format == "tsv":
            if return_info and disp_kind == "constant":
                self._write_dispersion(adata, file_path, colnames)
            for key, fnames in (("disp", ("dispersion.tsv",)), ("pi", pi_files)):
                if key in small_acc:
                    m = np.concatenate(small_acc[key], axis=0)
                    for f in fnames:
                        write_text_matrix(m, os.path.join(file_path, f),
                                          colnames=colnames, transpose=True)
        else:
            for key in ("disp", "pi"):
                if key in small_acc:
                    h5.append(h5_keys[key], np.concatenate(small_acc[key], axis=0))
            if return_info and disp_kind == "constant":
                disp = self._stored_dispersion(adata)
                if disp is not None and disp.size == len(colnames):
                    h5.set_var_vector("X_dca_dispersion", disp)
            h5.close()


class PoissonAutoencoder(Autoencoder):
    ae_type = "poisson"


class _ConstantDispersion:
    """The constant-dispersion classes' per-gene theta: kept in
    ``var['X_dca_dispersion']`` when the output covers every gene, else in
    ``uns['dca_subset_dispersion']``, and written as one value per gene (the
    (1, G) row transposed, as the JAX package writes it)."""

    def dispersion(self):
        with torch.no_grad():
            return core.theta_exp(self.model).cpu().numpy().squeeze()

    def _store_dispersion(self, adata):
        d = self.dispersion()
        if d.size == adata.n_vars:
            adata.var["X_dca_dispersion"] = d
        else:
            adata.uns["dca_subset_dispersion"] = d

    @staticmethod
    def _stored_dispersion(adata):
        if "X_dca_dispersion" in adata.var_keys():
            return np.asarray(adata.var["X_dca_dispersion"])
        return adata.uns.get("dca_subset_dispersion")

    def _write_dispersion(self, adata, file_path, colnames):
        disp = self._stored_dispersion(adata)
        if disp is not None:
            write_text_matrix(disp.reshape(1, -1), os.path.join(file_path, "dispersion.tsv"),
                              colnames=colnames, transpose=True)


def _write_obsm(adata, key, file_path, fnames, colnames):
    if key in adata.obsm_keys():
        for fname in fnames:
            write_text_matrix(adata.obsm[key], os.path.join(file_path, fname),
                              colnames=colnames, transpose=True)


class NBConstantDispAutoencoder(_ConstantDispersion, Autoencoder):
    """One free dispersion per gene (``nb``)."""

    ae_type = "nb"

    def predict(self, adata, mode="denoise", return_info=False, copy=False):
        res = super().predict(adata, mode, return_info, copy)
        adata = res if copy else adata
        if return_info:
            self._store_dispersion(adata)
        return adata if copy else None

    def _write_info(self, adata, file_path, colnames):
        self._write_dispersion(adata, file_path, colnames)


class NBAutoencoder(Autoencoder):
    """Conditional dispersion, the API/CLI default (``nb-conddisp``)."""

    ae_type = "nb-conddisp"

    def predict(self, adata, mode="denoise", return_info=False, copy=False):
        res = super().predict(adata, mode, return_info, copy)
        adata = res if copy else adata
        if return_info:
            # the reference's order: info computed after denoising, from
            # the current (denoised) adata.X, unscaled -- a separate forward
            out = self.forward(adata.X, size_factors(adata), keys=("disp",))
            adata.obsm["X_dca_dispersion"] = out["disp"]
        return adata if copy else None

    def _write_info(self, adata, file_path, colnames):
        _write_obsm(adata, "X_dca_dispersion", file_path, ("dispersion.tsv",), colnames)


class NBSharedAutoencoder(NBAutoencoder):
    """One dispersion per cell."""

    ae_type = "nb-shared"


class NBForkAutoencoder(NBAutoencoder):
    """The decoder forks into mean and dispersion branches."""

    ae_type = "nb-fork"


class ZINBAutoencoder(Autoencoder):
    """Zero-inflated NB with conditional dispersion and dropout, the
    flagship architecture (``zinb-conddisp``)."""

    ae_type = "zinb-conddisp"

    def predict(self, adata, mode="denoise", return_info=False, copy=False):
        adata = adata.copy() if copy else adata
        # one forward serves the info quirk (the pre-denoise input) and the
        # base keys
        keys = self._PREDICT_KEYS[mode] + (("disp", "pi") if return_info else ())
        out = self.forward(adata.X, size_factors(adata), *scale_stats(adata), keys=keys)
        if return_info:
            adata.obsm["X_dca_dispersion"] = out["disp"]
            adata.obsm["X_dca_dropout"] = out["pi"]
        super().predict(adata, mode, return_info, copy=False, _forward_out=out)
        return adata if copy else None

    def _write_info(self, adata, file_path, colnames):
        _write_obsm(adata, "X_dca_dispersion", file_path, ("dispersion.tsv",), colnames)
        _write_obsm(adata, "X_dca_dropout", file_path, ("dropout.tsv", "pi.tsv"), colnames)


class ZINBAutoencoderElemPi(ZINBAutoencoder):
    """pi as an elementwise function of the negated mean logits; with
    ``sharedpi`` one kernel and bias for every gene."""

    ae_type = "zinb-elempi"

    def __init__(self, sharedpi=False, **kwds):
        super().__init__(**kwds)
        self.sharedpi = sharedpi

    def _definition_kwargs(self):
        return {**super()._definition_kwargs(), "sharedpi": self.sharedpi}

    def _ctor_config(self):
        return {**super()._ctor_config(), "sharedpi": self.sharedpi}


class ZINBSharedAutoencoder(ZINBAutoencoder):
    """One dispersion and one dropout probability per cell."""

    ae_type = "zinb-shared"


class ZINBForkAutoencoder(ZINBAutoencoder):
    """The decoder forks into mean, dispersion and dropout branches."""

    ae_type = "zinb-fork"


class ZINBConstantDispAutoencoder(_ConstantDispersion, Autoencoder):
    """One free dispersion per gene, and a dropout head (``zinb``)."""

    ae_type = "zinb"

    def predict(self, adata, mode="denoise", return_info=False, copy=False):
        adata = adata.copy() if copy else adata
        keys = self._PREDICT_KEYS[mode] + (("pi",) if return_info else ())
        out = self.forward(adata.X, size_factors(adata), *scale_stats(adata), keys=keys)
        if return_info:
            self._store_dispersion(adata)
            adata.obsm["X_dca_dropout"] = out["pi"]
        super().predict(adata, mode, return_info, copy=False, _forward_out=out)
        return adata if copy else None

    def _write_info(self, adata, file_path, colnames):
        self._write_dispersion(adata, file_path, colnames)
        _write_obsm(adata, "X_dca_dropout", file_path, ("dropout.tsv", "pi.tsv"), colnames)


AE_types = {
    "normal": Autoencoder,
    "poisson": PoissonAutoencoder,
    "nb": NBConstantDispAutoencoder,
    "nb-conddisp": NBAutoencoder,
    "nb-shared": NBSharedAutoencoder,
    "nb-fork": NBForkAutoencoder,
    "zinb": ZINBConstantDispAutoencoder,
    "zinb-conddisp": ZINBAutoencoder,
    "zinb-shared": ZINBSharedAutoencoder,
    "zinb-fork": ZINBForkAutoencoder,
    "zinb-elempi": ZINBAutoencoderElemPi,
}


def get_ae_type(name):
    if name not in AE_types:
        raise ValueError(f"ae_type {name!r} is not one of {sorted(AE_types)}")
    return AE_types[name]


class _KerasStubUnpickler(pickle.Unpickler):
    """Unpickle a reference ``model.pickle`` without keras or TensorFlow.

    The reference pickles its (pre-build) Autoencoder object whole; its
    class lives in ``dca.network`` and drags keras symbols along.  Classes
    from those modules are replaced with attribute-bag stubs, so the plain
    constructor attributes (input_size, hidden_size, ...) survive the
    load."""

    STUB_PREFIXES = ("dca", "keras", "tensorflow", "tf_keras")

    def find_class(self, module, name):
        if module.split(".")[0] in self.STUB_PREFIXES:
            stub = type(name, (), {"__module__": module})
            stub._keras_class = name
            return stub
        return super().find_class(module, name)


def _net_from_reference_pickle(obj, device=None):
    """Build a network from an unpickled reference Autoencoder stub."""
    cls_name = getattr(type(obj), "_keras_class", type(obj).__name__)
    by_class = {cls.__name__: key for key, cls in AE_types.items()}
    if cls_name not in by_class:
        raise ValueError(f"model.pickle holds unknown reference class {cls_name!r}")
    d = obj.__dict__
    cfg = {
        k: d[k]
        for k in (
            "input_size", "output_size", "hidden_size", "l2_coef", "l1_coef",
            "l2_enc_coef", "l1_enc_coef", "ridge", "hidden_dropout",
            "input_dropout", "batchnorm", "activation", "init", "file_path",
            "debug",
        )
        if k in d
    }
    if "sharedpi" in d:
        cfg["sharedpi"] = d["sharedpi"]
    return AE_types[by_class[cls_name]](device=device, **cfg).build()


def load_model(path, device=None):
    """Rebuild a network from a ``model.pickle``: this package's or the JAX
    package's payload (``save()``: ae_type, constructor arguments and the
    numpy trees, loaded into the network when present), or one written by
    the reference implementation (its pre-build Keras object, read without
    keras through ``_KerasStubUnpickler``; ``load_weights`` of its
    ``weights.hdf5`` then gives the trained state).  The network is built
    on the CUDA device unless ``device="cpu"``."""
    with open(path, "rb") as f:
        try:
            payload = pickle.load(f)
        except Exception:
            f.seek(0)
            payload = _KerasStubUnpickler(f).load()
    if not isinstance(payload, dict):
        return _net_from_reference_pickle(payload, device)
    net = AE_types[payload["ae_type"]](device=device, **payload["ctor"]).build()
    if payload.get("params") is not None:
        net.load_trees(payload["params"], payload["state"])
    return net
