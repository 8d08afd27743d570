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
``reduced.tsv`` and ``pi.tsv``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import losses
from ..data.io import densify, size_factors, write_text_matrix
from ..device import resolve_device
from ..ops.fused_loss import nb_nll_fused, zinb_nll_fused
from . import core

# rows per predict block: about this many bytes of input and outputs
_PREDICT_BLOCK_BYTES = 2_000_000_000


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
    def apply(self, count, size_factors, training=False, generator=None):
        return core.apply(self.definition, self.model, count, size_factors,
                          training=training, generator=generator)

    def likelihood_loss(self, outputs, target):
        """Negative log-likelihood of the forward outputs (no weight penalty).

        MSE and Poisson are the plain losses.  NB and ZINB go through the
        fused kernels (``ops/fused_loss.py``), which take every dispersion
        and dropout shape the architectures give ((B, G), (1, G), (B, 1))
        and raise on any other; ``debug`` (the finite-ness sanitizer) uses
        the plain ``losses.nb_nll``/``zinb_nll``, as in the JAX package.
        Masking is on: identical to the reference's default on finite
        targets, and NaN targets are masked by the reference's rules.
        Weighted batches wait for the weighted kernels (ROADMAP.md, Queue 2)."""
        lk = self.definition.likelihood
        out = outputs["output"]
        if lk == "mse":
            return losses.mse_loss(target, out)
        if lk == "poisson":
            return losses.poisson_loss(target, out)
        disp, pi = outputs["disp"], outputs["pi"]
        if self.definition.debug:
            if lk == "nb":
                return losses.nb_nll(target, out, disp, masking=True, debug=True)
            return losses.zinb_nll(target, out, disp, pi, ridge_lambda=self.ridge,
                                   masking=True, debug=True)
        y = target.to(torch.float32).contiguous()
        if lk == "nb":
            return nb_nll_fused(y, out, disp)
        return zinb_nll_fused(y, out, disp, pi, self.ridge)

    def loss_fn(self, count, size_factors, target, training, generator=None):
        """Total loss = NLL + l1/l2 weight penalties.  Returns (loss,
        new batch-norm state)."""
        outputs, new_state = self.apply(count, size_factors, training=training,
                                        generator=generator)
        loss = self.likelihood_loss(outputs, target)
        loss = loss + core.regularization_loss(self.definition, self.model)
        return loss, new_state

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def forward(self, count, sf=None, keys=None):
        """Eval-mode forward over a full matrix, block by block; returns a
        dict of numpy outputs (only ``keys`` when given)."""
        assert self.model is not None, "call build() first"
        n = count.shape[0]
        sf = np.ones((n,), np.float32) if sf is None else np.asarray(sf, np.float32)
        G = max(self.input_size, self.output_size, 1)
        n_keys = len(keys) if keys is not None else 5
        chunk_rows = int(max(1024, min(32768, _PREDICT_BLOCK_BYTES
                                       // (4 * G * (n_keys + 1)))))
        pieces = []
        with torch.no_grad():
            for lo in range(0, max(n, 1), chunk_rows):
                hi = min(lo + chunk_rows, n)
                # torch.tensor copies: adata's arrays may be read-only views
                x = torch.tensor(densify(count[lo:hi]), device=self.device)
                out, _ = self.apply(x, torch.tensor(sf[lo:hi], device=self.device),
                                    training=False)
                pieces.append({k: None if v is None else v.cpu().numpy()
                               for k, v in out.items()
                               if keys is None or k in keys})
        if len(pieces) == 1:
            return pieces[0]
        rows0 = min(chunk_rows, n)
        # per-row outputs are concatenated; per-gene constants (the constant
        # dispersion head's (1, G)) are the same in every block
        return {k: v if v is None or v.shape[0] != rows0
                else np.concatenate([p[k] for p in pieces], axis=0)
                for k, v in pieces[0].items()}

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
            out = self.forward(adata.X, size_factors(adata),
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
    def save(self):
        """Pickle the network to <file_path>/model.pickle, in the JAX
        package's payload format (ae_type, constructor arguments, and the
        params/state trees as numpy arrays, or None before build)."""
        if not self.file_path:
            return
        params = state = None
        if self.model is not None:
            sd = {k: v.detach().cpu().numpy() for k, v in self.model.state_dict().items()}
            params, state = {"trunk": {}, "branches": {}, "heads": {}}, \
                {"trunk": {}, "branches": {}}
            for key, value in sd.items():
                # group.layer.leaf, or branches.branch.layer.leaf
                *path, leaf = key.split(".")
                node = state if leaf in ("moving_mean", "moving_var") else params
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = value
        payload = dict(ae_type=self.ae_type, ctor=self._ctor_config(),
                       params=params, state=state)
        os.makedirs(self.file_path, exist_ok=True)
        with open(os.path.join(self.file_path, "model.pickle"), "wb") as f:
            pickle.dump(payload, f)

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
                mean_norm = self.forward(adata.X, size_factors(adata),
                                         keys=("mean_norm",))["mean_norm"]
            write_text_matrix(mean_norm, os.path.join(file_path, "mean_norm.tsv"),
                              rownames=rownames, colnames=colnames, transpose=True)

        if mode in ("latent", "full") and "X_dca" in adata.obsm:
            print("dca_tpu_torch: Saving latent representations...")
            for fname in ("latent.tsv", "reduced.tsv"):
                write_text_matrix(adata.obsm["X_dca"], os.path.join(file_path, fname),
                                  rownames=rownames, transpose=False)


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

    def write(self, adata, file_path, mode="denoise", colnames=None):
        colnames = adata.var_names.values if colnames is None else colnames
        super().write(adata, file_path, mode, colnames=colnames)
        self._write_dispersion(adata, file_path, colnames)


class NBAutoencoder(Autoencoder):
    """Conditional dispersion, the API/CLI default (``nb-conddisp``)."""

    ae_type = "nb-conddisp"

    def predict(self, adata, mode="denoise", return_info=False, copy=False):
        res = super().predict(adata, mode, return_info, copy)
        adata = res if copy else adata
        if return_info:
            # the reference's order: info computed after denoising, from
            # the current (denoised) adata.X -- a separate forward
            out = self.forward(adata.X, size_factors(adata), keys=("disp",))
            adata.obsm["X_dca_dispersion"] = out["disp"]
        return adata if copy else None

    def write(self, adata, file_path, mode="denoise", colnames=None):
        colnames = adata.var_names.values if colnames is None else colnames
        super().write(adata, file_path, mode, colnames=colnames)
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
        out = self.forward(adata.X, size_factors(adata), keys=keys)
        if return_info:
            adata.obsm["X_dca_dispersion"] = out["disp"]
            adata.obsm["X_dca_dropout"] = out["pi"]
        super().predict(adata, mode, return_info, copy=False, _forward_out=out)
        return adata if copy else None

    def write(self, adata, file_path, mode="denoise", colnames=None):
        colnames = adata.var_names.values if colnames is None else colnames
        super().write(adata, file_path, mode, colnames=colnames)
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
        out = self.forward(adata.X, size_factors(adata), keys=keys)
        if return_info:
            self._store_dispersion(adata)
            adata.obsm["X_dca_dropout"] = out["pi"]
        super().predict(adata, mode, return_info, copy=False, _forward_out=out)
        return adata if copy else None

    def write(self, adata, file_path, mode="denoise", colnames=None):
        colnames = adata.var_names.values if colnames is None else colnames
        super().write(adata, file_path, mode, colnames=colnames)
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
