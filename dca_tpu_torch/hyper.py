"""Hyperparameter search: the port of the JAX package's ``dca_tpu/hyper.py``.

The reference's kopt/hyperopt pipeline with an in-package Tree-structured
Parzen Estimator: the same search space, objective (the least validation
loss of a fit with a 20% split) and artefacts
(``hyperopt_results/trials.pickle`` and ``best.json``).  The space, the TPE
and ``_jsonable`` are the JAX package's numpy code, copied: the same seed
and the same observed losses give the same suggestions.  A trial is a whole
``train()`` fit of the port, on the CUDA device unless ``device="cpu"``; on
the card its steps replay from CUDA graphs, with the ZINB kernels K1/K2 in
them.

``n_parallel > 1`` runs the trials of each batch at once, one worker thread
a trial slot, slot s on CUDA device s mod the device count (the JAX
package's ``jax.default_device`` a thread) and on a stream of its own; two
slots share one card when there is one.  Fits in several threads are safe
on one card: each thread's K1 launches use a workspace of their own
(``ops/fused_loss.py``), the graphs of each fit are captured in turns in
CUDA's thread_local mode on a stream made for their thread
(``train/graphs.py``), and the launch counters take every thread's launches
under one lock (``ops/counters.py``).

A trial's exception is recorded as a loss of inf and the search goes on
(the reference's ``catch_eval_exceptions``), except after the uncaught
pre-flight trial and for a failure of the card or of its kernels
(``ops/_build.KernelError``, a CUDA error), which ends the search: such a
failure says nothing of the trial's configuration, and a search that went
on would record every later trial as failed.
"""

from __future__ import annotations

import json
import math
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .data.io import normalize, read_dataset
from .device import resolve_device
from .models.network import AE_types
from .ops._build import KernelError
from .train.loop import train


# ---------------------------------------------------------------------------
# search space primitives (hyperopt hp.* analogues)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Choice:
    options: tuple

    def sample(self, rs):
        return self.options[rs.randint(len(self.options))]


@dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, rs):
        return float(rs.uniform(self.low, self.high))


@dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rs):
        return float(np.exp(rs.uniform(np.log(self.low), np.log(self.high))))


@dataclass(frozen=True)
class QuantizedUniform:
    """Uniform over [low, high] snapped to multiples of ``q`` (the JAX
    package's grid for the dimensions that are static under jit)."""

    low: float
    high: float
    q: float

    def sample(self, rs):
        return self._snap(rs.uniform(self.low, self.high))

    def _snap(self, x):
        v = round(x / self.q) * self.q
        return float(min(max(v, self.low), self.high))


def reference_space(hyperepoch: int = 100) -> Dict[str, Any]:
    """The exact search space of the reference's ``hyper.py``: what the
    port's CLI searches."""
    return {
        "norm_input_log": Choice((True, False)),
        "norm_input_zeromean": Choice((True, False)),
        "norm_input_sf": Choice((True, False)),
        "lr": LogUniform(1e-3, 1e-2),
        "ridge": LogUniform(1e-7, 1e-1),
        "l1_enc_coef": LogUniform(1e-7, 1e-1),
        "hidden_size": Choice(
            (
                (64, 32, 64),
                (32, 16, 32),
                (64, 64),
                (32, 32),
                (16, 16),
                (16,),
                (32,),
                (64,),
                (128,),
            )
        ),
        "activation": Choice(("relu", "selu", "elu", "PReLU", "linear", "LeakyReLU")),
        "aetype": Choice(("zinb", "zinb-conddisp")),
        "batchnorm": Choice((True, False)),
        "dropout": Uniform(0.0, 0.7),
        "input_dropout": Uniform(0.0, 0.8),
        "epochs": Choice((hyperepoch,)),
    }


def tpu_space(hyperepoch: int = 100) -> Dict[str, Any]:
    """The JAX package's space for a TPU, kept for its API: the reference
    space with the two dropout dimensions quantized to 0.05 steps, which
    bounds the number of distinct XLA programs a search compiles there.  A
    trial of the port compiles no program (it captures two CUDA graphs), so
    its CLI searches :func:`reference_space`."""
    space = reference_space(hyperepoch)
    space["dropout"] = QuantizedUniform(0.0, 0.7, 0.05)
    space["input_dropout"] = QuantizedUniform(0.0, 0.8, 0.05)
    return space


# ---------------------------------------------------------------------------
# TPE engine
# ---------------------------------------------------------------------------


class TPE:
    """Tree-structured Parzen Estimator over an independent product space.

    Classic Bergstra et al. (2011) recipe: after ``n_startup`` random trials,
    split observations at the gamma-quantile into good/bad sets, model each
    numeric dimension with Gaussian Parzen windows l(x) (good) and g(x)
    (bad), draw candidates from l and keep the argmax of l/g; categorical
    dimensions use Laplace-smoothed empirical frequencies.
    """

    def __init__(self, space, seed=0, n_startup=20, gamma=0.25, n_candidates=24):
        self.space = space
        self.rs = np.random.RandomState(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.trials: List[Dict[str, Any]] = []

    # -- observation bookkeeping ------------------------------------------
    def observe(self, config, loss):
        self.trials.append({"config": config, "loss": float(loss)})

    def _split(self):
        # failed (non-finite) trials join the BAD set: dropping them entirely
        # makes the l/g score favor exactly the unexplored failure region
        # (density of both models ~0 there, ratio maximal) and the search
        # walks into the crash zone forever
        ok = [t for t in self.trials if math.isfinite(t["loss"])]
        failed = [t for t in self.trials if not math.isfinite(t["loss"])]
        ok.sort(key=lambda t: t["loss"])
        n_good = max(1, int(np.ceil(self.gamma * len(ok))))
        return ok[:n_good], ok[n_good:] + failed

    # -- proposal ----------------------------------------------------------
    def suggest(self):
        if len([t for t in self.trials if math.isfinite(t["loss"])]) < self.n_startup:
            return {k: d.sample(self.rs) for k, d in self.space.items()}
        good, bad = self._split()
        config = {}
        for key, dist in self.space.items():
            g_vals = [t["config"][key] for t in good]
            b_vals = [t["config"][key] for t in bad]
            if isinstance(dist, Choice):
                config[key] = self._suggest_choice(dist, g_vals, b_vals)
            else:
                config[key] = self._suggest_numeric(dist, g_vals, b_vals)
        return config

    def _suggest_choice(self, dist, g_vals, b_vals):
        opts = list(dist.options)
        gc = np.array([g_vals.count(o) for o in opts], float) + 1.0
        bc = np.array([b_vals.count(o) for o in opts], float) + 1.0
        score = (gc / gc.sum()) / (bc / bc.sum())
        probs = score / score.sum()
        return opts[self.rs.choice(len(opts), p=probs)]

    def _suggest_numeric(self, dist, g_vals, b_vals):
        log = isinstance(dist, LogUniform)
        lo, hi = dist.low, dist.high
        tf = np.log if log else (lambda x: x)
        inv = np.exp if log else (lambda x: x)
        lo_t, hi_t = tf(lo), tf(hi)
        span = hi_t - lo_t

        g = np.asarray([tf(v) for v in g_vals], float)
        b = np.asarray([tf(v) for v in b_vals], float)
        if len(b) == 0:
            b = np.asarray([lo_t, hi_t])

        def parzen_logpdf(x, centers):
            bw = max(span / max(len(centers), 1) * 1.5, 1e-6 * span)
            d = (x[:, None] - centers[None, :]) / bw
            return (
                -0.5 * d**2 - 0.5 * np.log(2 * np.pi) - np.log(bw)
            ).max(axis=1)  # max-kernel approximation, robust and cheap

        # candidates drawn from the good model
        idx = self.rs.randint(len(g), size=self.n_candidates)
        bw = max(span / max(len(g), 1) * 1.5, 1e-6 * span)
        cand = g[idx] + self.rs.normal(scale=bw, size=self.n_candidates)
        cand = np.clip(cand, lo_t, hi_t)
        score = parzen_logpdf(cand, g) - parzen_logpdf(cand, b)
        x = cand[int(np.argmax(score))]
        val = float(inv(x))
        val = min(max(val, lo), hi)
        if isinstance(dist, QuantizedUniform):
            val = dist._snap(val)
        return val


# ---------------------------------------------------------------------------
# objective + search
# ---------------------------------------------------------------------------


def _objective(adata_orig, config, debug=False, verbose=False, batch_size=32, seed=0,
               device=None):
    """One trial: normalize a copy per the data flags (with the filtering
    of normalize's defaults, as the reference's data function), build and
    train with a 20% validation split; return the least validation loss."""
    ad = normalize(
        adata_orig.copy(),
        filter_min_counts=True,
        size_factors=config["norm_input_sf"],
        logtrans_input=config["norm_input_log"],
        normalize_input=config["norm_input_zeromean"],
    )

    net = AE_types[config["aetype"]](
        input_size=ad.n_vars,
        hidden_size=config["hidden_size"],
        l2_coef=0.0,
        l1_coef=0.0,
        l2_enc_coef=0.0,
        l1_enc_coef=config["l1_enc_coef"],
        ridge=config["ridge"],
        hidden_dropout=config["dropout"],
        input_dropout=config["input_dropout"],
        batchnorm=config["batchnorm"],
        activation=config["activation"],
        init="glorot_uniform",
        debug=debug,
        seed=seed,
        device=device,
    )
    net.build()

    hist = train(
        ad,
        net,
        optimizer="RMSprop",
        learning_rate=config["lr"],
        epochs=config["epochs"],
        batch_size=batch_size,
        clip_grad=5.0,
        validation_split=0.2,
        reduce_lr=0,
        early_stop=0,
        verbose=verbose,
        seed=seed,
    )
    vals = hist.history.get("val_loss", hist.history["loss"])
    finite = [v for v in vals if math.isfinite(v)]
    return min(finite) if finite else float("inf")


def _fatal(e):
    """Whether a trial's exception ends the search: a kernel that failed to
    build, load or launch, or a CUDA error of the card.  A configuration
    too large for the card (out of memory) fails its trial only."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    accelerator_error = getattr(torch, "AcceleratorError", ())
    return (isinstance(e, (KernelError, accelerator_error))
            or (isinstance(e, RuntimeError) and "CUDA error" in str(e)))


def hyper_search(
    adata,
    n_trials: int,
    hyperepoch: int = 100,
    output_dir: str = ".",
    seed: int = 0,
    space: Optional[dict] = None,
    objective=None,
    verbose=True,
    debug=False,
    n_parallel: int = 1,
    device=None,
):
    """Run the TPE search; write ``trials.pickle`` and ``best.json`` under
    ``output_dir/hyperopt_results``.  Returns (best_config, best_loss,
    trials).

    ``trials`` holds ``n_trials + 1`` observations: the uncaught pre-flight
    evaluation (the reference's test_fn, run in addition to its max_evals
    budget) followed by ``n_trials`` trials whose exceptions are caught
    (but for a failure of the card or its kernels, see the module's
    docstring).

    ``n_parallel > 1`` evaluates trials in synchronous batches of that
    size, at most max(device count, 2) and ``n_trials``, one worker thread
    a trial (the module's docstring): a batch of configs is suggested from
    the current TPE state, evaluated at once and observed in suggestion
    order, so the search is deterministic for a seed and the same as the
    sequential one through the TPE's 20 start-up suggestions, which do not
    depend on the observations.  ``device``: where the default objective
    fits, the CUDA device unless "cpu"."""
    device = resolve_device(device)
    space = space or reference_space(hyperepoch)
    tpe = TPE(space, seed=seed)
    results_dir = os.path.join(output_dir, "hyperopt_results")
    os.makedirs(results_dir, exist_ok=True)
    objective = objective or (
        lambda cfg: _objective(adata, cfg, debug=debug, seed=seed, device=device)
    )

    pool = None
    if n_parallel > 1:
        cuda = device.type == "cuda"
        n_devices = torch.cuda.device_count() if cuda else 1
        # not capped at the device count: on one card two threads overlap
        # one trial's host work (normalize, build, the epoch's read-back)
        # with the other's steps
        n_parallel = min(n_parallel, max(n_devices, 2), n_trials)
        slots = [torch.device("cuda", s % n_devices) if cuda else device
                 for s in range(n_parallel)]
        streams = [torch.cuda.Stream(d) for d in slots] if cuda else None
        pool = ThreadPoolExecutor(max_workers=n_parallel)

        def run_on(slot, cfg):
            if streams is None:
                return float(objective(cfg))
            with torch.cuda.device(slots[slot]), torch.cuda.stream(streams[slot]):
                return float(objective(cfg))

    best_cfg, best_loss = None, float("inf")

    def _record(i, cfg, loss):
        nonlocal best_cfg, best_loss
        tpe.observe(cfg, loss)
        if loss < best_loss:
            best_cfg, best_loss = cfg, loss
        if verbose:
            label = "preflight" if i == 0 else f"trial {i}/{n_trials}"
            print(f"dca_tpu_torch hyper: {label} loss={loss:.4f} best={best_loss:.4f}")

    def _failed(i, e):
        if _fatal(e):
            raise e
        if verbose:
            print(f"dca_tpu_torch hyper: trial {i} failed: {e}")
        return float("inf")

    try:
        # the pre-flight (the reference's test_fn): uncaught, so a broken
        # space or objective stops the search with its own traceback; it
        # runs outside the n_trials budget, and its result is observed
        n_total = n_trials + 1
        cfg0 = tpe.suggest()
        _record(0, cfg0, float(objective(cfg0)))

        i = 1
        while i < n_total:
            batch = [tpe.suggest()
                     for _ in range(min(max(n_parallel, 1), n_total - i))]
            results = []
            if pool is not None and len(batch) > 1:
                futs = [pool.submit(run_on, s, cfg) for s, cfg in enumerate(batch)]
                for k, f in enumerate(futs):
                    try:
                        results.append(float(f.result()))
                    except Exception as e:  # the reference's catch_eval_exceptions
                        results.append(_failed(i + k, e))
            else:
                for k, cfg in enumerate(batch):
                    try:
                        results.append(float(objective(cfg)))
                    except Exception as e:  # the reference's catch_eval_exceptions
                        results.append(_failed(i + k, e))
            for cfg, loss in zip(batch, results):
                _record(i, cfg, loss)
                i += 1
    finally:
        if pool is not None:
            # no trial outlives the search, also when one ends it
            pool.shutdown(wait=True, cancel_futures=True)
            for s in streams or ():
                s.synchronize()

    with open(os.path.join(results_dir, "trials.pickle"), "wb") as f:
        pickle.dump(tpe.trials, f)
    with open(os.path.join(results_dir, "best.json"), "wt") as f:
        json.dump(
            # a bare Infinity is not valid JSON: a search whose every trial
            # failed records loss: null
            {"loss": best_loss if math.isfinite(best_loss) else None,
             "config": _jsonable(best_cfg)},
            f,
            sort_keys=True,
            indent=4,
        )
    return best_cfg, best_loss, tpe.trials


def _jsonable(cfg):
    if cfg is None:
        return None
    out = {}
    for k, v in cfg.items():
        if isinstance(v, tuple):
            out[k] = list(v)
        elif isinstance(v, (np.bool_, np.integer, np.floating)):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def retrain_best(adata, best_cfg, seed=0, device=None):
    """Refit the winning configuration, with the trial's preprocessing and
    ``train``'s defaults.  Returns the trained network."""
    ad = normalize(
        adata.copy(),
        filter_min_counts=True,
        size_factors=best_cfg["norm_input_sf"],
        logtrans_input=best_cfg["norm_input_log"],
        normalize_input=best_cfg["norm_input_zeromean"],
    )
    net = AE_types[best_cfg["aetype"]](
        input_size=ad.n_vars,
        hidden_size=best_cfg["hidden_size"],
        l1_enc_coef=best_cfg["l1_enc_coef"],
        ridge=best_cfg["ridge"],
        hidden_dropout=best_cfg["dropout"],
        input_dropout=best_cfg["input_dropout"],
        batchnorm=best_cfg["batchnorm"],
        activation=best_cfg["activation"],
        seed=seed,
        device=device,
    )
    net.build()
    train(ad, net, learning_rate=best_cfg["lr"], epochs=best_cfg["epochs"], seed=seed,
          verbose=False)
    return net


def hyper(args):
    """The CLI's search (``--hyper``): read the dataset and search the
    reference space on ``--device``, DCA_TPU_HYPER_PARALLEL trials at once
    (default: the CUDA device count when above 1, else 2)."""
    device = resolve_device(args.device)
    n_devices = torch.cuda.device_count()
    n_parallel = int(os.environ.get("DCA_TPU_HYPER_PARALLEL",
                                    n_devices if n_devices > 1 else 2))
    # transpose as given, not negated as the fit's CLI reads it: the JAX
    # package's hyper(args) does the same
    adata = read_dataset(args.input, transpose=args.transpose, test_split=False)
    best_cfg, best_loss, _ = hyper_search(
        adata,
        n_trials=args.hypern,
        hyperepoch=args.hyperepoch,
        output_dir=args.outputdir,
        debug=args.debug,
        n_parallel=n_parallel,
        device=device,
    )
    print({"loss": best_loss, "config": _jsonable(best_cfg)})
    return best_cfg
