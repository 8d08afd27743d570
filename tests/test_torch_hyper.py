"""The port's hyperparameter search (``dca_tpu_torch/hyper.py``) against the
JAX package's ``dca_tpu/hyper.py`` on the CPU: the same spaces, the same
TPE suggestions for the same observations, the same trials, pickle and
``best.json`` for a deterministic objective, the objective's calls of
normalize, the network and train with the same arguments, and its loss on
bridged weights within rtol 1e-4; the cases of tests/test_hyper.py on the
port; a kernel or CUDA failure ending the search; the CLI's ``--hyper``;
and the launch counters exact under threads."""

import dataclasses
import json
import os
import pickle
import sys
import threading
import time
import types

import numpy as np
import pandas as pd
import pytest
import torch

import jax

import dca_tpu.data.io as jio
import dca_tpu.models as jmodels
import dca_tpu.train.loop as jloop
from dca_tpu import hyper as jhyper
from dca_tpu.data.adata import AnnData as JAnnData

import dca_tpu_torch.hyper as hyper
from conftest import make_counts
from dca_tpu_torch.__main__ import main
from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models import network
from dca_tpu_torch.ops import counters, fused_loss
from dca_tpu_torch.ops._build import KernelError

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

CPU = "cpu"


def _adata(n_cells, n_genes, seed, jax_side=False):
    X = make_counts(n_cells, n_genes, seed)
    obs = pd.DataFrame(index=pd.Index([f"cell{i}" for i in range(n_cells)]))
    var = pd.DataFrame(index=pd.Index([f"gene{i}" for i in range(n_genes)]))
    return (JAnnData if jax_side else AnnData)(X, obs, var)


def _same_dist(a, b):
    return type(a).__name__ == type(b).__name__ and dataclasses.astuple(a) == \
        dataclasses.astuple(b)


@pytest.mark.parametrize("make", ["reference_space", "tpu_space"])
def test_spaces_equal_jax(make):
    ours, theirs = getattr(hyper, make)(7), getattr(jhyper, make)(7)
    assert list(ours) == list(theirs)
    assert all(_same_dist(ours[k], theirs[k]) for k in ours)


def _observed_loss(cfg, k):
    """A deterministic loss of a configuration, inf for one in four."""
    if k % 4 == 3:
        return float("inf")
    return (np.log10(cfg["lr"]) + 2.5) ** 2 + cfg["dropout"] + (cfg["aetype"] == "zinb") \
        + len(cfg["hidden_size"]) * 0.1


@pytest.mark.parametrize("n_startup", [20, 10])
def test_tpe_suggests_as_jax(n_startup):
    """40 rounds, past the start-up suggestions, with inf losses among the
    observations: the same configurations, bit for bit."""
    ours = hyper.TPE(hyper.reference_space(5), seed=3, n_startup=n_startup)
    theirs = jhyper.TPE(jhyper.reference_space(5), seed=3, n_startup=n_startup)
    for k in range(40):
        cfg = ours.suggest()
        assert cfg == theirs.suggest(), k
        loss = _observed_loss(cfg, k)
        ours.observe(cfg, loss)
        theirs.observe(cfg, loss)
    assert ours.trials == theirs.trials


def _stub(cfg):
    if cfg["activation"] == "elu" and cfg["batchnorm"]:
        raise ValueError("a configuration the objective refuses")
    return _observed_loss(cfg, int(cfg["lr"] * 1e4))


@pytest.mark.parametrize("n_parallel", [1, 2])
def test_hyper_search_same_trials_pickle_and_best_as_jax(tmp_path, n_parallel):
    kw = dict(n_trials=30, hyperepoch=3, seed=1, objective=_stub, verbose=False,
              n_parallel=n_parallel)
    ours = hyper.hyper_search(_adata(20, 8, 1), output_dir=str(tmp_path / "port"), device=CPU,
                              **kw)
    theirs = jhyper.hyper_search(_adata(20, 8, 1, True), output_dir=str(tmp_path / "jax"), **kw)
    assert ours[0] == theirs[0] and ours[1] == theirs[1] and ours[2] == theirs[2]
    assert any(t["loss"] == float("inf") for t in ours[2])
    for name in ("trials.pickle", "best.json"):
        with open(tmp_path / "port" / "hyperopt_results" / name, "rb") as f:
            got = f.read()
        with open(tmp_path / "jax" / "hyperopt_results" / name, "rb") as f:
            assert got == f.read(), name


def test_best_json_records_null_when_every_trial_failed(tmp_path):
    calls = []

    def fails_after_preflight(cfg):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("later trial fails")
        return float("inf")

    hyper.hyper_search(_adata(20, 8, 1), n_trials=2, output_dir=str(tmp_path), device=CPU,
                       objective=fails_after_preflight, verbose=False)
    with open(tmp_path / "hyperopt_results" / "best.json") as f:
        assert json.load(f) == {"config": None, "loss": None}


CFG = {"norm_input_log": True, "norm_input_zeromean": True, "norm_input_sf": True,
       "lr": 3e-3, "ridge": 0.01, "l1_enc_coef": 1e-4, "hidden_size": (16, 8, 16),
       "activation": "relu", "aetype": "zinb-conddisp", "batchnorm": False, "dropout": 0.0,
       "input_dropout": 0.0, "epochs": 3}


def _spy_objective(monkeypatch, mod_norm, mod_train, ae_types, objective, adata):
    """Run ``objective`` with normalize, the config's network class and
    train replaced by spies that record their keywords (train returns a
    one-epoch history without fitting)."""
    calls = {}
    real_norm, real_cls = getattr(mod_norm, "normalize"), ae_types[CFG["aetype"]]

    def normalize(ad, **kw):
        calls["normalize"] = kw
        return real_norm(ad, **kw)

    def ae(**kw):
        calls["network"] = kw
        return real_cls(**kw)

    def train(ad, net, **kw):
        calls["train"] = kw
        calls["shape"] = (ad.n_obs, ad.n_vars, net.input_size)
        return types.SimpleNamespace(history={"loss": [2.0], "val_loss": [1.5]})

    monkeypatch.setattr(mod_norm, "normalize", normalize)
    monkeypatch.setattr(mod_train, "train", train)
    monkeypatch.setitem(ae_types, CFG["aetype"], ae)
    assert objective(adata, CFG) == 1.5
    return calls


def test_objective_calls_normalize_network_and_train_as_jax(monkeypatch):
    ours = _spy_objective(monkeypatch, hyper, hyper, network.AE_types,
                          lambda ad, c: hyper._objective(ad, c, device=CPU), _adata(60, 15, 2))
    theirs = _spy_objective(monkeypatch, jio, jloop, jmodels.AE_types, jhyper._objective,
                            _adata(60, 15, 2, True))
    assert ours["normalize"] == theirs["normalize"]
    assert ours["network"].pop("device") == CPU
    assert ours["network"] == theirs["network"]
    assert ours["train"] == theirs["train"]
    assert ours["shape"] == theirs["shape"]


def test_objective_loss_on_bridged_weights_matches_jax(monkeypatch):
    """One trial with dropout 0 and no BatchNorm: the JAX trial network's
    initial parameters carried into the port's (``bridge.py``), the same
    np.random permutations (one seed), the JAX side's fused loss in
    interpret mode; min(val_loss) within rtol 1e-4."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    built = {}
    jcls = jmodels.AE_types[CFG["aetype"]]

    def jspy(**kw):
        built["kw"] = kw
        return jcls(**kw)

    monkeypatch.setitem(jmodels.AE_types, CFG["aetype"], jspy)
    theirs = jhyper._objective(_adata(200, 50, 4, True), CFG, seed=0)
    jnet = jcls(**built["kw"]).build()  # the same seed: the trial's initial parameters
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))

    class Bridged(network.AE_types[CFG["aetype"]]):
        def build(self):
            super().build()
            self.model.load_state_dict(state)
            return self

    monkeypatch.setitem(network.AE_types, CFG["aetype"], Bridged)
    ours = hyper._objective(_adata(200, 50, 4), CFG, seed=0, device=CPU)
    assert np.isfinite(ours)
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


# tests/test_hyper.py's cases, on the port


def test_reference_space_matches_reference():
    space = hyper.reference_space(hyperepoch=77)
    assert set(space) == {
        "norm_input_log", "norm_input_zeromean", "norm_input_sf",
        "lr", "ridge", "l1_enc_coef", "hidden_size", "activation",
        "aetype", "batchnorm", "dropout", "input_dropout", "epochs",
    }
    assert space["aetype"].options == ("zinb", "zinb-conddisp")
    assert len(space["hidden_size"].options) == 9
    assert space["epochs"].options == (77,)


def test_tpu_space_is_compile_stable():
    ref, tpu = hyper.reference_space(50), hyper.tpu_space(50)
    assert set(ref) == set(tpu)
    for k in ref:
        if k in ("dropout", "input_dropout"):
            assert isinstance(tpu[k], hyper.QuantizedUniform)
            assert (tpu[k].low, tpu[k].high) == (ref[k].low, ref[k].high)
        else:
            assert tpu[k] == ref[k]
    rs = np.random.RandomState(0)
    draws = [tpu["dropout"].sample(rs) for _ in range(200)]
    assert all(abs(d / 0.05 - round(d / 0.05)) < 1e-9 for d in draws)
    assert all(0.0 <= d <= 0.7 for d in draws)
    assert len(set(draws)) <= 15
    tpe = hyper.TPE({"dropout": tpu["dropout"]}, seed=0, n_startup=5)
    for _ in range(10):
        cfg = tpe.suggest()
        d = cfg["dropout"]
        assert abs(d / 0.05 - round(d / 0.05)) < 1e-9
        tpe.observe(cfg, (d - 0.3) ** 2)


def test_tpe_converges_on_quadratic():
    space = {
        "x": hyper.Uniform(-5.0, 5.0),
        "y": hyper.LogUniform(1e-3, 1e3),
        "c": hyper.Choice(("good", "bad")),
    }

    def objective(cfg):
        penalty = 0.0 if cfg["c"] == "good" else 5.0
        return (cfg["x"] - 2.0) ** 2 + (np.log10(cfg["y"]) - 1.0) ** 2 + penalty

    tpe = hyper.TPE(space, seed=0, n_startup=15)
    best = np.inf
    for _ in range(80):
        cfg = tpe.suggest()
        loss = objective(cfg)
        tpe.observe(cfg, loss)
        best = min(best, loss)
    assert best < 0.3, best
    late = [t["config"] for t in tpe.trials[-20:]]
    assert np.mean([c["c"] == "good" for c in late]) > 0.6


def test_tpe_handles_failures():
    tpe = hyper.TPE({"x": hyper.Uniform(0, 1)}, seed=1, n_startup=8)
    for _ in range(60):
        cfg = tpe.suggest()
        loss = float("inf") if cfg["x"] > 0.6 else cfg["x"]
        tpe.observe(cfg, loss)
    late = [t["config"]["x"] for t in tpe.trials[-20:]]
    assert all(0 <= x <= 1 for x in late)
    assert np.mean(late) < 0.45, np.mean(late)


def test_hyper_search_end_to_end(tmp_path):
    best_cfg, best_loss, trials = hyper.hyper_search(
        _adata(60, 15, 12), n_trials=2, hyperepoch=1, output_dir=str(tmp_path), seed=0,
        verbose=False, device=CPU)
    assert len(trials) == 3
    assert best_cfg is not None
    assert np.isfinite(best_loss)
    out = os.path.join(str(tmp_path), "hyperopt_results")
    assert os.path.exists(os.path.join(out, "trials.pickle"))
    with open(os.path.join(out, "best.json")) as f:
        best = json.load(f)
    assert "config" in best and "loss" in best
    assert best["config"]["aetype"] in ("zinb", "zinb-conddisp")


def test_preflight_fails_fast_on_broken_objective(tmp_path):
    def broken(cfg):
        raise RuntimeError("objective misconfigured")

    with pytest.raises(RuntimeError, match="objective misconfigured"):
        hyper.hyper_search(_adata(30, 10, 3), n_trials=5, output_dir=str(tmp_path),
                           objective=broken, verbose=False, device=CPU)


def test_post_preflight_failures_still_caught(tmp_path):
    calls = []

    def flaky(cfg):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("later trial fails")
        return 1.0

    best_cfg, best_loss, trials = hyper.hyper_search(
        _adata(30, 10, 3), n_trials=3, output_dir=str(tmp_path), objective=flaky,
        verbose=False, device=CPU)
    assert len(trials) == 4
    assert best_loss == 1.0
    assert [t["loss"] for t in trials[1:]] == [float("inf")] * 3


def test_single_chip_two_thread_pipeline(tmp_path):
    adata = _adata(30, 10, 3)

    def slow_objective(cfg):
        time.sleep(0.15)  # stands in for host prep + device wait
        return float(cfg["dropout"])

    def run(n_parallel, sub):
        t0 = time.perf_counter()
        out = hyper.hyper_search(adata, n_trials=8, output_dir=str(tmp_path / sub), seed=0,
                                 verbose=False, objective=slow_objective,
                                 n_parallel=n_parallel, device=CPU)
        return out, time.perf_counter() - t0

    (cfg_s, loss_s, trials_s), t_seq = run(1, "seq")
    (cfg_p, loss_p, trials_p), t_par = run(2, "par")
    assert cfg_p == cfg_s and loss_p == loss_s
    assert [t["config"] for t in trials_p] == [t["config"] for t in trials_s]
    assert t_par < t_seq * 0.85, (t_seq, t_par)


def test_parallel_search_matches_sequential(tmp_path):
    adata = _adata(50, 12, 5)

    def run(n_parallel, sub):
        return hyper.hyper_search(adata, n_trials=6, hyperepoch=1,
                                  output_dir=str(tmp_path / sub), seed=0, verbose=False,
                                  n_parallel=n_parallel, device=CPU)

    cfg_s, loss_s, trials_s = run(1, "seq")
    cfg_p, loss_p, trials_p = run(4, "par")
    assert cfg_p == cfg_s
    assert loss_p == pytest.approx(loss_s, rel=1e-6)
    assert [t["config"] for t in trials_p] == [t["config"] for t in trials_s]
    np.testing.assert_allclose([t["loss"] for t in trials_p], [t["loss"] for t in trials_s],
                               rtol=1e-5)


# failures that end the search


@pytest.mark.parametrize("n_parallel", [1, 2])
def test_kernel_error_in_a_trial_ends_the_search(monkeypatch, tmp_path, n_parallel):
    """A kernel that fails inside a trial after the pre-flight (here the
    K1 wrapper's plain version, as a launch failure would) is raised out
    of hyper_search, not recorded as a trial's inf; no trial thread
    outlives the search, and nothing is written."""
    fits = []
    real_train, real_fwd = hyper.train, fused_loss._fwd_out_reference

    def train(*args, **kw):
        fits.append(1)
        return real_train(*args, **kw)

    def fwd(*args, **kw):
        if len(fits) > 1:
            raise KernelError("zinb_nll_fwd (K1) launch failed: CUDA error 719 "
                              "(unspecified launch failure)")
        return real_fwd(*args, **kw)

    monkeypatch.setattr(hyper, "train", train)
    monkeypatch.setattr(fused_loss, "_fwd_out_reference", fwd)
    threads = threading.active_count()
    with pytest.raises(KernelError, match="launch failed"):
        hyper.hyper_search(_adata(60, 15, 12), n_trials=4, hyperepoch=1,
                           output_dir=str(tmp_path), verbose=False, n_parallel=n_parallel,
                           device=CPU)
    assert len(fits) > 1
    assert threading.active_count() == threads
    assert not os.path.exists(tmp_path / "hyperopt_results" / "trials.pickle")


@pytest.mark.parametrize("exc,ends", [
    (KernelError("nvcc failed with exit code 1"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("mat1 and mat2 shapes cannot be multiplied"), False),
    (FloatingPointError("loss is not finite"), False),
], ids=["kernel", "cuda-error", "out-of-memory", "runtime", "other"])
def test_which_trial_failures_end_the_search(tmp_path, exc, ends):
    """A failure of the card or of its kernels ends the search; any other
    exception of a trial (too large a configuration included) is recorded
    as inf, as in the JAX package."""
    calls = []

    def objective(cfg):
        calls.append(1)
        if len(calls) > 1:
            raise exc
        return 1.0

    kw = dict(n_trials=3, output_dir=str(tmp_path), objective=objective, verbose=False,
              device=CPU)
    if ends:
        with pytest.raises(type(exc)):
            hyper.hyper_search(_adata(30, 10, 3), **kw)
        assert len(calls) == 2
    else:
        _, best_loss, trials = hyper.hyper_search(_adata(30, 10, 3), **kw)
        assert best_loss == 1.0 and [t["loss"] for t in trials[1:]] == [float("inf")] * 3


def test_search_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hyper.hyper_search(_adata(30, 10, 3), n_trials=1, output_dir=str(tmp_path),
                           objective=lambda cfg: 1.0, verbose=False)


def test_retrain_best_fits_the_winning_configuration():
    net = hyper.retrain_best(_adata(60, 15, 12), dict(CFG, epochs=1), device=CPU)
    assert net.model is not None and net.hidden_size == CFG["hidden_size"]
    assert net.device == torch.device(CPU)


# the CLI


@pytest.mark.parametrize("transpose", [False, True], ids=["as-is", "transposed"])
def test_cli_hyper_on_the_cpu_writes_both_artefacts(monkeypatch, tmp_path, transpose):
    """--hyper (refused before this slice) runs the search and writes
    hyperopt_results/{trials.pickle,best.json}; the table is read with
    -t/--transpose as given, not negated as the fit reads it (the JAX
    package's hyper(args) does the same)."""
    monkeypatch.delenv("DCA_TPU_HYPER_PARALLEL", raising=False)
    counts = make_counts(40, 12, seed=6)  # cells x genes
    table = pd.DataFrame(counts.astype(int), index=[f"cell{i}" for i in range(40)],
                         columns=[f"gene{i}" for i in range(12)])
    tsv = str(tmp_path / "counts.tsv")
    (table.T if transpose else table).to_csv(tsv, sep="\t")
    shapes = []
    real = hyper.read_dataset

    def read_dataset(*args, **kw):
        ad = real(*args, **kw)
        shapes.append(ad.X.shape)
        return ad

    monkeypatch.setattr(hyper, "read_dataset", read_dataset)
    out = tmp_path / "out"
    main([tsv, str(out), "--hyper", "--hypern", "2", "--hyperepoch", "1", "--device", "cpu",
          *(["-t"] if transpose else [])])
    assert shapes == [(40, 12)]
    with open(out / "hyperopt_results" / "trials.pickle", "rb") as f:
        trials = pickle.load(f)
    assert len(trials) == 3
    with open(out / "hyperopt_results" / "best.json") as f:
        best = json.load(f)
    assert best["config"]["epochs"] == 1 and np.isfinite(best["loss"])


# the launch counters under threads


def test_launch_counters_exact_under_threads():
    """16 threads record launches at once, half of them inside a capture's
    tally credited 3 times: no update is lost and no thread's launches go
    into another's tally."""
    counter = {"a": 0, "b": 0}
    n = 2000
    errors = []

    def work(i):
        try:
            stream = 10_000 + i  # each thread's own stream handle
            if i % 2:
                with counters.capturing(stream) as tally:
                    for _ in range(n):
                        counters.record(counter, ["a", "b"], stream)
                counters.add(tally, 3)
            else:
                for _ in range(n):
                    counters.record(counter, ["a"], stream)
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert counter == {"a": 8 * n + 8 * 3 * n, "b": 8 * 3 * n}
    with pytest.raises(RuntimeError, match="already"):
        with counters.capturing(1), counters.capturing(1):
            pass
