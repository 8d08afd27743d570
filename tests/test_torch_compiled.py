"""The whole fit on the device (``train(compiled=True)``,
``dca_tpu_torch/train/compiled.py``) against the JAX package's
``compiled=True`` (``dca_tpu/train/compiled.py``) on the CPU.

Both sides start from the same weights (bridged with
``bridge.params_from_jax``) at dropout 0, and the port takes the JAX
program's row orders, drawn here with ``jax.random`` as that program draws
them and injected through ``train(_perms=...)``.  The JAX side runs its
fused loss in interpret mode (DCA_TPU_FUSED_LOSS=1), the same math as the
port's plain version.  Histories are held to rtol 1e-4, the trajectory
tolerance of ``tests/test_torch_train.py`` (float rounding in another
order, grown through the RMSprop steps), and the epochs run exactly;
parameters to rtol 1e-4 with an absolute 1e-4 of each tensor's largest
magnitude, for its elements near 0.  The fits against JAX run without
BatchNorm: with it, the Dense bias before each BatchNorm has an exact
training gradient of zero that RMSprop turns into learning-rate-sized steps
of rounding noise, different in the two packages (``test_torch_tb.py``);
one BatchNorm fit is held on its histories.

The dispatch: ``checkpoint_every``, ``resume`` and ``debug`` take the
Python-epoch loop, as in the JAX package; ``"auto"`` is the Python-epoch
loop; under a 2-rank gloo group (the ranks are this file run as a script)
a split that does not divide the ranks takes the Python-epoch loop with
the JAX package's verbose line, and one that does runs the whole fit,
within rtol 1e-4 of the one-process whole fit (the tolerance of
``tests/test_torch_parallel.py``).
"""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
RANK_TIMEOUT = 240  # seconds for the group of ranks, start-up included
RTOL = 1e-4
HID = (16, 8, 16)


def _jax_perms(seed, epochs, n_train):
    """The JAX whole-fit program's row orders (its compiled.py:72-75)."""
    import jax

    key = jax.random.fold_in(jax.random.PRNGKey(seed), 2**31 - 2)
    return np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, e), n_train))
                     for e in range(epochs)]).reshape(epochs, n_train)


def _pair(ae_type, counts, **kw):
    """Both packages' data and networks, on the JAX package's initial
    weights, at dropout 0."""
    import jax

    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.models import AE_types as JAE

    from dca_tpu_torch.bridge import params_from_jax
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types

    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    net_kw = dict(input_size=counts.shape[1], hidden_size=HID, hidden_dropout=0.0, seed=7,
                  **kw)
    jnet = JAE[ae_type](**net_kw).build()
    net = AE_types[ae_type](device="cpu", **net_kw).build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    return jad, jnet, ad, net


def _state_dict(jnet):
    import jax

    from dca_tpu_torch.bridge import params_from_jax

    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)).items()}


def _assert_state_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().cpu().numpy() if torch.is_tensor(got[k]) else got[k]
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
                                   err_msg=k)


def _fit_both(monkeypatch, ae_type, counts, fit, net_kw=None, out=None):
    """Both packages' compiled=True fits of ``counts``; returns (the JAX
    history, the port's History, the JAX network, the port's)."""
    from dca_tpu.train.loop import train as jtrain

    from dca_tpu_torch.train.loop import train

    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    jad, jnet, ad, net = _pair(ae_type, counts, **(net_kw or {}))
    n_train = int(counts.shape[0] * (1.0 - fit.get("validation_split", 0.1)))
    perms = _jax_perms(fit["seed"], fit["epochs"], n_train)
    dirs = {}
    if out is not None:
        dirs = {"jax": dict(output_dir=str(out / "jax")),
                "port": dict(output_dir=str(out / "port"))}
    jhist = jtrain(jad, jnet, compiled=True, verbose=False, **fit, **dirs.get("jax", {}))
    hist = train(ad, net, compiled=True, verbose=False, _perms=perms, **fit,
                 **dirs.get("port", {}))
    return jhist.history, hist, jnet, net


def _assert_history_close(got, want):
    assert set(got) == set(want)
    assert len(got["loss"]) == len(want["loss"])  # the epochs run
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("ae_type", ["nb-conddisp", "zinb-conddisp"])
def test_compiled_fit_matches_jax(monkeypatch, ae_type):
    """3 epochs with the default callbacks (none fires): the histories, the
    epochs run and the final parameters."""
    fit = dict(epochs=3, seed=11)
    jh, hist, jnet, net = _fit_both(monkeypatch, ae_type, make_counts(200, 50), fit,
                                    {"batchnorm": False})
    _assert_history_close(hist.history, jh)
    assert hist.fit.epochs_run == 3 and hist.fit.capture_s is None
    _assert_state_close(net.model.state_dict(), _state_dict(jnet))


def test_compiled_fit_with_batchnorm_matches_jax_histories(monkeypatch):
    """zinb-conddisp with BatchNorm and a ridge on pi: the histories (the
    parameters carry the BatchNorm bias noise, see the module's
    docstring)."""
    fit = dict(epochs=3, seed=11)
    jh, hist, _, _ = _fit_both(monkeypatch, "zinb-conddisp", make_counts(200, 50), fit,
                               {"ridge": 0.05})
    _assert_history_close(hist.history, jh)


def test_compiled_callbacks_fire_as_in_jax(monkeypatch, tmp_path):
    """A large learning rate on 50 train rows makes the monitor stall:
    ReduceLROnPlateau cuts the learning rate twice and EarlyStopping ends
    the fit after 9 of 40 epochs, as the JAX program's (at every decision
    the monitor is more than 2e-3 from the value it is compared with, far
    beyond the packages' 1e-4); the history past the stop is NaN.  With
    save_weights, weights.hdf5 holds the JAX package's best state, of the
    6th epoch, and the network keeps the final one."""
    import h5py

    fit = dict(epochs=40, seed=3, learning_rate=0.05, reduce_lr=1, early_stop=3,
               validation_split=0.5, save_weights=True)
    jh, hist, jnet, net = _fit_both(monkeypatch, "nb-conddisp", make_counts(100, 40, seed=5),
                                    fit, {"batchnorm": False}, out=tmp_path)
    _assert_history_close(hist.history, jh)
    n_run = hist.fit.epochs_run
    assert n_run == len(jh["loss"]) < fit["epochs"]
    assert len(set(jh["lr"])) == 3  # ReduceLROnPlateau fired twice
    assert np.isnan(hist.fit.loss[n_run:]).all() and np.isnan(hist.fit.val_loss[n_run:]).all()
    best = int(np.argmin(jh["val_loss"]))
    assert best < n_run - 1  # the best state is not the final one

    _assert_state_close(net.model.state_dict(), _state_dict(jnet))
    with h5py.File(tmp_path / "port" / "weights.hdf5", "r") as got, \
            h5py.File(tmp_path / "jax" / "weights.hdf5", "r") as want:
        keys = []
        want.visit(lambda k: keys.append(k) if isinstance(want[k], h5py.Dataset) else None)
        assert keys
        for k in keys:
            np.testing.assert_allclose(got[k][()], want[k][()], rtol=RTOL,
                                       atol=RTOL * float(np.abs(want[k][()]).max()), err_msg=k)
    assert len(hist.weights_s) == 1


def test_compiled_fit_without_validation_matches_jax(monkeypatch):
    """validation_split=0: the train loss is the monitor and there is no
    val_loss history."""
    fit = dict(epochs=3, seed=11, validation_split=0.0)
    jh, hist, jnet, net = _fit_both(monkeypatch, "zinb-conddisp", make_counts(120, 30), fit,
                                    {"batchnorm": False})
    assert "val_loss" not in hist.history
    _assert_history_close(hist.history, jh)
    assert np.isnan(hist.fit.val_loss).all()
    _assert_state_close(net.model.state_dict(), _state_dict(jnet))


@pytest.mark.parametrize("case", ["no_full_step", "no_trailing_step"])
def test_compiled_edge_splits_match_jax(monkeypatch, case):
    """n_full == 0: every row is held out (validation_split=1.0), so an
    epoch takes no step and its train loss is 0; rem == 0: 160 train rows
    in 5 full batches of 32 and no trailing step."""
    if case == "no_full_step":
        fit = dict(epochs=2, seed=5, validation_split=1.0)
        counts = make_counts(40, 20)
    else:
        fit = dict(epochs=3, seed=5, validation_split=0.2)
        counts = make_counts(200, 30)
    jh, hist, jnet, net = _fit_both(monkeypatch, "nb-conddisp", counts, fit,
                                    {"batchnorm": False})
    _assert_history_close(hist.history, jh)
    _assert_state_close(net.model.state_dict(), _state_dict(jnet))
    if case == "no_full_step":
        assert hist.history["loss"] == [0.0, 0.0]


def _events(out):
    from dca_tpu_torch.tbevents import read_events, read_histograms

    files = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    assert len(files) == 1, files
    scalars = {(s, t): v for s, d in read_events(files[0]) for t, v in d.items()}
    return scalars, read_histograms(files[0])


@pytest.mark.parametrize("ae_type", ["nb-conddisp", "zinb-conddisp"])
def test_compiled_tensorboard_matches_jax(monkeypatch, tmp_path, ae_type):
    """The counterpart of tests/test_tb.py's compiled cases: loss, val_loss
    and lr at every epoch, weights/ and grads/ histograms of the final
    parameters at the last epoch alone, as the JAX program writes them;
    the scalars within rtol 1e-4 of its, the histograms' statistics within
    rtol 1e-3 (test_torch_tb.py's tolerances), and the fit's trace."""
    fit = dict(epochs=3, seed=11, reduce_lr=0, early_stop=0, tensorboard=True)
    _, hist, _, _ = _fit_both(monkeypatch, ae_type, make_counts(200, 50), fit,
                              {"batchnorm": False}, out=tmp_path)
    (gs, gh), (ws, wh) = _events(str(tmp_path / "port")), _events(str(tmp_path / "jax"))
    assert set(gs) == set(ws) and set(gh) == set(wh)
    for key, v in ws.items():
        if v != "histogram":
            np.testing.assert_allclose(gs[key], v, rtol=RTOL, err_msg=str(key))
    for key, stats in wh.items():
        np.testing.assert_allclose([gh[key][s] for s in stats], list(stats.values()),
                                   rtol=1e-3, err_msg=str(key))
    for e in range(3):
        assert gs[(e, "loss")] == pytest.approx(hist.history["loss"][e], rel=1e-6)
        assert gs[(e, "val_loss")] == pytest.approx(hist.history["val_loss"][e], rel=1e-6)
    steps = {s for s, _ in gh}
    assert steps == {2}
    assert any(t.startswith("grads/") for _, t in gh)
    assert glob.glob(str(tmp_path / "port" / "tb" / "*.pt.trace.json"))


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------


def _port_pair(counts, hidden_dropout=0.1, debug=False):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types

    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    nets = [AE_types["zinb-conddisp"](input_size=counts.shape[1], hidden_size=HID,
                                      hidden_dropout=hidden_dropout, debug=debug, seed=2,
                                      device="cpu").build() for _ in range(2)]
    return ad, nets


@pytest.mark.parametrize("kw", ["checkpoint_every", "resume", "debug"])
def test_checkpoints_and_debug_take_the_python_loop(tmp_path, kw):
    """compiled=True with checkpoint_every, resume or a debug network runs
    the Python-epoch loop, as in the JAX package: the bits of
    compiled=False."""
    from dca_tpu_torch.train.loop import train

    ad, nets = _port_pair(make_counts(100, 20), debug=kw == "debug")
    extra = {"checkpoint_every": {"checkpoint_every": 1}, "resume": {"resume": True},
             "debug": {}}[kw]
    hists = [train(ad, net, epochs=2, verbose=False, compiled=compiled,
                   output_dir=str(tmp_path / str(compiled)), **extra)
             for net, compiled in zip(nets, (True, False))]
    assert hists[0].fit is None
    assert hists[0].history == hists[1].history


def test_auto_keeps_the_python_loop():
    """compiled="auto" (the default) is the Python-epoch loop here; True
    the whole fit, which draws the same row orders from the same seed, so
    at dropout 0.1 its final parameters are the loop's bits."""
    from dca_tpu_torch.train.loop import train

    ad, nets = _port_pair(make_counts(100, 20))
    auto = train(ad, nets[0], epochs=3, verbose=False)
    whole = train(ad, nets[1], epochs=3, verbose=False, compiled=True)
    assert auto.fit is None and whole.fit is not None
    assert whole.fit.epochs_run == 3
    np.testing.assert_allclose(whole.history["loss"], auto.history["loss"], rtol=1e-6)
    assert whole.history["val_loss"] == auto.history["val_loss"]
    for k, v in nets[0].model.state_dict().items():
        assert torch.equal(nets[1].model.state_dict()[k], v), k


def test_compiled_epochs_zero_runs_nothing():
    from dca_tpu_torch.train.loop import train

    ad, nets = _port_pair(make_counts(60, 20))
    before = {k: v.clone() for k, v in nets[0].model.state_dict().items()}
    hist = train(ad, nets[0], epochs=0, verbose=False, compiled=True)
    assert hist.history == {} and hist.fit.epochs_run == 0
    for k, v in nets[0].model.state_dict().items():
        assert torch.equal(before[k], v), k


# ---------------------------------------------------------------------------
# two ranks over gloo: this file run as a script
# ---------------------------------------------------------------------------

DP_FIT = dict(epochs=3, batch_size=16, validation_split=0.3, seed=0, reduce_lr=1,
              early_stop=2, learning_rate=0.02)
DP_CELLS = {"padded": 61, "divides": 60}  # 42/19 and 42/18 train/validation rows


def _dp_counts(n_cells):
    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(n_cells, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    return counts


def _dp_fit(case, weights, devices=None, verbose=False):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.train.loop import train

    ad = io.normalize(io.read_dataset(AnnData(_dp_counts(DP_CELLS[case])),
                                      check_counts=False))
    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), device="cpu",
                                    batchnorm=False).build()
    net.model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    return train(ad, net, devices=devices, compiled=True, verbose=verbose, **DP_FIT)


def _rank_main(spec_path):
    """One rank: both cases' compiled=True fits on the group; one RESULT
    line with each fit's history, whether it ran the whole fit, and what
    it printed."""
    import contextlib
    import io as pyio

    torch.set_num_threads(1)
    from dca_tpu_torch.parallel import multihost

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    weights = dict(np.load(spec["weights"]))
    out = {"rank": multihost.process_index()}
    for case in DP_CELLS:
        text = pyio.StringIO()
        with contextlib.redirect_stdout(text):
            hist = _dp_fit(case, weights, devices="all", verbose=True)
        out[case] = {"history": hist.history, "whole_fit": hist.fit is not None,
                     "printed": text.getvalue()}
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


def test_two_ranks_run_the_whole_fit_where_the_split_divides(tmp_path):
    """61 cells (19 validation rows, padded on 2 ranks) take the
    Python-epoch loop with the JAX package's line; 60 cells (42 and 18
    rows) run the whole fit, every rank the same history, within rtol 1e-4
    of the one-process whole fit, its callbacks firing."""
    from dca_tpu_torch.models.network import AE_types

    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), device="cpu",
                                    batchnorm=False, seed=4).build()
    weights = {k: v.numpy() for k, v in net.model.state_dict().items()}
    np.savez(tmp_path / "w.npz", **weights)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"weights": str(tmp_path / "w.npz")}))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, HERE, str(spec)], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        one = _dp_fit("divides", weights)
        for p in procs:
            text, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, text[-4000:]
            line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            assert line, text[-4000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs.sort(key=lambda o: o["rank"])
    line = "dca_tpu_torch: padded multi-process split -> python-epoch fit"
    assert [o["padded"]["whole_fit"] for o in outs] == [False, False]
    assert line in outs[0]["padded"]["printed"] and line not in outs[1]["padded"]["printed"]
    assert [o["divides"]["whole_fit"] for o in outs] == [True, True]
    assert line not in outs[0]["divides"]["printed"]
    assert outs[1]["divides"]["history"] == outs[0]["divides"]["history"]
    got = outs[0]["divides"]["history"]
    assert one.fit is not None and len(got["loss"]) == len(one.history["loss"])
    for key in ("loss", "val_loss", "lr"):
        np.testing.assert_allclose(got[key], one.history[key], rtol=RTOL, err_msg=key)


if __name__ == "__main__":
    _rank_main(sys.argv[1])
