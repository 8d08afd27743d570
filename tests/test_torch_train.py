"""The PyTorch port end to end on the CPU: the training trajectory against
the JAX package's own loop, the data tier, the CLI's output contract, and
the guards (no JAX import, no silent CPU fallback)."""

import ast
import os
import pickle
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import NBAutoencoder as JNBAutoencoder
from dca_tpu.models import ZINBAutoencoder as JZINBAutoencoder
from dca_tpu.train.loop import train as jtrain

import dca_tpu_torch
from dca_tpu_torch.__main__ import main, parse_args
from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models.network import NBAutoencoder, ZINBAutoencoder
from dca_tpu_torch.train.loop import train

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trajectories(jcls, cls, **kw):
    """Both packages train (16, 8, 16) from the same weights on the same
    data for 3 epochs: dropout 0 and one seed give both the same
    np.random.RandomState permutation stream, so the per-epoch losses must
    agree.  The JAX side runs its fused Pallas kernels in interpret mode
    (DCA_TPU_FUSED_LOSS=1 in the caller), the same log1p/Stirling math as
    the port's plain version; what remains is float rounding in another
    order, which grows through the RMSprop steps: rtol 1e-4."""
    counts = make_counts(200, 50)
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    np.testing.assert_array_equal(ad.X, jad.X)

    jnet = jcls(input_size=50, hidden_size=(16, 8, 16), hidden_dropout=0.0, seed=7,
                **kw).build()
    net = cls(input_size=50, hidden_size=(16, 8, 16), hidden_dropout=0.0, device="cpu",
              **kw).build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))

    jhist = jtrain(jad, jnet, epochs=3, verbose=False, seed=11, compiled=False)
    hist = train(ad, net, epochs=3, verbose=False, seed=11)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist.history[key], jhist.history[key], rtol=1e-4,
                                   err_msg=key)
    assert hist.history["lr"] == jhist.history["lr"]


def test_trajectory_matches_jax_training_loop(monkeypatch):
    """nb-conddisp: see _trajectories."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    _trajectories(JNBAutoencoder, NBAutoencoder)


def test_zinb_trajectory_matches_jax_training_loop(monkeypatch):
    """zinb-conddisp, with a ridge on pi: see _trajectories."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    _trajectories(JZINBAutoencoder, ZINBAutoencoder, ridge=0.05)


def test_normalize_and_test_fold_match_jax():
    counts = make_counts(60, 20, seed=4)
    counts[5] = 0.0  # an all-zero cell is dropped by filter_cells
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy()), test_split=True))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy()), test_split=True))
    np.testing.assert_array_equal(ad.X, jad.X)
    np.testing.assert_array_equal(ad.raw.X, jad.raw.X)
    np.testing.assert_array_equal(np.asarray(ad.obs["size_factors"]),
                                  np.asarray(jad.obs["size_factors"]))
    # numpy's draw of sklearn's train_test_split(test_size=0.1, random_state=42)
    np.testing.assert_array_equal(np.asarray(ad.obs["dca_split"]),
                                  np.asarray(jad.obs["dca_split"]))


@pytest.fixture()
def input_tsv(tmp_path):
    counts = make_counts(60, 20, seed=11)  # cells x genes; the file is gene x cell
    df = pd.DataFrame(counts.T.astype(int), index=[f"gene{i}" for i in range(20)],
                      columns=[f"cell{i}" for i in range(60)])
    path = str(tmp_path / "counts.tsv")
    df.to_csv(path, sep="\t")
    return path


def test_cli_end_to_end_on_cpu(input_tsv, tmp_path):
    outdir = str(tmp_path / "out")
    main([input_tsv, outdir, "-e", "2", "-s", "16,8,16", "--device", "cpu"])
    for fname in ("mean.tsv", "mean_norm.tsv", "latent.tsv", "reduced.tsv",
                  "dispersion.tsv", "model.pickle"):
        assert os.path.exists(os.path.join(outdir, fname)), fname

    mean = pd.read_csv(os.path.join(outdir, "mean.tsv"), sep="\t", index_col=0)
    assert mean.shape == (20, 60) and mean.index[0] == "gene0"
    assert np.isfinite(mean.to_numpy()).all()
    latent = pd.read_csv(os.path.join(outdir, "latent.tsv"), sep="\t", index_col=0,
                         header=None)
    assert latent.shape == (60, 8) and np.isfinite(latent.to_numpy()).all()
    disp = pd.read_csv(os.path.join(outdir, "dispersion.tsv"), sep="\t", index_col=0,
                       header=None)
    assert disp.shape == (20, 60) and np.isfinite(disp.to_numpy()).all()
    # mean_norm is the unscaled mean of the model input: mean / mean_norm is
    # each cell's size factor
    mean_norm = pd.read_csv(os.path.join(outdir, "mean_norm.tsv"), sep="\t",
                            index_col=0)
    counts = pd.read_csv(input_tsv, sep="\t", index_col=0).to_numpy()
    sf = counts.sum(axis=0) / np.median(counts.sum(axis=0))
    np.testing.assert_allclose(mean.to_numpy() / mean_norm.to_numpy(),
                               np.broadcast_to(sf[None, :], mean.shape), rtol=1e-3)

    with open(os.path.join(outdir, "model.pickle"), "rb") as f:
        payload = pickle.load(f)
    assert payload["ae_type"] == "nb-conddisp"
    assert payload["params"] is None  # saved before build, as the JAX CLI does


@pytest.mark.parametrize("ae_type", ["zinb-conddisp", "zinb"])
def test_cli_zinb_on_cpu(input_tsv, tmp_path, ae_type):
    """The ZINB writers: dropout.tsv and its alias pi.tsv gene x cell; the
    dispersion gene x cell for zinb-conddisp, one value per gene for the
    constant dispersion of zinb."""
    outdir = str(tmp_path / "out")
    main([input_tsv, outdir, "-e", "2", "-s", "16,8,16", "--type", ae_type,
          "--ridge", "0.01", "--device", "cpu"])
    read = lambda f: pd.read_csv(os.path.join(outdir, f), sep="\t", index_col=0,  # noqa: E731
                                 header=None)
    for fname in ("dropout.tsv", "pi.tsv"):
        pi = read(fname)
        assert pi.shape == (20, 60) and pi.index[0] == "gene0", fname
        assert np.isfinite(pi.to_numpy()).all() and (pi.to_numpy() > 0).all()
    np.testing.assert_array_equal(read("dropout.tsv").to_numpy(), read("pi.tsv").to_numpy())
    disp = read("dispersion.tsv")
    assert disp.shape == ((20, 60) if ae_type == "zinb-conddisp" else (20, 1))
    assert np.isfinite(disp.to_numpy()).all() and disp.index[0] == "gene0"
    with open(os.path.join(outdir, "model.pickle"), "rb") as f:
        assert pickle.load(f)["ae_type"] == ae_type


def test_cli_prelu_adam_on_cpu(input_tsv, tmp_path, capsys):
    """--activation PReLU --optimizer Adam runs and writes the TSV contract
    (it was refused before PReLU and Adam were ported)."""
    outdir = str(tmp_path / "out")
    main([input_tsv, outdir, "-e", "2", "-s", "16,8,16", "--type", "zinb-conddisp",
          "--activation", "PReLU", "--optimizer", "Adam", "--device", "cpu"])
    assert "Epoch 2/2" in capsys.readouterr().out
    for fname, header, shape in (("mean.tsv", 0, (20, 60)), ("dropout.tsv", None, (20, 60)),
                                 ("dispersion.tsv", None, (20, 60)),
                                 ("latent.tsv", None, (60, 8))):
        df = pd.read_csv(os.path.join(outdir, fname), sep="\t", index_col=0, header=header)
        assert df.shape == shape and np.isfinite(df.to_numpy()).all(), fname
    with open(os.path.join(outdir, "model.pickle"), "rb") as f:
        assert pickle.load(f)["ctor"]["activation"] == "PReLU"


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--modelparallel", "2"]])
def test_cli_refuses_what_is_not_ported(input_tsv, tmp_path, flags):
    """Two devices in one process are not ported (ROADMAP.md);
    --modelparallel without --devices raises with the message of the JAX
    package's resolve_mesh assertion."""
    match = "ROADMAP.md" if "--devices" in flags else "requires devices="
    with pytest.raises((ValueError, NotImplementedError), match=match):
        main([input_tsv, str(tmp_path / "out"), "-e", "1", "--device", "cpu", *flags])


def _artefacts(out):
    """The files of a fit's output directory, relative, with the event
    file's and the profiler trace's run-dependent names (time, host,
    process) folded: {path: sorted dataset keys of an HDF5, or None}."""
    import h5py

    files = {}
    for root, _, names in os.walk(out):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), out)
            if rel.startswith("tb" + os.sep):
                rel = "tb/events" if name.startswith("events.out.tfevents.") else "tb/trace"
            keys = None
            if name.endswith(".hdf5"):
                with h5py.File(os.path.join(root, name)) as f:
                    keys = []
                    f.visit(lambda k: keys.append(k) if isinstance(f[k], h5py.Dataset)
                            else None)
                keys = sorted(keys)
            files[rel] = keys
    return files


@pytest.mark.parametrize("flag", ["--saveweights", "--tensorboard"])
def test_cli_writes_the_fit_artefacts(input_tsv, tmp_path, flag):
    """--saveweights and --tensorboard run (they were refused before this
    slice) and write the JAX package's CLI's files: weights.hdf5 with its
    keys, or the tb/ event file and the fit's trace."""
    from dca_tpu.__main__ import main as jmain

    args = ["-e", "2", "-s", "16,8,16", flag]
    main([input_tsv, str(tmp_path / "port"), "--device", "cpu", *args])
    jmain([input_tsv, str(tmp_path / "jax"), *args])
    got, want = _artefacts(str(tmp_path / "port")), _artefacts(str(tmp_path / "jax"))
    assert got == want
    assert ("weights.hdf5" if flag == "--saveweights" else "tb/events") in got


def test_cli_flag_surface_matches_jax():
    from dca_tpu.__main__ import parse_args as jparse_args

    ours = vars(parse_args(["in.tsv", "out"]))
    theirs = vars(jparse_args(["in.tsv", "out"]))
    assert ours.pop("device") is None
    assert ours == theirs


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch, tmp_path, input_tsv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    adata = AnnData(make_counts(40, 10, seed=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dca_tpu_torch.dca(adata, epochs=1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main([input_tsv, str(tmp_path / "out"), "-e", "1"])
    # train() fits on the network's device, which defaults to the card too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(adata, NBAutoencoder(input_size=10).build(), epochs=1)


@pytest.mark.parametrize("kwds", [{"model_parallel": 2}], ids=str)
def test_train_refuses_paths_not_ported_by_name(kwds, monkeypatch):
    """The JAX package's train keywords for paths the port lacks raise
    NotImplementedError naming ROADMAP.md; through dca(training_kwds=...)
    too.  What is left is model parallelism on the streaming trainer,
    which DCA_TPU_DEVICE_BYTES=1 sends this input to.  (compiled=True,
    refused here before, trains now, see
    test_compiled_trains_through_both_entry_points; model parallelism in
    memory: tests/test_torch_model_parallel.py.)"""
    monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", "1")
    adata = io.normalize(io.read_dataset(AnnData(make_counts(40, 10, seed=3))))
    net = NBAutoencoder(input_size=10, hidden_size=(8, 4, 8), device="cpu").build()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train(adata, net, epochs=1, verbose=False, **kwds)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dca_tpu_torch.dca(AnnData(make_counts(40, 10, seed=3)), epochs=1, device="cpu",
                          hidden_size=(8, 4, 8), training_kwds=kwds)


def test_compiled_trains_through_both_entry_points():
    """compiled=True runs the whole fit on the device (train/compiled.py)
    through train() and through dca(training_kwds=...): the epochs asked
    for, with the Python-epoch loop's val_loss bits at dropout 0 (the same
    row orders and steps) and its learning rate as the float32 the device
    holds."""
    counts = make_counts(40, 10, seed=3)
    adata = io.normalize(io.read_dataset(AnnData(counts.copy())))
    net = NBAutoencoder(input_size=10, hidden_size=(8, 4, 8), device="cpu").build()
    hist = train(adata, net, epochs=2, verbose=False, compiled=True)
    assert hist.fit is not None and hist.fit.epochs_run == 2
    rets = [dca_tpu_torch.dca(AnnData(counts.copy()), epochs=2, device="cpu",
                              hidden_size=(8, 4, 8), copy=True, return_info=True,
                              training_kwds={"compiled": compiled})
            for compiled in (True, False)]
    whole, loop = (r.uns["dca_loss_history"] for r in rets)
    assert whole["val_loss"] == loop["val_loss"] and len(whole["loss"]) == 2
    np.testing.assert_allclose(whole["loss"], loop["loss"], rtol=1e-6)
    assert whole["lr"] == [float(np.float32(1e-3))] * 2 and loop["lr"] == [1e-3] * 2


@pytest.mark.parametrize("kwds", [{"checkpoint_every": 2}, {"resume": True},
                                  {"checkpoint_every": 1, "compiled": True}], ids=str)
def test_train_takes_the_checkpoint_keywords_as_jax(tmp_path, kwds):
    """checkpoint_every and resume run, where they were refused before this
    slice, and (with compiled=True too, which they turn off) write the JAX
    package's files for the same keywords, through train() and through
    dca(training_kwds=...)."""
    import jax

    from dca_tpu import api as japi

    counts = make_counts(40, 10, seed=3)
    adata = io.normalize(io.read_dataset(AnnData(counts.copy())))
    net = NBAutoencoder(input_size=10, hidden_size=(8, 4, 8), device="cpu").build()
    jnet = JNBAutoencoder(input_size=10, hidden_size=(8, 4, 8)).build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    fit = dict(epochs=3, verbose=False, **kwds)
    hist = train(adata, net, output_dir=str(tmp_path / "port"), **fit)
    jhist = jtrain(jio.normalize(jio.read_dataset(JAnnData(counts.copy()))), jnet,
                   output_dir=str(tmp_path / "jax"), **fit)
    assert _artefacts(str(tmp_path / "port")) == _artefacts(str(tmp_path / "jax"))
    np.testing.assert_allclose(hist.history["loss"], jhist.history["loss"], rtol=1e-4)
    ret = dca_tpu_torch.dca(AnnData(counts.copy()), epochs=2, device="cpu",
                            hidden_size=(8, 4, 8), copy=True, return_info=True,
                            training_kwds={**kwds, "output_dir": str(tmp_path / "dca")})
    japi.dca(JAnnData(counts.copy()), epochs=2, hidden_size=(8, 4, 8), copy=True,
             training_kwds={**kwds, "output_dir": str(tmp_path / "jdca")})
    assert len(ret.uns["dca_loss_history"]["loss"]) == 2
    assert _artefacts(str(tmp_path / "dca")) == _artefacts(str(tmp_path / "jdca"))


@pytest.mark.parametrize("gate", ["device_bytes", "max_device_cells"])
def test_train_refuses_inputs_the_jax_package_would_stream(monkeypatch, capsys, gate):
    """The JAX package's size gate: above DCA_TPU_DEVICE_BYTES (input and
    target, n_cells * n_genes * 4 * 2 bytes) or above max_device_cells it
    takes its streaming trainer, and so does the port now (it refused these
    inputs by name before the streaming trainer was ported): the epochs
    print ``[streaming]`` and, on the host tier, give the in-memory fit's
    history; at the limit the fit stays in memory."""
    def fit(**kw):
        adata = io.normalize(io.read_dataset(AnnData(make_counts(40, 10, seed=3))))
        net = NBAutoencoder(input_size=10, hidden_size=(8, 4, 8), device="cpu", seed=2).build()
        hist = train(adata, net, epochs=2, verbose=True, seed=4, **kw).history
        return hist, capsys.readouterr().out.count("[streaming]")

    monkeypatch.delenv("DCA_TPU_DEVICE_DENSIFY", raising=False)
    n = 40 * 10 * 8
    if gate == "device_bytes":
        monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", str(n - 1))
        over, at = {}, None
    else:
        over, at = {"max_device_cells": 39}, {"max_device_cells": 40}
    streamed, n_streaming = fit(**over)
    assert n_streaming == 2
    if gate == "device_bytes":
        monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", str(n))
        at = {}
    in_memory, n_streaming = fit(**at)
    assert n_streaming == 0
    assert streamed == in_memory


@pytest.mark.parametrize("kwds", [{"compiled": "auto"}, {"compiled": False},
                                  {"not_a_keyword": 3, "compiled": "auto"}], ids=str)
def test_train_takes_the_eager_loop_and_ignores_unknown_keywords(kwds):
    """compiled "auto" and False run the eager loop, as the JAX package
    does off the TPU, and unknown keywords pass, as there: the same
    history as a plain call."""
    def fit(**kw):
        adata = io.normalize(io.read_dataset(AnnData(make_counts(40, 10, seed=3))))
        net = NBAutoencoder(input_size=10, hidden_size=(8, 4, 8), device="cpu").build()
        return train(adata, net, epochs=2, verbose=False, seed=5, **kw).history

    assert fit(**kwds) == fit()


def test_train_compiled_true_in_debug_runs_the_eager_loop():
    """In debug mode the JAX package leaves its compiled program for the
    eager loop whatever ``compiled`` says; so does the port."""
    adata = io.normalize(io.read_dataset(AnnData(make_counts(40, 10, seed=3))))
    net = NBAutoencoder(input_size=10, hidden_size=(8, 4, 8), debug=True, device="cpu").build()
    assert len(train(adata, net, epochs=1, verbose=False, compiled=True).history["loss"]) == 1


def _port_files():
    pkg = os.path.join(REPO, "dca_tpu_torch")
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "chip_profile.py", "chip_dp.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _is_forbidden(module):
    return any(module == m or module.startswith(m + ".") for m in ("jax", "dca_tpu", "bench"))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    # every import statement in the package and in chip_smoke.py, lazy ones too
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not any(_is_forbidden(n) for n in names), (path, names)
    # and, in a fresh interpreter, importing every module loads neither
    code = (
        "import importlib, pkgutil, sys\n"
        "import dca_tpu_torch\n"
        "for m in pkgutil.walk_packages(dca_tpu_torch.__path__, 'dca_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'dca_tpu') "
        "or m.startswith(('jax.', 'dca_tpu.'))]\n"
        "missing = [m for m in ('dca_tpu_torch.data.loader', 'dca_tpu_torch.ops.densify', "
        "'dca_tpu_torch.ops.resident') if m not in sys.modules]\n"
        "print(len(sys.modules), bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
