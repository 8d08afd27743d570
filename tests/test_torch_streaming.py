"""The streaming trainer (``train/loop.py::_train_streaming``) held against
the JAX package's on the CPU, and against the port's in-memory fit.

Both packages fit the same lazily scaled sparse counts from the same
weights (bridged), with dropout 0 and one seed, so both draw the same
``np.random.RandomState`` permutations; ``max_device_cells`` makes each
epoch several staged parts.  Per staging tier (host densify, padded, flat
and flat8 payloads, the derived input, the resident corpus) the loss
histories must agree at rtol 1e-4 (the JAX side runs its fused Pallas
kernels in interpret mode; float rounding in another order grows through
the RMSprop steps).  Those per-tier fits run without BatchNorm: with it,
the Dense bias before each BatchNorm has an exact gradient of zero, which
RMSprop turns into learning-rate-sized steps of rounding noise, different
in the two packages, and the running means carry them into the
validation loss (4.2e-4 apart after 3 epochs here, in the in-memory fits
of both packages alike).  With BatchNorm the streamed fits are held to
what that leaves: the JAX package's streamed history to its in-memory one
and the port's to the port's.  Within the port the part size is a multiple
of the batch, so a streamed epoch trains the in-memory epoch's batches in
its order: the host and payload tiers give the in-memory fit's history
bit for bit, and the resident tier the derived tier's.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import AE_types as JAE
from dca_tpu.train.loop import train as jtrain

import dca_tpu_torch
from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData, Raw
from dca_tpu_torch.models.network import AE_types
from dca_tpu_torch.ops.resident import PART_BYTES_PER_SLOT
from dca_tpu_torch.train import loop
from dca_tpu_torch.train.loop import train

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

N_CELLS, N_GENES = 150, 14
# 135 train rows, batch 32, parts of 64: 64 and 64 full rows and a 7-row
# trailing part, then one 15-row validation chunk an epoch
FIT = dict(epochs=3, batch_size=32, seed=5, max_device_cells=64, verbose=False)

TIERS = {
    "host": {"DCA_TPU_DEVICE_DENSIFY": "0"},
    "padded": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
               "DCA_TPU_PAYLOAD": "padded"},
    "flat": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
             "DCA_TPU_PAYLOAD": "flat"},
    "flat8": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_DERIVE_INPUT": "0",
              "DCA_TPU_PAYLOAD": "flat8"},
    "derived": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_RESIDENT": "0"},
    "resident": {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_RESIDENT": "1"},
}
SWITCHES = ("DCA_TPU_DEVICE_DENSIFY", "DCA_TPU_DERIVE_INPUT", "DCA_TPU_PAYLOAD",
            "DCA_TPU_RESIDENT", "DCA_TPU_PREFETCH", "DCA_TPU_TIMELINE")


def _counts():
    X = make_counts(N_CELLS, N_GENES, seed=36)
    X[X < 2] = 0
    X[:, 0] += 1
    X[0, :] += 1
    return X


def _env(monkeypatch, env):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def _weights(ae_type="nb-conddisp", batchnorm=True):
    jnet = JAE[ae_type](input_size=N_GENES, hidden_size=(8, 4, 8), hidden_dropout=0.0,
                        batchnorm=batchnorm, seed=1).build()
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jnet.params),
                            jax.tree_util.tree_map(np.asarray, jnet.state))
    return state


def _port_fit(state, ae_type="nb-conddisp", batchnorm=True, **kw):
    ad = io.normalize(io.read_dataset(AnnData(sp.csr_matrix(_counts()))), lazy_scale=True)
    net = AE_types[ae_type](input_size=N_GENES, hidden_size=(8, 4, 8), hidden_dropout=0.0,
                            batchnorm=batchnorm, device="cpu").build()
    net.model.load_state_dict(state)
    return train(ad, net, **{**FIT, **kw}).history


def _jax_fit(batchnorm=True, **kw):
    jad = jio.normalize(jio.read_dataset(JAnnData(sp.csr_matrix(_counts()))), lazy_scale=True)
    jnet = JAE["nb-conddisp"](input_size=N_GENES, hidden_size=(8, 4, 8), hidden_dropout=0.0,
                              batchnorm=batchnorm, seed=1).build()
    return jtrain(jad, jnet, compiled=False, **{**FIT, **kw}).history


@pytest.fixture(scope="module")
def bridged():
    return _weights()


@pytest.fixture(scope="module")
def bridged_no_bn():
    return _weights(batchnorm=False)


@pytest.fixture(scope="module")
def in_memory_no_bn(bridged_no_bn):
    """The port's in-memory fit without BatchNorm (no switch is read)."""
    return _port_fit(bridged_no_bn, batchnorm=False, max_device_cells=None)


@pytest.mark.parametrize("tier", list(TIERS))
def test_streaming_matches_jax_streaming_per_tier(monkeypatch, bridged_no_bn, in_memory_no_bn,
                                                  tier):
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    in_memory = in_memory_no_bn
    _env(monkeypatch, TIERS[tier])
    jhist = _jax_fit(batchnorm=False)
    hist = _port_fit(bridged_no_bn, batchnorm=False)
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=1e-4, err_msg=key)
    assert hist["lr"] == jhist["lr"]
    if tier in ("host", "padded", "flat", "flat8"):
        # the in-memory fit's batches in its order: its bits
        assert hist == in_memory, (hist, in_memory)


def test_streaming_with_batchnorm_adds_nothing_to_either_package(monkeypatch, bridged):
    """With BatchNorm, the host tier: the JAX package's streamed fit within
    1e-6 of its in-memory fit, the port's streamed fit the bits of its
    in-memory fit, and the train loss of the two packages within 1e-4."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    _env(monkeypatch, {})
    port_memory = _port_fit(bridged, max_device_cells=None)
    jax_memory = _jax_fit(max_device_cells=None)
    port, jhist = _port_fit(bridged), _jax_fit()
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(jhist[key], jax_memory[key], rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(port["loss"], jhist["loss"], rtol=1e-4)
    assert port == port_memory


def test_resident_gives_the_derived_tiers_bits(monkeypatch, bridged):
    _env(monkeypatch, TIERS["derived"])
    derived = _port_fit(bridged)
    _env(monkeypatch, TIERS["resident"])
    assert _port_fit(bridged) == derived


@pytest.mark.parametrize("rows", [1, 3])
def test_the_resident_gate_takes_a_part_past_its_budget_in_row_blocks(monkeypatch, bridged,
                                                                      capsys, rows):
    """Auto engages the resident corpus where ``rows`` rows' padded slots
    fit DCA_TPU_RESIDENT_PART_BYTES though a part's (64 rows) do not, and
    the parts, gathered in blocks of ``rows`` rows, give the derived tier's
    bits."""
    _env(monkeypatch, TIERS["derived"])
    derived = _port_fit(bridged)
    budget = PART_BYTES_PER_SLOT * N_GENES * rows  # the widest row holds every gene
    _env(monkeypatch, {"DCA_TPU_DEVICE_DENSIFY": "1", "DCA_TPU_RESIDENT_MIN_BYTES": "0",
                       "DCA_TPU_RESIDENT_PART_BYTES": str(budget)})
    assert _port_fit(bridged, verbose=True) == derived
    assert "corpus resident" in capsys.readouterr().out


def test_a_validation_part_in_blocks_gives_its_loss(monkeypatch, bridged):
    """On one device a validation part's loss is taken in blocks of at most
    ``_VAL_BLOCK_ELEMENTS`` elements, each block's mean weighted by its
    rows: the same training bits, and the validation loss within float32
    rounding of the part's taken whole."""
    assert loop._val_blocks(15, N_GENES) == [(0, 15)]
    assert loop._val_blocks(10, loop._VAL_BLOCK_ELEMENTS // 4) == [(0, 4), (4, 8), (8, 10)]
    assert loop._val_blocks(3, loop._VAL_BLOCK_ELEMENTS * 2) == [(0, 1), (1, 2), (2, 3)]
    _env(monkeypatch, TIERS["derived"])
    whole = _port_fit(bridged)
    monkeypatch.setattr(loop, "_VAL_BLOCK_ELEMENTS", 4 * N_GENES)  # the 15 rows in 4 blocks
    cls, rows = AE_types["nb-conddisp"], []
    plain = cls.loss_fn

    def loss_fn(self, count, size_factors, target, training, *args, **kw):
        if not training:  # a validation block
            rows.append(count.shape[0])
        return plain(self, count, size_factors, target, training, *args, **kw)

    monkeypatch.setattr(cls, "loss_fn", loss_fn)
    blocks = _port_fit(bridged)
    assert rows == [4, 4, 4, 3] * FIT["epochs"]
    assert blocks["loss"] == whole["loss"]
    np.testing.assert_allclose(blocks["val_loss"], whole["val_loss"], rtol=1e-6)


def _scrambled(M):
    """``M`` with each row's entries in reverse order and its first entry
    split in two halves: unsorted, with duplicates, the same matrix."""
    data, idx, ptr = [], [], [0]
    for r in range(M.shape[0]):
        d = M.data[M.indptr[r]:M.indptr[r + 1]][::-1]
        i = M.indices[M.indptr[r]:M.indptr[r + 1]][::-1]
        if len(d):
            d = np.concatenate([[d[0] / 2, d[0] / 2], d[1:]]).astype(M.dtype)
            i = np.concatenate([[i[0]], i])
        data.append(d)
        idx.append(i)
        ptr.append(ptr[-1] + len(d))
    out = sp.csr_matrix((np.concatenate(data), np.concatenate(idx), np.array(ptr)),
                        shape=M.shape)
    assert not out.has_canonical_format and out.nnz > M.nnz
    np.testing.assert_array_equal(out.toarray(), M.toarray())
    return out


@pytest.mark.parametrize("tier", ["derived", "flat"])
def test_a_streamed_fit_on_unsorted_duplicate_entries(monkeypatch, bridged, tier):
    """An input and a target whose rows hold unsorted and duplicate
    entries stream as their canonical copies do, and each stays the matrix
    it was (its row blocks are views of its arrays)."""
    _env(monkeypatch, TIERS[tier])
    want = _port_fit(bridged)
    ad = io.normalize(io.read_dataset(AnnData(sp.csr_matrix(_counts()))), lazy_scale=True)
    X, R = ad.X.toarray(), ad.raw.X.toarray()
    ad.X = _scrambled(ad.X)
    ad.raw = Raw(_scrambled(ad.raw.X), ad.raw.var, ad.raw.obs_names)
    net = AE_types["nb-conddisp"](input_size=N_GENES, hidden_size=(8, 4, 8), hidden_dropout=0.0,
                                  device="cpu").build()
    net.model.load_state_dict(bridged)
    assert train(ad, net, **FIT).history == want
    np.testing.assert_array_equal(ad.X.toarray(), X)
    np.testing.assert_array_equal(ad.raw.X.toarray(), R)


@pytest.mark.parametrize("env", [{}, TIERS["flat"]], ids=["host", "flat"])
def test_prefetch_depth_leaves_the_trajectory(monkeypatch, bridged, env):
    hists = []
    for depth in ("0", "1", "2"):
        _env(monkeypatch, {**env, "DCA_TPU_PREFETCH": depth})
        hists.append(_port_fit(bridged))
    assert hists[0] == hists[1] == hists[2]


def test_zinb_streaming_matches_in_memory(monkeypatch):
    """zinb-conddisp: the streamed host tier the in-memory fit's bits, and
    the streamed flat tier with a ridge likewise."""
    state = _weights("zinb-conddisp")
    _env(monkeypatch, {})
    want = _port_fit(state, "zinb-conddisp", max_device_cells=None, epochs=2)
    assert _port_fit(state, "zinb-conddisp", epochs=2) == want
    _env(monkeypatch, TIERS["flat"])
    assert _port_fit(state, "zinb-conddisp", epochs=2) == want


def test_streaming_dense_input_and_eager_scale(monkeypatch, bridged):
    """A dense, eagerly scaled input above the gate streams through the
    host tier (native row gathers) with the in-memory fit's bits."""
    _env(monkeypatch, {"DCA_TPU_DEVICE_DENSIFY": "1"})

    def fit(mdc):
        ad = io.normalize(io.read_dataset(AnnData(_counts())))
        net = AE_types["nb-conddisp"](input_size=N_GENES, hidden_size=(8, 4, 8),
                                      device="cpu").build()
        net.model.load_state_dict(bridged)
        return train(ad, net, **{**FIT, "max_device_cells": mdc}).history

    assert fit(48) == fit(None)


def test_streaming_prints_and_the_resident_auto_gate(monkeypatch, bridged, capsys):
    """Verbose epochs end ``[streaming]``; the resident corpus engages
    under auto only inside the byte bounds, and DCA_TPU_RESIDENT=1 forces
    it."""
    def fit(**env):
        _env(monkeypatch, {"DCA_TPU_DEVICE_DENSIFY": "1", **env})
        _port_fit(bridged, epochs=1, verbose=True)
        return capsys.readouterr().out

    out = fit()
    assert "corpus resident" not in out  # the default 64 MB floor
    assert out.strip().splitlines()[-1].endswith("[streaming]")
    assert "corpus resident" in fit(DCA_TPU_RESIDENT_MIN_BYTES="0")
    assert "corpus resident" not in fit(DCA_TPU_RESIDENT_MIN_BYTES="0",
                                        DCA_TPU_RESIDENT_PART_BYTES="1")
    assert "corpus resident" in fit(DCA_TPU_RESIDENT="1")
    assert "corpus resident" not in fit(DCA_TPU_RESIDENT="1", DCA_TPU_DERIVE_INPUT="0")


def test_timeline_records_every_stage(monkeypatch, bridged, tmp_path):
    import json

    path = tmp_path / "tl.jsonl"
    _env(monkeypatch, {"DCA_TPU_TIMELINE": str(path)})
    _port_fit(bridged, epochs=2)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert {r["epoch"] for r in rows} == {0, 1}
    stages = {r["stage"] for r in rows}
    assert {"prep", "ship", "wait", "dispatch", "fetch", "epoch"} <= stages
    # 3 train parts and 1 validation chunk an epoch
    assert sum(r["stage"] == "dispatch" and r["epoch"] == 0 for r in rows) == 4


def test_dca_and_cli_reach_the_streaming_trainer(tmp_path, capsys, monkeypatch):
    """``dca(training_kwds={"max_device_cells": n})`` and the CLI above the
    device budget stream, through the same surfaces as before."""
    _env(monkeypatch, {})
    ret = dca_tpu_torch.dca(AnnData(_counts()), epochs=2, device="cpu", hidden_size=(8, 4, 8),
                            verbose=True, copy=True, return_info=True,
                            training_kwds={"max_device_cells": 48})
    assert "[streaming]" in capsys.readouterr().out
    assert np.isfinite(ret.X).all() and len(ret.uns["dca_loss_history"]["loss"]) == 2

    import pandas as pd

    from dca_tpu_torch.__main__ import main

    path = tmp_path / "counts.tsv"
    pd.DataFrame(_counts().T, index=[f"g{i}" for i in range(N_GENES)],
                 columns=[f"c{i}" for i in range(N_CELLS)]).to_csv(path, sep="\t")
    monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", "1")
    main([str(path), str(tmp_path / "out"), "-e", "2", "-s", "8,4,8", "--device", "cpu"])
    assert capsys.readouterr().out.count("[streaming]") == 2
    mean = pd.read_csv(tmp_path / "out" / "mean.tsv", sep="\t", index_col=0)
    assert mean.shape == (N_GENES, N_CELLS) and np.isfinite(mean.values).all()


def _listing(out):
    """The relative files under ``out``, the event file and the profiler
    trace folded to their directory (their names carry time and host)."""
    files = set()
    for root, _, names in os.walk(out):
        for name in names:
            rel = os.path.relpath(os.path.join(root, name), out)
            files.add(rel.split(os.sep)[0] + "/*" if rel.startswith("tb" + os.sep) else rel)
    return files


@pytest.mark.parametrize("kwds", [{"save_weights": True}, {"tensorboard": True},
                                  {"checkpoint_every": 1}, {"resume": True}], ids=str)
def test_streaming_writes_the_fit_artefacts_as_jax(kwds, tmp_path, monkeypatch):
    """The keywords the streaming trainer refused before this slice run and
    write the files the JAX package's streaming fit writes for them."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    hist = _port_fit(_weights(), output_dir=str(tmp_path / "port"), **kwds)
    jhist = _jax_fit(output_dir=str(tmp_path / "jax"), **kwds)
    assert _listing(str(tmp_path / "port")) == _listing(str(tmp_path / "jax"))
    assert len(hist["loss"]) == len(jhist["loss"]) == FIT["epochs"]


def test_a_failed_staging_raises_and_leaves_no_thread(monkeypatch, bridged):
    """A part that fails to stage raises out of train(), and the prefetch
    thread ends (no device densify quietly gives way to the host tier)."""
    import threading

    from dca_tpu_torch.ops import densify

    def boom(*a, **k):
        raise RuntimeError("scatter failed")

    _env(monkeypatch, TIERS["flat"])
    monkeypatch.setattr(loop, "device_densify_flat", boom)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="scatter failed"):
        _port_fit(bridged)
    assert threading.active_count() == before
    assert densify.device_densify_flat is not boom
