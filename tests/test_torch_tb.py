"""TensorBoard logging of the port (``dca_tpu_torch/tbevents.py``,
``train(tensorboard=True)``) against the JAX package's on the CPU.

The writer: with the wall time and the host name pinned, both packages'
``EventWriter`` give the same bytes for the same scalars and histograms;
the TFRecord framing carries valid masked CRC32C checksums; all-negative
tensors get a ladder of negative buckets (the port of ``tests/test_tb.py``).

The fits: both packages train the same data from bridged weights at
dropout 0 with the same permutation stream, so their event files hold the
same (tag, step) pairs (``loss``, ``val_loss``, ``lr``, ``weights/<path>``,
``grads/<path>``, and under ``debug`` ``debug/t1``/``debug/t2``), the
scalars within rtol 1e-4 (the trajectory tolerance) and each histogram's
statistics (min, max, num, sum, sum of squares) within rtol 1e-3; not the
bucket counts, whose edges move with rounding.  The fits run without
BatchNorm: with it, the Dense bias before each BatchNorm has an exact
training gradient of zero that RMSprop turns into learning-rate-sized
steps of rounding noise, different in the two packages
(``test_torch_streaming.py``), and the eval-mode gradients read those
biases.  A TensorBoard fit trains as the fit without it, bit for bit.  A
2-rank gloo fit (the ranks are this file run as a script) writes from
rank 0 alone, and its ``grads/`` are the JAX package's single-process
fit's, taken through the weighted loss on its padded validation block.
"""

import glob
import json
import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
RANK_TIMEOUT = 240  # seconds for the group of ranks, start-up included

SCALAR_RTOL, HIST_RTOL = 1e-4, 1e-3
STATS = ("min", "max", "num", "sum", "sum_squares")
HID = (16, 8, 16)
FIT = dict(epochs=3, verbose=False, seed=11, reduce_lr=0, early_stop=0)


def _counts(n_cells=200, n_genes=50, seed=0):
    rs = np.random.RandomState(seed)
    mu = rs.gamma(2.0, 1.0, size=(1, n_genes)) * rs.lognormal(0.0, 0.3, (n_cells, 1)) * 5
    counts = rs.negative_binomial(2.0, 2.0 / (2.0 + mu)).astype(np.float32)
    counts[rs.uniform(size=counts.shape) < 0.3] = 0.0
    counts[0, :] += 1
    counts[:, 0] += 1
    return counts


def _events(out):
    from dca_tpu_torch.tbevents import read_events, read_histograms

    files = glob.glob(os.path.join(out, "tb", "events.out.tfevents.*"))
    assert len(files) == 1, files
    scalars = {(s, t): v for s, d in read_events(files[0]) for t, v in d.items()}
    return scalars, read_histograms(files[0])


def _check_events(got, want):
    """The same (tag, step) pairs; scalars and histogram statistics within
    their tolerances."""
    (gs, gh), (ws, wh) = got, want
    assert set(gs) == set(ws)
    assert set(gh) == set(wh)
    for key, v in ws.items():
        if v == "histogram":
            assert gs[key] == "histogram", key
            continue
        np.testing.assert_allclose(gs[key], v, rtol=SCALAR_RTOL, err_msg=str(key))
    for key, stats in wh.items():
        np.testing.assert_allclose([gh[key][s] for s in STATS], [stats[s] for s in STATS],
                                   rtol=HIST_RTOL, err_msg=str(key))


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------


def test_writers_give_the_same_bytes(tmp_path, monkeypatch):
    from dca_tpu import tbevents as jtb
    from dca_tpu_torch import tbevents as ttb

    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    rs = np.random.RandomState(0)
    records = [("scalar", "loss", 1.5, 0), ("scalar", "lr", 1e-3, 1),
               ("histogram", "weights/trunk/enc0/kernel", rs.normal(size=128), 1),
               ("histogram", "grads/heads/mean/bias", -np.abs(rs.normal(size=40)) - 0.5, 2),
               ("histogram", "empty", np.zeros(0), 2),
               ("histogram", "nonfinite", np.array([np.nan, np.inf, 1.0, -2.0]), 3)]
    paths = []
    for mod, sub in ((jtb, "jax"), (ttb, "torch")):
        w = mod.EventWriter(str(tmp_path / sub))
        for kind, tag, value, step in records:
            getattr(w, kind)(tag, value, step)
        w.close()
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_event_writer_roundtrip(tmp_path):
    from dca_tpu_torch.tbevents import EventWriter, read_events, read_histograms

    v = np.random.RandomState(0).normal(size=128)
    w = EventWriter(str(tmp_path))
    w.scalar("loss", 1.5, 0)
    w.scalar("loss", 1.25, 1)
    w.scalar("lr", 1e-3, 1)
    w.histogram("weights/enc0/kernel", v, 1)
    w.close()
    scalars = {(s, t): val for s, d in read_events(w.path) for t, val in d.items()}
    assert scalars[(0, "loss")] == pytest.approx(1.5)
    assert scalars[(1, "loss")] == pytest.approx(1.25)
    assert scalars[(1, "lr")] == pytest.approx(1e-3)
    assert scalars[(1, "weights/enc0/kernel")] == "histogram"
    stats = read_histograms(w.path)[(1, "weights/enc0/kernel")]
    np.testing.assert_allclose([stats[s] for s in STATS],
                               [v.min(), v.max(), v.size, v.sum(), np.square(v).sum()])


def test_event_file_crc_framing(tmp_path):
    """TFRecord framing carries valid masked CRC32C checksums: a stock
    TensorBoard reader verifies them and drops bad records."""
    from dca_tpu_torch.tbevents import EventWriter, _masked_crc

    w = EventWriter(str(tmp_path))
    w.scalar("x", 2.0, 7)
    w.histogram("h", np.arange(5.0), 7)
    w.close()
    data = open(w.path, "rb").read()
    pos = n_records = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(header)
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert pcrc == _masked_crc(payload)
        pos += 12 + length + 4
        n_records += 1
    assert n_records == 3  # file_version, the scalar, the histogram


def test_histogram_buckets_cover_negative_values():
    """Bucket edges grow from max(|v|): an all-negative tensor gets a
    ladder of negative buckets, not one catch-all bucket."""
    from dca_tpu_torch.tbevents import _histogram_proto

    v = -np.abs(np.random.RandomState(0).normal(size=256)) - 0.5
    assert len(_histogram_proto(v)) > 0.5 * len(_histogram_proto(-v))


def test_nb_terms_match_jax():
    """losses.nb_terms (Stirling lgamma) against the JAX package's
    (jax.lax.lgamma) at rtol 1e-4, atol 1e-4 (tests/test_losses.py's
    relative 1e-4 to scipy for the NB loss, and an absolute 1e-4 where t1's
    lgamma terms cancel), plus 4 float32 ulps of the summed magnitudes of
    t1's three lgamma terms: at the clipped theta = 1e6 they are ~1.3e7
    each, whose ulp is 1."""
    from scipy.special import gammaln

    from dca_tpu import losses as jlosses
    from dca_tpu_torch import losses

    rs = np.random.RandomState(5)
    y = rs.negative_binomial(2, 0.4, size=(16, 8)).astype(np.float32)
    y[0, 0] = np.nan
    mu = rs.uniform(0.1, 5.0, size=(16, 8)).astype(np.float32)
    for th_shape in ((16, 8), (1, 8), (16, 1)):
        th = rs.uniform(0.1, 3.0, size=th_shape).astype(np.float32)
        th[0, 0] = 2e6  # clipped at 1e6
        got = losses.nb_terms(torch.from_numpy(y), torch.from_numpy(mu), torch.from_numpy(th))
        want = jlosses.nb_terms(y, mu, th)
        y0, tc = np.nan_to_num(y).astype(np.float64), np.minimum(th, 1e6).astype(np.float64)
        mag = np.abs(gammaln(tc)) + np.abs(gammaln(y0 + 1)) + np.abs(gammaln(y0 + tc))
        for g, w, m in zip(got, want, (mag, 0.0)):
            w = np.asarray(w, np.float64)
            tol = 1e-4 + 1e-4 * np.abs(w) + 4 * 2.0 ** -23 * m
            assert np.all(np.abs(g.numpy() - w) <= tol)


# ---------------------------------------------------------------------------
# the fits
# ---------------------------------------------------------------------------


def _pair(ae_type, n_cells=200, debug=False, **kw):
    """Both packages' data and networks, on the JAX package's initial
    weights, without BatchNorm (see the module's docstring)."""
    import jax

    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.models import AE_types as JAE

    from dca_tpu_torch.bridge import params_from_jax
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types

    counts = _counts(n_cells)
    jad = jio.normalize(jio.read_dataset(JAnnData(counts.copy())))
    ad = io.normalize(io.read_dataset(AnnData(counts.copy())))
    net_kw = dict(input_size=50, hidden_size=HID, batchnorm=False, debug=debug, seed=7, **kw)
    jnet = JAE[ae_type](**net_kw).build()
    net = AE_types[ae_type](device="cpu", **net_kw).build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    return jad, jnet, ad, net


@pytest.mark.parametrize("ae_type,debug", [("zinb-conddisp", False), ("nb-conddisp", True)],
                         ids=["zinb-conddisp", "nb-conddisp-debug"])
def test_tb_fit_matches_jax(tmp_path, monkeypatch, ae_type, debug):
    """The in-memory fit's events against the JAX package's; under debug
    with debug/t1 and debug/t2 at every epoch.  The port's trace of the
    fit lands beside the events."""
    from dca_tpu.train.loop import train as jtrain

    from dca_tpu_torch.train.loop import train

    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    jad, jnet, ad, net = _pair(ae_type, debug=debug)
    jtrain(jad, jnet, output_dir=str(tmp_path / "jax"), tensorboard=True, compiled=False,
           **FIT)
    hist = train(ad, net, output_dir=str(tmp_path / "torch"), tensorboard=True, **FIT)
    got = _events(str(tmp_path / "torch"))
    _check_events(got, _events(str(tmp_path / "jax")))
    tags = {t for _, t in got[1]}
    assert {"grads/heads/mean/kernel", "weights/trunk/enc0/kernel"} <= tags
    assert ({"debug/t1", "debug/t2"} <= tags) == debug
    for step in range(FIT["epochs"]):
        assert got[0][(step, "loss")] == pytest.approx(hist.history["loss"][step], rel=1e-6)
    assert len(hist.tb_s) == FIT["epochs"]
    assert glob.glob(str(tmp_path / "torch" / "tb" / "*.pt.trace.json"))


def test_tb_fit_without_validation_takes_the_train_split(tmp_path, monkeypatch):
    from dca_tpu.train.loop import train as jtrain

    from dca_tpu_torch.train.loop import train

    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    jad, jnet, ad, net = _pair("zinb-conddisp", n_cells=100)
    kw = dict(FIT, epochs=2, validation_split=0.0)
    jtrain(jad, jnet, output_dir=str(tmp_path / "jax"), tensorboard=True, compiled=False, **kw)
    train(ad, net, output_dir=str(tmp_path / "torch"), tensorboard=True, **kw)
    got = _events(str(tmp_path / "torch"))
    assert not any(t == "val_loss" for _, t in got[0])
    _check_events(got, _events(str(tmp_path / "jax")))


def test_streaming_tb_fit_matches_jax(tmp_path, monkeypatch):
    """The streaming trainer logs the gradients at every epoch, on its first
    validation chunk, as the JAX package's does."""
    from dca_tpu.train.loop import train as jtrain

    from dca_tpu_torch.train.loop import train

    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    jad, jnet, ad, net = _pair("zinb-conddisp")
    kw = dict(FIT, max_device_cells=64, batch_size=32)
    jtrain(jad, jnet, output_dir=str(tmp_path / "jax"), tensorboard=True, compiled=False, **kw)
    train(ad, net, output_dir=str(tmp_path / "torch"), tensorboard=True, **kw)
    got = _events(str(tmp_path / "torch"))
    assert {s for s, t in got[1] if t.startswith("grads/")} == set(range(FIT["epochs"]))
    _check_events(got, _events(str(tmp_path / "jax")))


@pytest.mark.parametrize("where", ["in_memory", "streaming"])
def test_tb_fit_trains_as_the_plain_fit(tmp_path, where):
    """TensorBoard reads and writes nothing of the fit: at dropout 0.1 with
    BatchNorm the history and the final parameters are the plain fit's
    bits."""
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.train.loop import train

    ad = io.normalize(io.read_dataset(AnnData(_counts())))
    kw = dict(FIT, max_device_cells=64) if where == "streaming" else FIT
    nets, hists = [], []
    for tb in (False, True):
        nets.append(AE_types["zinb-conddisp"](input_size=50, hidden_size=HID,
                                              hidden_dropout=0.1, device="cpu").build())
        hists.append(train(ad, nets[-1], output_dir=str(tmp_path / str(tb)), tensorboard=tb,
                           **kw).history)
    assert hists[0] == hists[1]
    for k, v in nets[0].model.state_dict().items():
        assert torch.equal(nets[1].model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# two ranks over gloo: this file run as a script
# ---------------------------------------------------------------------------

DP_CELLS = 61  # 42 train rows; 19 validation rows, padded to 20 on 2 ranks
DP_FIT = dict(epochs=2, batch_size=16, validation_split=0.3, verbose=False, seed=0,
              reduce_lr=0, early_stop=0)


def _dp_counts():
    rs = np.random.RandomState(11)
    counts = rs.poisson(2.5, size=(DP_CELLS, 16)).astype(np.float32)
    counts[:, 0] += 1
    counts[0, :] += 1
    return counts


def _rank_main(spec_path):
    """One rank: a TensorBoard fit of the spec's weights on the group, into
    the spec's output directory; prints the weighted backward's plain
    version's calls (K2w on a card) as one RESULT line."""
    torch.set_num_threads(1)
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData
    from dca_tpu_torch.models.network import AE_types
    from dca_tpu_torch.ops import fused_loss as fl
    from dca_tpu_torch.parallel import multihost
    from dca_tpu_torch.train.loop import train

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.initialize(device="cpu")
    calls = {"weighted_bwd": 0}
    bwd = fl._bwd_reference

    def spy(y, mu, theta, pi, ridge, g, denom, w=None):
        calls["weighted_bwd"] += w is not None
        return bwd(y, mu, theta, pi, ridge, g, denom, w)

    fl._bwd_reference = spy
    ad = io.normalize(io.read_dataset(AnnData(_dp_counts()), check_counts=False))
    net = AE_types["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), batchnorm=False,
                                    device="cpu").build()
    net.model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in np.load(spec["weights"]).items()})
    hist = train(ad, net, devices="all", output_dir=spec["out"], tensorboard=True,
                 **DP_FIT).history
    print("RESULT " + json.dumps({"rank": multihost.process_index(), "calls": calls,
                                  "loss": hist["loss"]}), flush=True)
    torch.distributed.destroy_process_group()


def test_two_ranks_log_the_single_process_gradients(tmp_path):
    """zinb-conddisp on 2 ranks, the 19 validation rows padded to 20 at
    weight 0: rank 0 alone writes one event file, its grads/ are the JAX
    package's single-process fit's (rtol 1e-3), and each rank runs the
    weighted backward once an epoch for them."""
    import jax

    from dca_tpu.data import io as jio
    from dca_tpu.data.adata import AnnData as JAnnData
    from dca_tpu.models import AE_types as JAE
    from dca_tpu.train.loop import train as jtrain

    from dca_tpu_torch.bridge import params_from_jax

    jnet = JAE["zinb-conddisp"](input_size=16, hidden_size=(8, 4, 8), batchnorm=False,
                                seed=4).build()
    weights = str(tmp_path / "w.npz")
    np.savez(weights, **{k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)).items()})
    spec = str(tmp_path / "spec.json")
    with open(spec, "w") as f:
        json.dump({"weights": weights, "out": str(tmp_path / "torch")}, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, HERE, spec], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        os.environ["DCA_TPU_FUSED_LOSS"] = "1"
        jad = jio.normalize(jio.read_dataset(JAnnData(_dp_counts()), check_counts=False))
        jtrain(jad, jnet, output_dir=str(tmp_path / "jax"), tensorboard=True, compiled=False,
               **DP_FIT)
        outs = []
        for p in procs:
            text, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, text[-4000:]
            line = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            assert line, text[-4000:]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        os.environ.pop("DCA_TPU_FUSED_LOSS", None)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [o["calls"]["weighted_bwd"] for o in outs] == [DP_FIT["epochs"]] * 2
    assert outs[0]["loss"] == outs[1]["loss"]
    got = _events(str(tmp_path / "torch"))  # one file: rank 0's
    _check_events(got, _events(str(tmp_path / "jax")))


if __name__ == "__main__":
    _rank_main(sys.argv[1])
