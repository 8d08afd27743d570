"""The port's streaming denoise -> write (``write_streaming``,
``data/stream_write.py``) and pipelined block forward on the CPU: the
counterparts of ``tests/test_stream_write.py`` (byte parity with the
in-memory ``predict`` + ``write``, h5ad round trip, spill clean-up,
multi-block and multi-strip writes, the CLI's streaming branch), the
deferred z-scale against the JAX package's, and the written values against
the JAX package's ``write_streaming`` on the same weights."""

import glob
import os

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import jax

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import AE_types as JAE_types

from dca_tpu_torch.__main__ import main
from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData, read_h5ad
from dca_tpu_torch.models.network import AE_types

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once


def _counts(n, g, seed=0):
    rs = np.random.RandomState(seed)
    mu = rs.gamma(2.0, 1.0, (1, g)) * rs.lognormal(0, 0.3, (n, 1)) * 3
    c = rs.negative_binomial(2.0, 2.0 / (2.0 + mu)).astype(np.float32)
    c[rs.uniform(size=c.shape) < 0.3] = 0
    c[0, :] += 1
    c[:, 0] += 1
    return c


def _frames(n, g):
    return (pd.DataFrame(index=pd.Index([f"c{i}" for i in range(n)])),
            pd.DataFrame(index=pd.Index([f"g{i}" for i in range(g)])))


def _prepped(n=90, g=25, seed=0, lazy=False, sparse=False):
    c = _counts(n, g, seed)
    ad = AnnData(sp.csr_matrix(c) if sparse else c, *_frames(n, g))
    return io.normalize(io.read_dataset(ad, check_counts=False), lazy_scale=lazy)


def _net(ae_type, adata, **kw):
    return AE_types[ae_type](input_size=adata.n_vars, hidden_size=(8, 4, 8), device="cpu",
                             **kw).build()


def _files_equal(d1, d2, names):
    for f in names:
        p1, p2 = os.path.join(d1, f), os.path.join(d2, f)
        assert os.path.exists(p1), f"{f} missing from the in-memory write"
        assert os.path.exists(p2), f"{f} missing from the streaming write"
        with open(p1, "rb") as a, open(p2, "rb") as b:
            assert a.read() == b.read(), f"{f} differs"


def _both_writes(net, ad_ref, ad_stream, tmp_path, mode="full", colnames=None, **kw):
    """predict + write into tmp/ref, write_streaming into tmp/stream."""
    ref_dir, stream_dir = str(tmp_path / "ref"), str(tmp_path / "stream")
    net.predict(ad_ref, mode=mode, return_info=mode != "latent")
    net.write(ad_ref, ref_dir, mode=mode, colnames=colnames)
    net.write_streaming(ad_stream, stream_dir, mode=mode, return_info=mode != "latent",
                        colnames=colnames, **kw)
    return ref_dir, stream_dir


EXPECT = {
    "zinb-conddisp": ["mean.tsv", "mean_norm.tsv", "latent.tsv", "reduced.tsv",
                      "dispersion.tsv", "dropout.tsv", "pi.tsv"],
    "nb-conddisp": ["mean.tsv", "mean_norm.tsv", "latent.tsv", "reduced.tsv",
                    "dispersion.tsv"],
    "nb": ["mean.tsv", "mean_norm.tsv", "latent.tsv", "reduced.tsv", "dispersion.tsv"],
    "zinb": ["mean.tsv", "mean_norm.tsv", "latent.tsv", "reduced.tsv", "dispersion.tsv",
             "dropout.tsv", "pi.tsv"],
}


@pytest.mark.parametrize("ae_type", sorted(EXPECT))
def test_streaming_tsv_byte_parity(ae_type, tmp_path, monkeypatch):
    """write_streaming's TSVs are byte-identical to predict(full,
    return_info=True) + write(full), the NB post-denoise dispersion
    included, with multi-strip transposed writes forced.  adata.X is not
    overwritten by the streaming write; the latent is stored."""
    monkeypatch.setenv("DCA_TPU_WRITE_STRIP_BYTES", "2000")  # ~5 genes a strip
    ad_ref, ad_stream = _prepped(seed=3), _prepped(seed=3)
    net = _net(ae_type, ad_ref)
    ref_dir, stream_dir = _both_writes(net, ad_ref, ad_stream, tmp_path)
    _files_equal(ref_dir, stream_dir, EXPECT[ae_type])
    assert sorted(os.listdir(stream_dir)) == sorted(EXPECT[ae_type])
    np.testing.assert_allclose(ad_stream.obsm["X_dca"], ad_ref.obsm["X_dca"], rtol=1e-6)
    assert not np.allclose(np.asarray(ad_stream.X), np.asarray(ad_ref.X))


def test_streaming_multiblock_numeric_parity(tmp_path, monkeypatch):
    """Blocks of 32 rows reassemble the one-block matrices: the same shapes,
    headers and index, values equal to float32 forward tolerance."""
    monkeypatch.setenv("DCA_TPU_WRITE_STRIP_BYTES", "2000")
    ad_a, ad_b = _prepped(seed=3), _prepped(seed=3)
    net = _net("zinb-conddisp", ad_a)
    one_dir, multi_dir = str(tmp_path / "one"), str(tmp_path / "multi")
    net.write_streaming(ad_a, one_dir, mode="full", return_info=True)
    net.write_streaming(ad_b, multi_dir, mode="full", return_info=True, chunk_rows=32)
    for f in EXPECT["zinb-conddisp"]:
        kw = dict(sep="\t", index_col=0,
                  header=0 if f in ("mean.tsv", "mean_norm.tsv") else None)
        a = pd.read_csv(os.path.join(one_dir, f), **kw)
        b = pd.read_csv(os.path.join(multi_dir, f), **kw)
        assert a.shape == b.shape and list(a.index) == list(b.index), f
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f)


def test_streaming_tsv_parity_lazy_sparse(tmp_path):
    """CSR input with the deferred z-scale through both writes."""
    ad_ref = _prepped(80, 20, seed=5, lazy=True, sparse=True)
    ad_stream = _prepped(80, 20, seed=5, lazy=True, sparse=True)
    assert sp.issparse(ad_ref.X) and "dca_scale_mean" in ad_ref.uns
    net = _net("zinb-conddisp", ad_ref)
    _files_equal(*_both_writes(net, ad_ref, ad_stream, tmp_path), EXPECT["zinb-conddisp"])


def test_streaming_shared_heads(tmp_path):
    """zinb-shared's (N, 1) dispersion and pi go through the small-output
    accumulator and match the in-memory writer; both name their one row
    by the first gene, as the JAX package's writer does."""
    ad_ref, ad_stream = _prepped(60, 18, seed=7), _prepped(60, 18, seed=7)
    net = _net("zinb-shared", ad_ref)
    ref_dir, stream_dir = _both_writes(net, ad_ref, ad_stream, tmp_path)
    _files_equal(ref_dir, stream_dir, ["mean.tsv", "mean_norm.tsv", "latent.tsv",
                                       "reduced.tsv", "dispersion.tsv", "dropout.tsv",
                                       "pi.tsv"])
    disp = pd.read_csv(os.path.join(stream_dir, "dispersion.tsv"), sep="\t", index_col=0,
                       header=None)
    assert disp.shape == (1, 60) and list(disp.index) == ["g0"]


def test_streaming_elempi_sharedpi(tmp_path):
    """zinb-elempi with sharedpi has an (N, 1) pi head: routed by the head's
    width to the small-output accumulator, byte for byte as write()."""
    ad_ref, ad_stream = _prepped(60, 18, seed=21), _prepped(60, 18, seed=21)
    net = _net("zinb-elempi", ad_ref, sharedpi=True)
    _files_equal(*_both_writes(net, ad_ref, ad_stream, tmp_path),
                 ["mean.tsv", "mean_norm.tsv", "latent.tsv", "reduced.tsv",
                  "dispersion.tsv", "dropout.tsv", "pi.tsv"])


def test_streaming_width1_latent(tmp_path):
    """A width-1 bottleneck gives (N, 1) latent blocks, which still reach
    latent.tsv/reduced.tsv and the h5ad X_dca layer: routing is by key."""
    ad_ref, ad_stream = _prepped(50, 15, seed=23), _prepped(50, 15, seed=23)
    net = AE_types["zinb-conddisp"](input_size=15, hidden_size=(8, 1, 8), device="cpu").build()
    ref_dir, stream_dir = _both_writes(net, ad_ref, ad_stream, tmp_path)
    _files_equal(ref_dir, stream_dir, EXPECT["zinb-conddisp"])
    assert os.path.getsize(os.path.join(stream_dir, "latent.tsv")) > 0

    net.write_streaming(_prepped(50, 15, seed=23), str(tmp_path / "h5"), mode="full",
                        return_info=True, output_format="h5ad")
    back = read_h5ad(str(tmp_path / "h5" / "denoised.h5ad"))
    assert back.obsm["X_dca"].shape == (50, 1)
    np.testing.assert_allclose(back.obsm["X_dca"], ad_ref.obsm["X_dca"], rtol=1e-6)


def test_streaming_denoise_subset_post_disp(tmp_path):
    """nb-conddisp with output_size < input_size (--denoisesubset): the
    post-denoise dispersion reads the unscaled input block, as the
    in-memory path reads adata.X, which a subset leaves as it is."""
    g, k = 20, 7
    ad_ref, ad_stream = _prepped(60, g, seed=25), _prepped(60, g, seed=25)
    net = AE_types["nb-conddisp"](input_size=g, output_size=k, hidden_size=(8, 4, 8),
                                  device="cpu").build()
    ref_dir, stream_dir = _both_writes(net, ad_ref, ad_stream, tmp_path,
                                       colnames=ad_ref.var_names.values[:k])
    _files_equal(ref_dir, stream_dir, EXPECT["nb-conddisp"])


def test_streaming_latent_mode(tmp_path):
    ad_ref, ad_stream = _prepped(50, 15, seed=9), _prepped(50, 15, seed=9)
    net = _net("zinb-conddisp", ad_ref)
    ref_dir, stream_dir = _both_writes(net, ad_ref, ad_stream, tmp_path, mode="latent")
    _files_equal(ref_dir, stream_dir, ["latent.tsv", "reduced.tsv"])
    assert not os.path.exists(os.path.join(stream_dir, "mean.tsv"))


def test_streaming_h5ad_roundtrip(tmp_path):
    """output_format='h5ad': X equals the in-memory denoised matrix, the
    layers carry the obsm side effects, names survive; readable by
    data.adata.read_h5ad.  Latent mode cannot write h5ad."""
    ad_ref, ad_stream = _prepped(70, 22, seed=11), _prepped(70, 22, seed=11)
    net = _net("zinb-conddisp", ad_ref)
    net.predict(ad_ref, mode="full", return_info=True)
    net.write_streaming(ad_stream, str(tmp_path), mode="full", return_info=True,
                        output_format="h5ad")
    back = read_h5ad(os.path.join(str(tmp_path), "denoised.h5ad"))
    np.testing.assert_allclose(np.asarray(back.X), np.asarray(ad_ref.X), rtol=1e-6)
    for key in ("X_dca", "X_dca_dropout", "X_dca_dispersion", "X_dca_mean_norm"):
        np.testing.assert_allclose(back.obsm[key], ad_ref.obsm[key], rtol=1e-6, err_msg=key)
    assert list(back.obs_names) == list(ad_stream.obs_names)
    assert list(back.var_names) == list(ad_stream.var_names)
    assert sorted(os.listdir(tmp_path)) == ["denoised.h5ad"]
    with pytest.raises(ValueError, match="h5ad"):
        net.write_streaming(ad_stream, str(tmp_path), mode="latent", output_format="h5ad")


def test_streaming_no_spill_left_behind(tmp_path, monkeypatch):
    ad = _prepped(40, 12, seed=13)
    net = _net("nb-conddisp", ad)
    net.write_streaming(ad, str(tmp_path), mode="full", return_info=True, chunk_rows=16)
    leftovers = glob.glob(os.path.join(str(tmp_path), "*.spill")) + \
        glob.glob(os.path.join(str(tmp_path), "*.tmp"))
    assert leftovers == []

    # a failure in the middle aborts every writer and removes its scratch
    def boom(*a, **k):
        raise RuntimeError("forward failed")

    calls = {"n": 0}
    apply = net.apply

    def second_block_fails(*a, **k):
        calls["n"] += 1
        return boom() if calls["n"] == 3 else apply(*a, **k)

    monkeypatch.setattr(net, "apply", second_block_fails)
    with pytest.raises(RuntimeError, match="forward failed"):
        net.write_streaming(_prepped(40, 12, seed=13), str(tmp_path / "failed"), mode="full",
                            return_info=True, chunk_rows=16)
    assert os.listdir(tmp_path / "failed") == []


def test_forward_pipelined_matches_serial(monkeypatch):
    """The pipelined block iterator gives the outputs of the serial one
    (DCA_TPU_PREFETCH=0), for dense and CSR inputs."""
    ad = _prepped(75, 16, seed=15)
    net = _net("zinb-conddisp", ad)
    for x in (np.asarray(ad.X), sp.csr_matrix(np.asarray(ad.X))):
        out_p = net.forward(x, chunk_rows=16)
        monkeypatch.setenv("DCA_TPU_PREFETCH", "0")
        out_s = net.forward(x, chunk_rows=16)
        monkeypatch.delenv("DCA_TPU_PREFETCH")
        for k, v in out_p.items():
            if v is not None:
                np.testing.assert_array_equal(v, out_s[k], err_msg=k)
        blocks = [(lo, hi) for lo, hi, _ in net.iter_forward_blocks(x, chunk_rows=16)]
        assert blocks == [(0, 16), (16, 32), (32, 48), (48, 64), (64, 75)]


def test_fetch_dtype_downcasts_outputs(monkeypatch):
    """DCA_TPU_FETCH_DTYPE=bf16 brings the outputs back through bfloat16
    (lossy, float32 on the host); an unknown value raises."""
    ad = _prepped(30, 12, seed=27)
    net = _net("zinb-conddisp", ad)
    x = np.asarray(ad.X)
    exact = net.forward(x, keys=("mean",))["mean"]
    monkeypatch.setenv("DCA_TPU_FETCH_DTYPE", "bf16")
    low = net.forward(x, keys=("mean",))["mean"]
    assert low.dtype == np.float32
    np.testing.assert_array_equal(low, torch.from_numpy(exact).bfloat16().float().numpy())
    monkeypatch.setenv("DCA_TPU_FETCH_DTYPE", "f64")
    with pytest.raises(ValueError, match="DCA_TPU_FETCH_DTYPE"):
        net.forward(x)


def test_lazy_scale_matches_jax(monkeypatch):
    """normalize(lazy_scale=True) keeps X sparse and stores the JAX
    package's statistics; auto_lazy_scale decides as the JAX package's."""
    c = sp.csr_matrix(_counts(60, 14, seed=29))
    ad = io.normalize(io.read_dataset(AnnData(c.copy())), lazy_scale=True)
    jad = jio.normalize(jio.read_dataset(JAnnData(c.copy())), lazy_scale=True)
    assert sp.issparse(ad.X)
    for k in ("dca_scale_mean", "dca_scale_std"):
        np.testing.assert_array_equal(ad.uns[k], jad.uns[k])
    # the deferred scale equals the eager one, to float32 rounding
    eager = io.normalize(io.read_dataset(AnnData(c.copy())))
    mean, std = io.scale_stats(ad)
    np.testing.assert_allclose((ad.X.toarray() - mean) / std, eager.X, rtol=1e-5, atol=1e-5)
    assert io.scale_stats(eager) == (None, None)
    monkeypatch.setenv("DCA_TPU_HOST_DENSE_BYTES", "1000")
    for adata in (AnnData(c.copy()), AnnData(c.toarray())):
        assert io.auto_lazy_scale(adata) == jio.auto_lazy_scale(JAnnData(adata.X))
    assert io.auto_lazy_scale(AnnData(c.copy()))


@pytest.mark.parametrize("ae_type", ["zinb-conddisp", "nb-conddisp"])
def test_written_values_match_jax_write_streaming(ae_type, tmp_path):
    """The port's streaming TSVs against the JAX package's write_streaming
    on the same weights and the same lazily scaled sparse input, 3 blocks:
    the same files, index and headers, values equal to the 6 printed
    decimals up to float32 forward rounding."""
    c = _counts(70, 16, seed=31)
    jad = jio.normalize(jio.read_dataset(JAnnData(sp.csr_matrix(c), *_frames(70, 16)),
                                         check_counts=False), lazy_scale=True)
    ad = io.normalize(io.read_dataset(AnnData(sp.csr_matrix(c), *_frames(70, 16)),
                                      check_counts=False), lazy_scale=True)
    jnet = JAE_types[ae_type](input_size=16, hidden_size=(8, 4, 8), seed=2).build()
    net = AE_types[ae_type](input_size=16, hidden_size=(8, 4, 8), device="cpu").build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jnet.write_streaming(jad, jdir, mode="full", return_info=True, chunk_rows=32)
    net.write_streaming(ad, pdir, mode="full", return_info=True, chunk_rows=32)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == sorted(EXPECT[ae_type])
    for f in EXPECT[ae_type]:
        kw = dict(sep="\t", index_col=0,
                  header=0 if f in ("mean.tsv", "mean_norm.tsv") else None)
        a = pd.read_csv(os.path.join(pdir, f), **kw)
        b = pd.read_csv(os.path.join(jdir, f), **kw)
        assert list(a.index) == list(b.index) and list(a.columns) == list(b.columns), f
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=1e-5, atol=2e-6,
                                   err_msg=f)
    np.testing.assert_allclose(ad.obsm["X_dca"], jad.obsm["X_dca"], rtol=1e-5, atol=1e-6)


@pytest.fixture()
def input_tsv(tmp_path):
    c = _counts(64, 14, seed=17)
    path = str(tmp_path / "counts.tsv")
    pd.DataFrame(c.T.astype(int), index=[f"g{i}" for i in range(14)],
                 columns=[f"c{i}" for i in range(64)]).to_csv(path, sep="\t")
    return path


def _cli(input_tsv, outdir, *extra):
    main([input_tsv, outdir, "-e", "2", "-s", "8,4,8", "--device", "cpu", *extra])


def test_cli_streaming_write_matches_in_memory(input_tsv, tmp_path, monkeypatch, capsys):
    """The CLI forced through the streaming write (DCA_TPU_HOST_DENSE_BYTES=1)
    writes the in-memory branch's TSVs byte for byte."""
    _cli(input_tsv, str(tmp_path / "mem"), "--type", "nb-conddisp")
    assert "[streaming]" not in capsys.readouterr().out
    monkeypatch.setenv("DCA_TPU_HOST_DENSE_BYTES", "1")
    _cli(input_tsv, str(tmp_path / "stream"), "--type", "nb-conddisp")
    assert "[streaming]" in capsys.readouterr().out
    _files_equal(str(tmp_path / "mem"), str(tmp_path / "stream"), EXPECT["nb-conddisp"])


def test_cli_outputformat_h5ad(input_tsv, tmp_path):
    """--outputformat h5ad writes a readable denoised.h5ad whose X is the
    TSV run's mean matrix (the same seed and training)."""
    _cli(input_tsv, str(tmp_path / "tsv"), "--type", "zinb-conddisp")
    _cli(input_tsv, str(tmp_path / "h5"), "--type", "zinb-conddisp", "--outputformat", "h5ad")
    back = read_h5ad(str(tmp_path / "h5" / "denoised.h5ad"))
    mean = pd.read_csv(os.path.join(str(tmp_path / "tsv"), "mean.tsv"), sep="\t",
                       index_col=0).to_numpy().T  # gene x cell -> cell x gene
    np.testing.assert_allclose(np.asarray(back.X), mean, rtol=1e-4, atol=2e-6)
    assert "X_dca" in back.obsm and "X_dca_dropout" in back.obsm
    assert list(back.var_names) == [f"g{i}" for i in range(14)]
