"""The port's native IO tier (``dca_tpu_torch/native``) against the JAX
package's (``dca_tpu/native``) and against pandas, on the CPU: the parser
(corner and R-style headers, CSV and gzip, empty fields, ragged rows), the
``%.6f`` formatter and writer byte for byte (every header/index
combination, NaN, infinities, -0.0, large values, transposed), the batch
assembly functions, the thread cap, the pandas fallback under
DCA_TPU_NO_NATIVE=1, the CLI's TSVs against the JAX package's on the same
weights, and two processes building the library at once."""

import gzip
import io as _pyio
import os
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import jax

from dca_tpu import native as jnative
from dca_tpu.__main__ import main as jmain
from dca_tpu.data import io as jio
from dca_tpu.models import network as jnetwork

from dca_tpu_torch import native
from dca_tpu_torch.__main__ import main
from dca_tpu_torch.bridge import params_from_jax
from dca_tpu_torch.data import io, stream_write
from dca_tpu_torch.models import network

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_native():
    """The JAX package builds its library in place, so a process that
    loaded it while another process was writing it keeps the fallbacks for
    good: such a process loads it again once the file is whole."""
    for _ in range(60):
        if jnative.available():
            return
        jnative._tried = False
        time.sleep(1.0)
    raise AssertionError("the JAX package's native library did not load")


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    """Every test starts with both libraries built and loaded (g++ is part
    of the test environment: a failed build fails here, it is not
    skipped)."""
    monkeypatch.delenv("DCA_TPU_NO_NATIVE", raising=False)
    assert native.available(), "the native library did not build"
    _load_jax_native()


def _awkward_matrix(rs, rows, cols):
    """Normal values with the cases a %.6f formatter can get wrong: NaN,
    both infinities, -0.0, values that round to -0.000000, large and
    near-maximal floats, and near-ties at the 6th decimal."""
    X = rs.normal(scale=100.0, size=(rows, cols)).astype(np.float32)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, -1e-7, 1e-7, 123456.789,
                        -5.5, 0.1234565, 2.5e-6, 1e30, -3.4e38, 3.4028235e38, 16777217.0,
                        0.5, 1.0000005], np.float32)
    flat = X.reshape(-1)
    flat[:len(special)] = special
    return X


def _pandas_bytes(X, rownames, colnames):
    buf = _pyio.StringIO()
    pd.DataFrame(X, index=rownames, columns=colnames).to_csv(
        buf, sep="\t", float_format="%.6f", index=rownames is not None,
        header=colnames is not None)
    return buf.getvalue().encode()


# ---------------------------------------------------------------------------
# parse
# ---------------------------------------------------------------------------


def _parsed_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and a[2] == b[2]


def test_parse_corner_header_matches_jax_and_pandas(tmp_path):
    rs = np.random.RandomState(0)
    X = rs.normal(size=(37, 11)).astype(np.float32)
    df = pd.DataFrame(X, index=[f"gene_{i}" for i in range(37)],
                      columns=[f"cell{j}" for j in range(11)])
    p = tmp_path / "m.tsv"
    df.to_csv(p, sep="\t")  # corner cell present (empty index name)
    got = native.parse_text_matrix(str(p), sep="\t")
    _parsed_equal(got, jnative.parse_text_matrix(str(p), sep="\t"))
    ref = pd.read_csv(p, sep="\t", index_col=0)
    np.testing.assert_array_equal(got[0], ref.to_numpy(np.float32))
    assert got[1] == list(ref.index) and got[2] == list(ref.columns)


def test_parse_r_style_header_matches_jax(tmp_path):
    """R write.table: the header has one field fewer than the rows."""
    rs = np.random.RandomState(1)
    X = rs.poisson(1.5, size=(23, 7)).astype(np.float32)
    p = tmp_path / "r.tsv"
    with open(p, "w") as f:
        f.write("\t".join(f"c{j}" for j in range(7)) + "\n")
        for i in range(23):
            f.write(f"g{i}\t" + "\t".join(str(int(v)) for v in X[i]) + "\n")
    got = native.parse_text_matrix(str(p))
    _parsed_equal(got, jnative.parse_text_matrix(str(p)))
    np.testing.assert_array_equal(got[0], X)
    assert got[1] == [f"g{i}" for i in range(23)] and got[2] == [f"c{j}" for j in range(7)]


@pytest.mark.parametrize("suffix", [".csv", ".csv.gz", ".tsv.gz"])
def test_read_text_csv_and_gzip_match_jax(tmp_path, suffix):
    rs = np.random.RandomState(2)
    X = rs.poisson(1.5, size=(12, 5)).astype(np.float32)
    df = pd.DataFrame(X, index=[f"r{i}" for i in range(12)],
                      columns=[f"c{j}" for j in range(5)])
    p = str(tmp_path / f"m{suffix}")
    text = df.to_csv(sep="," if ".csv" in suffix else "\t")
    if suffix.endswith(".gz"):
        with gzip.open(p, "wt") as f:
            f.write(text)
    else:
        with open(p, "w") as f:
            f.write(text)
    ad, jad = io.read_text(p), jio.read_text(p)
    np.testing.assert_array_equal(np.asarray(ad.X), X)
    np.testing.assert_array_equal(np.asarray(ad.X), np.asarray(jad.X))
    assert list(ad.obs.index) == list(jad.obs.index) == list(df.index)
    assert list(ad.var.index) == list(jad.var.index) == list(df.columns)


def test_parse_empty_fields_are_nan():
    buf = b"\tc0\tc1\nr0\t1.5\t\nr1\t\t2.0\n"
    X, _, _ = native.parse_text_matrix(buf)
    _parsed_equal((X, None, None), (jnative.parse_text_matrix(buf)[0], None, None))
    assert X[0, 0] == 1.5 and np.isnan(X[0, 1]) and np.isnan(X[1, 0]) and X[1, 1] == 2.0


def test_parse_rejects_extra_fields(tmp_path):
    """A row with more fields than the header is not parsed silently: the
    native parser defers (None) and read_text raises pandas' error, as the
    JAX package's does."""
    good = b"\tc0\tc1\ng0\t1\t2\ng1\t3\t4\n"
    ragged = b"\tc0\tc1\ng0\t1\t2\ng1\t3\t4\t5\n"
    assert native.parse_text_matrix(good) is not None
    assert native.parse_text_matrix(ragged) is None is jnative.parse_text_matrix(ragged)
    p = tmp_path / "ragged.tsv"
    p.write_bytes(ragged)
    with pytest.raises(pd.errors.ParserError):
        io.read_text(str(p))
    with pytest.raises(pd.errors.ParserError):
        jio.read_text(str(p))


# ---------------------------------------------------------------------------
# format and write
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transpose", [False, True], ids=["plain", "transposed"])
@pytest.mark.parametrize("with_rows,with_cols", [(True, True), (True, False), (False, True),
                                                 (False, False)])
def test_write_text_matrix_bytes_match_jax_and_pandas(tmp_path, monkeypatch, with_rows,
                                                      with_cols, transpose):
    """The port's writer through the native tier, the JAX package's, and the
    port's pandas path (DCA_TPU_NO_NATIVE=1) write the same bytes."""
    X = _awkward_matrix(np.random.RandomState(4), 21, 9)
    rn = [f"cell {i}" for i in range(21)] if with_rows else None
    cn = [f"g{j}" for j in range(9)] if with_cols else None
    paths = {k: str(tmp_path / f"{k}.tsv") for k in ("native", "jax", "pandas")}
    io.write_text_matrix(X, paths["native"], rownames=rn, colnames=cn, transpose=transpose)
    jio.write_text_matrix(X, paths["jax"], rownames=rn, colnames=cn, transpose=transpose)
    monkeypatch.setenv("DCA_TPU_NO_NATIVE", "1")
    assert not native.available()
    io.write_text_matrix(X, paths["pandas"], rownames=rn, colnames=cn, transpose=transpose)
    got = {k: open(p, "rb").read() for k, p in paths.items()}
    assert got["native"] == got["jax"] == got["pandas"]
    out_rows, header = (9, rn is not None) if transpose else (21, cn is not None)
    assert got["native"].count(b"\n") == out_rows + header
    assert b"-0.000000" in got["native"] and b"-inf" in got["native"]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("with_rows,with_cols", [(True, True), (False, False)])
def test_format_matrix_bytes_match_jax_and_pandas(with_rows, with_cols):
    X = _awkward_matrix(np.random.RandomState(5), 33, 17)
    rn = [f"r{i}" for i in range(33)] if with_rows else None
    cn = [f"c{j}" for j in range(17)] if with_cols else None
    got = native.format_matrix(X, rownames=rn, colnames=cn)
    assert got == jnative.format_matrix(X, rownames=rn, colnames=cn)
    assert got == _pandas_bytes(X, rn, cn)


def test_shared_head_rows_named_by_the_first_gene(tmp_path):
    """The *-shared heads' (N, 1) outputs written transposed against G gene
    names: one row, named by the first gene, as the JAX writer names it."""
    col = np.random.RandomState(6).uniform(size=(15, 1)).astype(np.float32)
    genes = [f"gene{j}" for j in range(8)]
    a, b = str(tmp_path / "a.tsv"), str(tmp_path / "b.tsv")
    io.write_text_matrix(col, a, colnames=genes, transpose=True)
    jio.write_text_matrix(col, b, colnames=genes, transpose=True)
    text = open(a, "rb").read()
    assert text == open(b, "rb").read() and text.startswith(b"gene0\t")


def test_streaming_writers_same_bytes_without_native(tmp_path, monkeypatch):
    """RowStreamTSV and TransposedSpillTSV format through the native tier,
    or through pandas under DCA_TPU_NO_NATIVE=1, with the same bytes as
    write_text_matrix."""
    X = _awkward_matrix(np.random.RandomState(7), 40, 6)
    cells = [f"c{i}" for i in range(40)]
    genes = [f"g{j}" for j in range(6)]
    out = {}
    for mode in ("native", "pandas"):
        if mode == "pandas":
            monkeypatch.setenv("DCA_TPU_NO_NATIVE", "1")
        rows = stream_write.RowStreamTSV(str(tmp_path / f"rows_{mode}.tsv"), rownames=cells)
        spill = stream_write.TransposedSpillTSV(str(tmp_path / f"t_{mode}.tsv"),
                                                rownames=genes, colnames=cells, strip_rows=4)
        for lo in range(0, 40, 16):
            rows.append(X[lo:lo + 16])
            spill.append(X[lo:lo + 16])
        rows.close()
        spill.close()
        out[mode] = [open(str(tmp_path / f"{n}_{mode}.tsv"), "rb").read()
                     for n in ("rows", "t")]
    jio.write_text_matrix(X, str(tmp_path / "ref_rows.tsv"), rownames=cells)
    jio.write_text_matrix(X, str(tmp_path / "ref_t.tsv"), rownames=cells, colnames=genes,
                          transpose=True)
    ref = [open(str(tmp_path / f"ref_{n}.tsv"), "rb").read() for n in ("rows", "t")]
    assert out["native"] == out["pandas"] == ref


# ---------------------------------------------------------------------------
# batch assembly
# ---------------------------------------------------------------------------


def _csr(rs, n_rows=50, n_cols=40, density=0.1):
    dense = ((rs.uniform(size=(n_rows, n_cols)) < density)
             * rs.poisson(3, size=(n_rows, n_cols))).astype(np.float32)
    dense[3] = 0.0  # an empty row
    return dense, sp.csr_matrix(dense)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "fallback"])
def test_batch_assembly_matches_jax(monkeypatch, use_native):
    rs = np.random.RandomState(8)
    dense, csr = _csr(rs)
    rows = np.concatenate([rs.permutation(50)[:17], [3]])
    args = (csr.indptr, csr.indices, csr.data)
    if not use_native:
        monkeypatch.setenv("DCA_TPU_NO_NATIVE", "1")
    out = native.densify_rows(*args, rows, 40)
    np.testing.assert_array_equal(out, jnative.densify_rows(*args, rows, 40))
    np.testing.assert_array_equal(out, dense[rows])
    for got, want in zip(native.csr_to_padded(*args, rows, 6, 40),
                         jnative.csr_to_padded(*args, rows, 6, 40)):
        np.testing.assert_array_equal(got, want)
    total = int(sum(csr.indptr[r + 1] - csr.indptr[r] for r in rows))
    for L in (total + 9, total - 1):
        got = native.csr_to_flat(*args, rows, L, 50)
        want = jnative.csr_to_flat(*args, rows, L, 50)
        assert got[3] == want[3] == total
        if L >= total:
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(g, w)
    X = rs.normal(size=(30, 13)).astype(np.float32)
    idx = rs.permutation(30)[:9]
    np.testing.assert_array_equal(native.gather_rows(X, idx), X[idx])
    np.testing.assert_array_equal(native.gather_rows(X, idx), jnative.gather_rows(X, idx))


def test_batch_assembly_indices_out_of_range_behave_as_numpy():
    """The C loops never read outside the arrays: negative or too large row
    indices go to the numpy path, which wraps or raises as numpy does."""
    X = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(native.gather_rows(X, [-1, 0]), X[[-1, 0]])
    with pytest.raises(IndexError):
        native.gather_rows(X, [4])
    _, csr = _csr(np.random.RandomState(9), 5, 4, 0.5)
    with pytest.raises(IndexError):
        native.densify_rows(csr.indptr, csr.indices, csr.data, [5], 4)
    with pytest.raises(ValueError, match="out must be"):
        native.gather_rows(X, [0], out=np.empty((1, 3), np.float64))


def test_set_threads_caps_the_pool():
    before = native.n_threads()
    try:
        native.set_threads(1)
        assert native.n_threads() == 1
        native.set_threads(2)
        assert native.n_threads() == 2
        native.set_threads(None)  # no-op
        assert native.n_threads() == 2
    finally:
        native.set_threads(before)


def test_no_native_switch(monkeypatch):
    """DCA_TPU_NO_NATIVE=1 turns the tier off without unloading it: the
    text functions defer to pandas, the rest take their numpy paths."""
    monkeypatch.setenv("DCA_TPU_NO_NATIVE", "1")
    assert not native.available() and native.n_threads() == 1
    assert native.parse_text_matrix(b"\tc0\nr0\t1\n") is None
    assert native.format_matrix(np.zeros((2, 2), np.float32)) is None
    monkeypatch.delenv("DCA_TPU_NO_NATIVE")
    assert native.available()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_tsvs_match_jax_on_the_same_weights(tmp_path, monkeypatch):
    """Both CLIs, zinb-conddisp with PReLU, read the same TSV and write the
    denoise of the same weights (the JAX package's initial ones, carried
    across; -e 0): the same files, each with the same header and row names
    byte for byte and values equal to the 6 printed decimals up to the two
    libraries' float32 forward rounding.  Every file the port writes is,
    byte for byte, what the JAX package's writer writes for the same
    matrix."""
    counts = make_counts(60, 20, seed=11)
    inp = str(tmp_path / "counts.tsv")
    pd.DataFrame(counts.T.astype(int), index=[f"gene{i}" for i in range(20)],
                 columns=[f"cell{i}" for i in range(60)]).to_csv(inp, sep="\t")
    flags = ["-e", "0", "-s", "16,8,16", "--type", "zinb-conddisp", "--activation", "PReLU"]

    built = []
    jbuild = jnetwork.Autoencoder.build
    monkeypatch.setattr(jnetwork.Autoencoder, "build",
                        lambda self: built.append(jbuild(self)) or built[-1])
    jmain([inp, str(tmp_path / "jax"), *flags])
    jnet = built[0]

    pbuild = network.Autoencoder.build

    def bridged_build(self):
        pbuild(self)
        self.model.load_state_dict(params_from_jax(
            jax.tree_util.tree_map(np.asarray, jnet.params),
            jax.tree_util.tree_map(np.asarray, jnet.state)))
        return self

    writes = []
    pwrite = network.write_text_matrix

    def spy(matrix, filename, **kw):
        writes.append((np.array(matrix), os.path.basename(filename), kw))
        return pwrite(matrix, filename, **kw)

    monkeypatch.setattr(network.Autoencoder, "build", bridged_build)
    monkeypatch.setattr(network, "write_text_matrix", spy)
    main([inp, str(tmp_path / "port"), *flags, "--device", "cpu"])

    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    tsvs = sorted(f for f in os.listdir(jdir) if f.endswith(".tsv"))
    assert tsvs == sorted(f for f in os.listdir(pdir) if f.endswith(".tsv"))
    assert sorted(w[1] for w in writes) == tsvs
    for f in tsvs:
        port_lines = open(os.path.join(pdir, f), "rb").read().split(b"\n")
        jax_lines = open(os.path.join(jdir, f), "rb").read().split(b"\n")
        assert len(port_lines) == len(jax_lines), f
        header = 1 if f in ("mean.tsv", "mean_norm.tsv") else 0
        assert port_lines[:header] == jax_lines[:header], f
        assert [ln.split(b"\t")[0] for ln in port_lines] == \
            [ln.split(b"\t")[0] for ln in jax_lines], f
        kw = dict(sep="\t", index_col=0, header=0 if header else None)
        np.testing.assert_allclose(pd.read_csv(os.path.join(pdir, f), **kw).to_numpy(),
                                   pd.read_csv(os.path.join(jdir, f), **kw).to_numpy(),
                                   rtol=1e-5, atol=2e-6, err_msg=f)
    for matrix, fname, kw in writes:
        ref = str(tmp_path / f"ref_{fname}")
        jio.write_text_matrix(matrix, ref, **kw)
        assert open(os.path.join(pdir, fname), "rb").read() == open(ref, "rb").read(), fname


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes build into the same empty build directory at once:
    each compiles in a temporary directory and renames its library into
    place, so both load a whole library, and nothing else is left."""
    code = ("import sys\n"
            "from dca_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "assert native.available() and native.n_threads() >= 1\n"
            "print(native.lib_path())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("DCA_TPU_NO_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    lib = paths.pop()
    assert os.path.dirname(os.path.dirname(lib)) == str(tmp_path)
    assert os.listdir(os.path.dirname(lib)) == [native.LIB_NAME]


@pytest.fixture
def _fresh_library(monkeypatch):
    """The library forgotten for one test (the next call to the tier builds
    or loads anew), and loaded again from the real build directory after."""
    native._library.cache_clear()
    yield
    monkeypatch.undo()
    native._library.cache_clear()
    assert native.available()


def _fallback_io_is_pandas(tmp_path):
    """read_text and write_text_matrix give pandas' array and bytes."""
    X = _awkward_matrix(np.random.RandomState(8), 13, 6)
    rn, cn = [f"cell{i}" for i in range(13)], [f"g{j}" for j in range(6)]
    out = str(tmp_path / "out.tsv")
    io.write_text_matrix(X, out, rownames=rn, colnames=cn)
    assert open(out, "rb").read() == _pandas_bytes(X, rn, cn)
    ad = io.read_text(out)
    ref = pd.read_csv(out, sep="\t", index_col=0)
    np.testing.assert_array_equal(np.asarray(ad.X), ref.to_numpy(np.float32))
    assert list(ad.obs_names) == rn and list(ad.var_names) == cn


def test_unwritable_build_directory_leaves_pandas(tmp_path, monkeypatch, _fresh_library):
    """A build directory that cannot be made (here a file stands at its
    path, which stops root too, unlike a read-only mode) leaves the pandas
    path, once: the failure is cached, not raised."""
    blocker = tmp_path / "build"
    blocker.write_bytes(b"")
    monkeypatch.setattr(native, "BUILD_DIR", str(blocker / "sub"))
    assert native._library() is None
    assert not native.available() and native.n_threads() == 1
    assert native.format_matrix(np.zeros((2, 2), np.float32)) is None
    _fallback_io_is_pandas(tmp_path)


def test_failed_compile_leaves_pandas(tmp_path, monkeypatch, _fresh_library):
    """A g++ that fails is run twice, the second time without
    -march=native, then never again in the process; the temporary build
    directory goes, and the text functions give pandas' bytes."""
    fake = tmp_path / "bin"
    fake.mkdir()
    log = tmp_path / "gxx.log"
    (fake / "g++").write_text(f"#!/bin/sh\necho \"$*\" >> {log}\nexit 1\n")
    (fake / "g++").chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake}{os.pathsep}{os.environ['PATH']}")
    build = tmp_path / "build"
    monkeypatch.setattr(native, "BUILD_DIR", str(build))
    assert not native.available()
    assert not native.available() and native.parse_text_matrix(b"\tc0\nr0\t1\n") is None
    calls = log.read_text().splitlines()
    assert len(calls) == 2
    assert "-march=native" in calls[0].split() and "-march=native" not in calls[1].split()
    assert os.listdir(os.path.dirname(native.lib_path())) == []
    _fallback_io_is_pandas(tmp_path)
