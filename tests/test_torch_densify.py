"""The streaming trainer's data tier in the port, held against the JAX
package on the CPU: the payload builders and every device scatter of
``dca_tpu_torch/ops/densify.py`` against ``dca_tpu/ops/densify.py`` (and
scipy's ``toarray``), the chunked loader ``data/loader.py``,
``train/loop.py::_derivable_row_scale``, ``ops/resident.py::ResidentCSR``,
the block forward's payload branch and ``config.use_device_densify``.

The JAX scatters run as XLA programs on the CPU; the port's are PyTorch
``index_put_`` on CPU tensors.  Both give the matrix exactly, so the
comparisons are exact, except the derived input of ``ResidentCSR.part``:
its log1p is XLA's in the JAX package and PyTorch's here, which differ by
one float32 ulp on about a fifth of the inputs (held at that ulp).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

from dca_tpu.data import loader as jloader
from dca_tpu.ops import densify as jd
from dca_tpu.ops.resident import ResidentCSR as JResidentCSR
from dca_tpu.train.loop import _derivable_row_scale as j_derivable_row_scale

from dca_tpu_torch import config
from dca_tpu_torch.data import loader
from dca_tpu_torch.ops import densify as td
from dca_tpu_torch.ops.resident import ResidentCSR
from dca_tpu_torch.train.loop import _derivable_row_scale

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once


def _random_csr(B, G, density, seed=0, empty_rows=(), big=False):
    rs = np.random.RandomState(seed)
    m = sp.random(B, G, density=density, format="csr", random_state=rs,
                  data_rvs=lambda n: rs.poisson(3.0, n) + 1.0).astype(np.float32)
    if empty_rows:
        lil = m.tolil()
        for r in empty_rows:
            lil[r] = 0
        m = lil.tocsr()
        m.eliminate_zeros()
    if big and m.nnz:
        m.data[::7] = 40000.0  # above int16: the uint16 stream's widening
    m.sort_indices()
    return m


CASES = [((32, 300), 0.1, ()), ((13, 513), 0.05, (0, 5)), ((64, 128), 0.5, ()),
         ((9, 40), 0.2, (0, 1, 2, 3, 4, 5, 6, 7, 8))]


def _stats(G, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=G).astype(np.float32),
            rs.uniform(0.5, 2.0, size=G).astype(np.float32))


# ---------------------------------------------------------------------------
# payload builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int_vals", [False, True])
@pytest.mark.parametrize("shape,density,empty", CASES)
def test_payload_builders_equal_jax(shape, density, empty, int_vals):
    m = _random_csr(*shape, density, seed=2, empty_rows=empty)
    rows = np.random.RandomState(3).permutation(shape[0])
    for K in (None, int(np.diff(m.indptr).max()) + 3):
        got = td.payload_from_csr(m, rows, K, int_vals=int_vals)
        want = jd.payload_from_csr(m, rows, K, int_vals=int_vals)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    L = td.flat_slots_for(m, rows)
    assert L == jd.flat_slots_for(m, rows)
    for a, b in zip(td.flat_payload_from_csr(m, rows, L, int_vals=int_vals),
                    jd.flat_payload_from_csr(m, rows, L, int_vals=int_vals)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(td.flat8_payload_from_csr(m, rows, L, 64, 64),
                    jd.flat8_payload_from_csr(m, rows, L, 64, 64)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_flat_slots_ladder_and_overflows_equal_jax():
    m = _random_csr(40, 70, 0.3, seed=4)
    nnz = np.diff(m.indptr)
    rows = np.argsort(-nnz)[:10]  # the heaviest rows: above the moments' bucket
    moments = (float(nnz.mean()), 0.0)
    assert td.flat_slots_for(m, rows, moments, nnz) == jd.flat_slots_for(m, rows, moments, nnz)
    with pytest.raises(ValueError, match="overflow"):
        td.flat_payload_from_csr(m, np.arange(40), m.nnz - 1)
    wide = sp.csr_matrix((np.full(64, 300.5, np.float32),
                          np.sort(np.random.RandomState(0).choice(100_000, 64, replace=False)),
                          [0, 64]), shape=(1, 100_000))
    with pytest.raises(td.Flat8Overflow) as got:
        td.flat8_payload_from_csr(wide, [0], 128, 2, 2)
    with pytest.raises(jd.Flat8Overflow) as want:
        jd.flat8_payload_from_csr(wide, [0], 128, 2, 2)
    assert (got.value.need_g, got.value.need_v) == (want.value.need_g, want.value.need_v)


# ---------------------------------------------------------------------------
# the device scatters
# ---------------------------------------------------------------------------


def _padded(m, rows, scale, int_vals):
    idx, dat = td.payload_from_csr(m, rows, int_vals=int_vals)
    return (td.device_densify(idx, dat, m.shape[1], *scale),
            jd.device_densify(idx, dat, m.shape[1], *scale))


def _flat(m, rows, scale, int_vals):
    L = td.flat_slots_for(m, rows)
    p = td.flat_payload_from_csr(m, rows, L, int_vals=int_vals)
    return (td.device_densify_flat(*p, len(rows), m.shape[1], *scale),
            jd.device_densify_flat(*p, len(rows), m.shape[1], *scale))


def _flat8(m, rows, scale, int_vals):
    L = td.flat_slots_for(m, rows)
    p = td.flat8_payload_from_csr(m, rows, L, 1024, 1024)
    return (td.device_densify_flat8(loader.Flat8Chunk(*p, len(rows), m.shape[1]), *scale),
            jd.device_densify_flat8(jloader.Flat8Chunk(*p, len(rows), m.shape[1]), *scale))


@pytest.mark.parametrize("scatter", [_padded, _flat, _flat8])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("shape,density,empty", CASES)
def test_scatters_equal_scipy_and_jax(scatter, scaled, shape, density, empty):
    """Every scatter gives scipy's matrix, and the JAX package's, exactly:
    empty rows, padding slots, the int16/uint16 wire (values above 32767
    included) and the fused z-scale."""
    m = _random_csr(*shape, density, seed=5, empty_rows=empty, big=True)
    rows = np.random.RandomState(6).permutation(shape[0])
    scale = _stats(shape[1]) if scaled else ()
    for int_vals in (False, True):
        got, want = scatter(m, rows, scale, int_vals)
        assert got.dtype == torch.float32 and tuple(got.shape) == (len(rows), shape[1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if not scaled:
            np.testing.assert_array_equal(got.numpy(), m[rows].toarray())


def test_flat8_exceptions_lossless_and_wide_panel_int32():
    """Gaps above 255 and values outside uint8 ride the exception streams;
    a panel wider than int16 keeps int32 column ids."""
    rs = np.random.RandomState(3)
    G = 200_000
    cols = [np.sort(rs.choice(G, 50, replace=False)) for _ in range(8)]
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    data = rs.uniform(-5, 5000, size=indptr[-1]).astype(np.float32)
    data[::3] = np.round(np.abs(data[::3]) % 200)
    m = sp.csr_matrix((data, np.concatenate(cols), indptr), shape=(8, G))
    got, want = _flat8(m, np.arange(8), (), False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), m.toarray())
    counts, c, v = td.flat_payload_from_csr(m, np.arange(8), m.nnz + 8)
    assert c.dtype == np.int32
    np.testing.assert_array_equal(td.device_densify_flat(counts, c, v, 8, G).numpy(), m.toarray())


def test_scatter_into_a_kept_buffer_writes_the_part_and_the_spare_slot_only():
    """``out``: the part is its first B * G elements, zeroed first (a
    stale earlier part leaves nothing), the padding lands in the last
    element, and nothing between them is written."""
    m = _random_csr(10, 30, 0.3, seed=7, empty_rows=(2,))
    rows = np.arange(10)
    out = torch.full((16 * 30 + 1,), 7.0)
    idx, dat = td.payload_from_csr(m, rows, int(np.diff(m.indptr).max()) + 4)
    got = td.device_densify(idx, dat, 30, out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_array_equal(got.numpy(), m.toarray())
    assert (out[10 * 30:-1] == 7.0).all()
    L = td.flat_slots_for(m, rows)
    got = td.device_densify_flat(*td.flat_payload_from_csr(m, rows, L, int_vals=True), 10, 30,
                                 out=out)
    np.testing.assert_array_equal(got.numpy(), m.toarray())
    assert (out[10 * 30:-1] == 7.0).all()
    with pytest.raises(ValueError, match="at least"):
        td.device_densify(idx, dat, 30, out=torch.zeros(10 * 30))


def test_densify_csr_matches_scipy():
    m = _random_csr(13, 513, 0.05, seed=8, empty_rows=(0, 5))
    np.testing.assert_array_equal(td.densify_csr(m.indptr, m.indices, m.data, 513).numpy(),
                                  m.toarray())
    np.testing.assert_array_equal(
        td.densify_csr(m.indptr, m.indices, m.data, 513).numpy(),
        np.asarray(jd.densify_csr(m.indptr, m.indices, m.data, 513)))


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def _pair(raw):
    scaled = raw.copy()
    scaled.data = np.log1p(scaled.data * 1.7).astype(np.float32)
    return scaled


def test_loader_mode_picks_equal_jax(monkeypatch):
    rs = np.random.RandomState(9)
    balanced = sp.csr_matrix((rs.uniform(size=(60, 80)) < 0.2).astype(np.float32))
    whale = balanced.tolil()
    whale[0, :] = 1.0
    whale = whale.tocsr()
    sf = np.ones(60, np.float32)
    for M in (balanced, whale):
        for mode in ("auto", "padded", "flat", "flat8"):
            for env in (None, "flat8", "padded"):
                if env is None:
                    monkeypatch.delenv("DCA_TPU_PAYLOAD", raising=False)
                else:
                    monkeypatch.setenv("DCA_TPU_PAYLOAD", env)
                for dd in (False, True):
                    got = loader.StreamingData(M, M, sf, 30, device_densify=dd, payload_mode=mode)
                    want = jloader.StreamingData(M, M, sf, 30, device_densify=dd,
                                                 payload_mode=mode)
                    assert (got._mode_x, got._mode_t, got._shared_pattern) == (
                        want._mode_x, want._mode_t, want._shared_pattern)
    monkeypatch.delenv("DCA_TPU_PAYLOAD", raising=False)
    assert loader.StreamingData(balanced, balanced, sf, 30, device_densify=True)._mode_t == "padded"
    assert loader.StreamingData(whale, whale, sf, 30, device_densify=True)._mode_t == "flat"


@pytest.mark.parametrize("mode", ["padded", "flat", "flat8", None])
def test_loader_parts_cover_every_row_once_and_equal_jax(mode):
    """index_chunks follow the permutation; every part's payload (or dense
    rows) equals the JAX loader's, the shared index stream aliased by
    identity, and the scattered parts rebuild input and target exactly."""
    rs = np.random.RandomState(10)
    raw = sp.csr_matrix((rs.uniform(size=(105, 40)) < 0.3).astype(np.float32)
                        * rs.poisson(4.0, size=(105, 40)).astype(np.float32))
    raw.eliminate_zeros()
    X = _pair(raw)
    mean, std = _stats(40)
    sf = np.arange(105, dtype=np.float32) + 1
    kw = dict(device_densify=mode is not None, payload_mode=mode or "auto")
    got = loader.StreamingData(X, raw, sf, 32, mean, std, **kw)
    want = jloader.StreamingData(X, raw, sf, 32, mean, std, **kw)
    perm = np.random.RandomState(0).permutation(105)
    parts = list(got.index_chunks(perm))
    assert [len(p) for p in parts] == [32, 32, 32, 9]
    np.testing.assert_array_equal(np.concatenate(parts), perm)
    for idx in parts:
        (x, t, s), (jx, jt, js) = got.materialize(idx), want.materialize(idx)
        np.testing.assert_array_equal(s, sf[idx])
        np.testing.assert_array_equal(s, js)
        for a, b in ((x, jx), (t, jt)):
            assert type(a).__name__ == type(b).__name__
            for name in getattr(a, "__slots__", ()):
                va, vb = getattr(a, name), getattr(b, name)
                assert np.asarray(va).dtype == np.asarray(vb).dtype, name
                np.testing.assert_array_equal(va, vb, err_msg=name)
            if mode is None:
                np.testing.assert_array_equal(a, b)
        if mode is None:
            np.testing.assert_array_equal(x, (X[idx].toarray() - mean) / std)
            np.testing.assert_array_equal(t, raw[idx].toarray())
            continue
        if mode == "padded":
            assert t.idx is x.idx
            xs = td.device_densify(x.idx, x.dat, 40, mean, std)
            ts = td.device_densify(t.idx, t.dat, 40)
        elif mode == "flat":
            assert t.counts is x.counts and t.col is x.col and t.val.dtype == np.uint16
            xs = td.device_densify_flat(x.counts, x.col, x.val, len(idx), 40, mean, std)
            ts = td.device_densify_flat(t.counts, t.col, t.val, len(idx), 40)
        else:
            xs = td.device_densify_flat8(x, mean, std)
            ts = td.device_densify_flat8(t)
        np.testing.assert_array_equal(ts.numpy(), raw[idx].toarray())
        np.testing.assert_array_equal(
            xs.numpy(), (X[idx].toarray() - mean) / std)


def test_loader_derive_input_ships_one_payload():
    rs = np.random.RandomState(11)
    raw = sp.csr_matrix((rs.uniform(size=(50, 40)) < 0.3).astype(np.float32) * 3)
    sd = loader.StreamingData(_pair(raw), raw, np.ones(50, np.float32), 25, device_densify=True,
                              derive_input=True)
    x, t, _ = sd.materialize(np.arange(25))
    assert x is t
    assert not loader.StreamingData(_pair(raw), raw, np.ones(50, np.float32), 25,
                                    derive_input=True).derive_input


# ---------------------------------------------------------------------------
# derive-input, resident CSR
# ---------------------------------------------------------------------------


def _lazy(X):
    from dca_tpu_torch.data import io
    from dca_tpu_torch.data.adata import AnnData

    return io.normalize(io.read_dataset(AnnData(sp.csr_matrix(X)), check_counts=False),
                        lazy_scale=True)


def test_derivable_row_scale_equals_jax():
    rs = np.random.RandomState(14)
    X = (rs.uniform(size=(60, 30)) < 0.4).astype(np.float32) * \
        rs.poisson(4.0, size=(60, 30)).astype(np.float32)
    X[:, 0] += 1
    X[0, :] += 1
    ad = _lazy(X)
    m = _derivable_row_scale(ad.X, ad.raw.X)
    want = j_derivable_row_scale(ad.X.copy(), ad.raw.X.copy())
    assert m is not None and m.dtype == np.float32
    np.testing.assert_array_equal(m, want)
    other = ad.raw.X.copy()
    other.data = other.data * 2.0 + 1.0
    ones = sp.csr_matrix(np.ones((60, 30), np.float32))
    for a, b in ((ad.X, ones), (other, ad.raw.X), (ad.X, ad.X), (ad.X.toarray(), ad.raw.X)):
        assert _derivable_row_scale(a, b) is None
        assert j_derivable_row_scale(a, b) is None


def test_resident_part_equals_jax():
    """The raw target and the size factors equal the JAX package's part
    exactly (and scipy's rows); the derived input is the port's
    (log1p(t * m) - mu) / sd, within one ulp of log1p (through 1/sd) of the
    JAX package's, whose log1p is XLA's."""
    rs = np.random.RandomState(40)
    X = make_counts(80, 12, seed=40)
    X[X < 2] = 0
    X[:, 0] += 1
    X[5] = 0  # an empty row
    X[7, :] = 1.0  # the widest row: K = G
    Xs = sp.csr_matrix(X)
    m = rs.uniform(0.5, 2.0, 80).astype(np.float32)
    sf = rs.uniform(0.5, 2.0, 80).astype(np.float32)
    mu = rs.normal(size=12).astype(np.float32)
    sd = rs.uniform(0.5, 2.0, 12).astype(np.float32)
    rows = np.concatenate([[5, 7, 79], rs.permutation(80)[:30]])
    r = ResidentCSR(Xs, m, sf, mu, sd, "cpu")
    assert r.uint16 and r.K == 12
    x, t, s = r.part(rows)
    jx, jt, js = (np.asarray(a) for a in JResidentCSR(Xs, m, sf, mu, sd).part(rows))
    np.testing.assert_array_equal(t.numpy(), jt)
    np.testing.assert_array_equal(t.numpy(), X[rows])
    np.testing.assert_array_equal(s.numpy(), js)
    l1p = np.log1p(X[rows] * m[rows, None])
    np.testing.assert_array_less(np.abs(x.numpy() - jx),
                                 np.spacing(np.abs(l1p)) / sd * 1.01 + np.spacing(np.abs(jx)) * 2)
    # into kept buffers, as the trainer stages
    xo, to, so = torch.zeros(40 * 12 + 1), torch.zeros(40 * 12 + 1), torch.zeros(40)
    x2, t2, s2 = r.part(rows, xo, to, so)
    assert x2.data_ptr() == xo.data_ptr() and t2.data_ptr() == to.data_ptr()
    assert torch.equal(x2, x) and torch.equal(t2, t) and torch.equal(s2, s)
    assert ResidentCSR.payload_bytes(Xs) == Xs.nnz * 4 + 80 * 24


@pytest.mark.parametrize("budget", [1, 12 * 7 * 24, 12 * 40 * 24])
def test_a_resident_part_in_row_blocks_is_the_whole_parts(budget):
    """Gathered in blocks of rows whose padded slots fit ``part_bytes``
    (one row at least), a part is the part gathered whole, bit for bit."""
    from dca_tpu_torch.ops.resident import PART_BYTES_PER_SLOT

    rs = np.random.RandomState(42)
    X = make_counts(80, 12, seed=42)
    X[X < 2] = 0
    X[5] = 0
    X[7, :] = 1.0  # K = G
    Xs = sp.csr_matrix(X)
    args = (rs.uniform(0.5, 2.0, 80), rs.uniform(0.5, 2.0, 80), rs.normal(size=12),
            rs.uniform(0.5, 2.0, 12), "cpu")
    whole = ResidentCSR(Xs, *args)
    r = ResidentCSR(Xs, *args, part_bytes=budget)
    assert whole.block_rows is None
    assert r.block_rows == max(budget // (12 * PART_BYTES_PER_SLOT), 1)
    rows = np.concatenate([[5, 7, 79], rs.permutation(80)[:30]])
    for a, b in zip(r.part(rows), whole.part(rows)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(r.part(rows)[1].numpy(), X[rows])


def test_resident_float_values_keep_float32():
    X = make_counts(30, 10, seed=41) * 0.5
    r = ResidentCSR(sp.csr_matrix(X), np.ones(30), np.ones(30), np.zeros(10), np.ones(10), "cpu")
    assert not r.uint16
    np.testing.assert_array_equal(r.part(np.arange(30))[1].numpy(), X)


# ---------------------------------------------------------------------------
# the block forward's payload branch, and the switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ae_type", ["nb-conddisp", "zinb-conddisp"])
def test_forward_payload_branch_equals_host_and_jax(monkeypatch, ae_type):
    """A CSR count with the device densify on: the port's forward the same
    bits as its host-densify forward, and the JAX package's payload forward
    within the dense blocks' 1e-5 on bridged weights."""
    from dca_tpu.models import AE_types as JAE
    from dca_tpu_torch.bridge import params_from_jax
    from dca_tpu_torch.models.network import AE_types

    rs = np.random.RandomState(13)
    X = (rs.uniform(size=(70, 24)) < 0.3).astype(np.float32) * \
        rs.poisson(3.0, size=(70, 24)).astype(np.float32)
    Xs = sp.csr_matrix(X)
    mean = X.mean(0).astype(np.float32)
    std = (X.std(0) + 1.0).astype(np.float32)
    sf = rs.uniform(0.5, 2.0, size=70).astype(np.float32)
    jnet = JAE[ae_type](input_size=24, hidden_size=(8, 4, 8), seed=2).build()
    net = AE_types[ae_type](input_size=24, hidden_size=(8, 4, 8), device="cpu").build()
    net.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jnet.params),
        jax.tree_util.tree_map(np.asarray, jnet.state)))
    monkeypatch.setenv("DCA_TPU_DEVICE_DENSIFY", "0")
    ref = net.forward(Xs, sf, scale_mean=mean, scale_std=std, chunk_rows=32)
    monkeypatch.setenv("DCA_TPU_DEVICE_DENSIFY", "1")
    got = net.forward(Xs, sf, scale_mean=mean, scale_std=std, chunk_rows=32)
    want = jnet.forward(Xs, sf, scale_mean=mean, scale_std=std, chunk_rows=32)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None
            continue
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mode,cpu,cuda", [("0", False, False), ("1", True, True),
                                           ("auto", False, True), (None, False, True)])
def test_use_device_densify(monkeypatch, mode, cpu, cuda):
    if mode is None:
        monkeypatch.delenv("DCA_TPU_DEVICE_DENSIFY", raising=False)
    else:
        monkeypatch.setenv("DCA_TPU_DEVICE_DENSIFY", mode)
    assert config.use_device_densify(torch.device("cpu")) is cpu
    assert config.use_device_densify("cuda") is cuda
