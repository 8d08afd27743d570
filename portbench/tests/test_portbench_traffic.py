"""The generators of the traffic mixes, found by name: ``nb_dense`` is the
generator the cells were measured with, bit for bit, and ``nb_csr`` draws
its law sparse without ever holding the dense matrix."""

import tracemalloc

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from harness import traffic
from harness.manifest import load_manifest, resolve

SEED = 2**31 - 3


def _frozen_nb_dense(t, seed):
    """``harness/traffic.py::_nb_dense`` as the cells were measured with it."""
    rs = np.random.RandomState(seed)
    n_cells, n_genes = t["n_cells"], t["n_genes"]
    base = rs.gamma(t["gene_gamma_shape"], 1.0, size=(1, n_genes))
    depth = rs.lognormal(0.0, t["depth_sigma"], size=(n_cells, 1))
    mu = base * depth * t["mean_scale"]
    size = t["nb_size"]
    counts = rs.negative_binomial(size, size / (size + mu)).astype(np.float32)
    counts[:, counts.sum(0) == 0] += 1.0
    counts[counts.sum(1) == 0, 0] += 1.0
    return counts


def _paul15(**sizes):
    mix = resolve(load_manifest(), "nb-conddisp.paul15").traffic
    mix.update(sizes)
    return mix


@pytest.mark.parametrize("sizes", [{}, {"n_cells": 400, "n_genes": 120},
                                   {"n_cells": 2000, "n_genes": 200, "mean_scale": 0.05}])
def test_nb_dense_is_the_generator_the_cells_were_measured_with(sizes):
    mix = _paul15(**sizes)
    got = traffic.make_counts(mix, SEED)
    want = _frozen_nb_dense(mix, SEED)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_an_unknown_generator_is_refused():
    for name in ("nb_nothing", "../run", ""):
        with pytest.raises(ValueError):
            traffic.make_counts(dict(_paul15(), generator=name), 1)


def test_nb_csr_draws_the_law_of_nb_dense():
    """Per gene, the mean and the share of zeros of the two generators on
    one seed (the same gene rates and cell depths) agree within sampling
    error: 5 standard errors, over 40 genes.  A gene that drew no count on
    one side is repaired there to 1 in every cell (no zeros): such genes
    are left out, as the repair is no draw of the law."""
    n = 4000
    mix = _paul15(n_cells=n, n_genes=40)
    dense = traffic.make_counts(mix, 11)
    csr = traffic.make_counts(dict(mix, generator="nb_csr"), 11)
    assert sp.isspmatrix_csr(csr) and csr.dtype == np.float32 and csr.shape == dense.shape
    assert csr.has_sorted_indices and (csr.data > 0).all()
    assert np.array_equal(csr.data, np.round(csr.data))
    other = csr.toarray()
    assert (other.sum(0) > 0).all() and (other.sum(1) > 0).all()
    drawn = ((dense == 0).any(0)) & ((other == 0).any(0))
    assert drawn.sum() >= 30
    dense, other = dense[:, drawn], other[:, drawn]
    for a, b in ((dense, other), ((dense == 0).astype(float), (other == 0).astype(float))):
        ma, mb = a.mean(0), b.mean(0)
        se = np.sqrt(a.var(0, ddof=1) / n + b.var(0, ddof=1) / n) + 1e-12
        assert (np.abs(ma - mb) / se).max() < 5.0, (ma, mb)


def test_nb_csr_is_the_same_matrix_from_the_same_seed():
    mix = dict(_paul15(n_cells=300, n_genes=50), generator="nb_csr")
    a, b = traffic.make_counts(mix, 5), traffic.make_counts(mix, 5)
    c = traffic.make_counts(mix, 6)
    assert (a != b).nnz == 0 and (a != c).nnz > 0


def test_nb_csr_never_holds_the_dense_matrix(monkeypatch):
    """It draws by blocks of cells: no draw and no host array as large as
    the cells x genes matrix."""
    gen = traffic.generator("nb_csr")
    monkeypatch.setattr(gen, "BLOCK_ELEMENTS", 20_000)
    n_cells, n_genes = 3000, 100
    drawn = []
    real = torch.poisson

    def poisson(rates, *a, **k):
        drawn.append(rates.numel())
        return real(rates, *a, **k)

    monkeypatch.setattr(torch, "poisson", poisson)
    mix = dict(_paul15(n_cells=n_cells, n_genes=n_genes, mean_scale=0.05), generator="nb_csr")
    tracemalloc.start()
    try:
        x = gen.make(mix, 3)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    dense_bytes = n_cells * n_genes * 4
    assert len(drawn) == -(-n_cells // (20_000 // n_genes))
    assert max(drawn) <= 20_000 and sum(drawn) == n_cells * n_genes
    assert peak < dense_bytes / 2, (peak, dense_bytes)
    assert x.nnz < n_cells * n_genes / 4
