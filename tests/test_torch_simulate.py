"""The port's simulator (``dca_tpu_torch/data/simulate.py``) against the JAX
package's ``dca_tpu/data/simulate.py``: the same arrays bit for bit from the
same seed, every case of the reference grid, the same AnnData; and the
ground-truth contract of tests/test_simulate.py on the port."""

import numpy as np
import pytest

from dca_tpu.data import simulate as jsim

import dca_tpu_torch.data as tdata
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.data.simulate import simulate_counts, simulation_grid, to_anndata

FIELDS = ("counts", "true_counts", "dropout_mask", "groups", "de_factors", "size_factors")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kw", [
    {},
    dict(n_cells=300, n_genes=60, n_groups=3, seed=1),
    dict(n_cells=500, n_genes=100, dropout_mid=0.0, seed=3),
    dict(n_cells=400, n_genes=80, dropout_mid=5.0, n_groups=6, seed=11),
    dict(n_cells=50, n_genes=20, n_groups=1, dropout_shape=-2.0, de_prob=0.3,
         de_strength=2.0, theta=0.5, mean_scale=1.0, ensure_nonzero=False, seed=0),
], ids=str)
def test_simulate_counts_same_bits_as_jax(kw):
    _same(simulate_counts(**kw), jsim.simulate_counts(**kw))


def test_simulation_grid_same_bits_as_jax_in_every_case():
    ours = list(simulation_grid())
    theirs = list(jsim.simulation_grid())
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert len(ours) == 32
    for (name, a), (_, b) in zip(ours, theirs):
        _same(a, b)


def test_to_anndata_same_as_jax():
    sim = simulate_counts(n_cells=50, n_genes=20, n_groups=3, seed=4)
    ad, jad = to_anndata(sim), jsim.to_anndata(jsim.simulate_counts(n_cells=50, n_genes=20,
                                                                    n_groups=3, seed=4))
    assert isinstance(ad, AnnData)
    np.testing.assert_array_equal(ad.X, jad.X)
    assert ad.X.dtype == jad.X.dtype
    assert ad.obs.equals(jad.obs) and ad.var.equals(jad.var)
    assert list(ad.obs_names) == list(jad.obs_names)
    assert list(ad.var_names) == list(jad.var_names)


def test_exported_from_the_data_package():
    assert tdata.simulate_counts is simulate_counts
    assert tdata.simulation_grid is simulation_grid
    assert tdata.Simulation is type(simulate_counts(10, 5))


# tests/test_simulate.py's assertions, on the port


def test_shapes_and_ground_truth():
    sim = simulate_counts(n_cells=300, n_genes=60, n_groups=3, seed=1)
    assert sim.counts.shape == (300, 60)
    assert sim.true_counts.shape == (300, 60)
    assert sim.dropout_mask.shape == (300, 60)
    assert set(sim.groups) == {0, 1, 2}
    assert sim.de_factors.shape == (3, 60)
    dropped = sim.dropout_mask & (sim.true_counts > 0)
    assert (sim.counts[dropped] == 0).mean() > 0.99
    assert np.all(sim.counts == np.round(sim.counts))


def test_seed_determinism():
    a = simulate_counts(n_cells=100, n_genes=40, seed=7)
    b = simulate_counts(n_cells=100, n_genes=40, seed=7)
    np.testing.assert_array_equal(a.counts, b.counts)
    c = simulate_counts(n_cells=100, n_genes=40, seed=8)
    assert not np.array_equal(a.counts, c.counts)


def test_dropout_mid_monotonic():
    zeros = [
        (simulate_counts(500, 100, dropout_mid=m, seed=3).counts == 0).mean()
        for m in (0.0, 3.0, 5.0)
    ]
    assert zeros[0] < zeros[1] < zeros[2], zeros


def test_dropout_mid_zero_means_no_dropout():
    sim = simulate_counts(500, 100, dropout_mid=0.0, seed=3)
    assert not sim.dropout_mask.any()
    np.testing.assert_array_equal(sim.counts, sim.true_counts)


def test_ensure_nonzero_keeps_mask_consistent():
    sim = simulate_counts(400, 80, dropout_mid=5.0, seed=11)
    assert (sim.counts[sim.dropout_mask] == 0).all()


def test_grid_matches_reference_sweep():
    grid = dict(simulation_grid(n_cells=20, n_genes=10))
    assert len(grid) == 32
    assert "sim-drop3-group2" in grid
    assert grid["sim-drop3-group2"].counts.shape == (20, 10)
    assert grid["sim-drop3-group2-swap"].counts.shape == (10, 20)


def test_to_anndata():
    sim = simulate_counts(n_cells=50, n_genes=20, n_groups=2, seed=0)
    ad = to_anndata(sim)
    assert ad.X.shape == (50, 20)
    assert "group" in ad.obs.columns
    assert set(ad.obs["group"]) == {"Group1", "Group2"}
