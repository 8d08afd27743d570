"""nb_dense: dense negative-binomial counts with a per-gene base rate and a
per-cell depth, a frozen copy of ``chip_smoke.py:417``
(``make_paul15_like``, itself the JAX package's ``bench.py`` generator),
its constants read from the traffic file: NB of size ``nb_size`` around a
Gamma(``gene_gamma_shape``) gene rate times a lognormal(0,
``depth_sigma``) cell depth times ``mean_scale``; an all-zero gene gets 1
in every cell, then an all-zero cell 1 in its first gene.  A float32
ndarray, cells x genes."""

from __future__ import annotations

import numpy as np


def make(t, seed):
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
