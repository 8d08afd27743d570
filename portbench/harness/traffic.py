"""The one generator of count matrices: it reads a traffic mix's parameters
(``portbench/traffic/<name>.json``) and makes the cells x genes counts
from a seed.  One layout so far, named by the file's ``generator``:

* ``nb_dense``: dense negative-binomial counts with a per-gene base rate
  and a per-cell depth, a frozen copy of ``chip_smoke.py:417``
  (``make_paul15_like``, itself the JAX package's ``bench.py`` generator),
  its constants read from the file.
"""

from __future__ import annotations

import numpy as np


def make_counts(traffic, seed):
    """The counts of ``traffic`` (a dict) drawn from ``seed`` (< 2**31):
    a float32 ndarray, cells x genes."""
    kind = traffic["generator"]
    if kind == "nb_dense":
        return _nb_dense(traffic, seed)
    raise ValueError(f"unknown generator {kind!r}")


def _nb_dense(t, seed):
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
