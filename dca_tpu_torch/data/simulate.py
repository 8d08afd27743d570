"""Splatter-style count simulation with ground truth.

The port's copy of the JAX package's ``dca_tpu/data/simulate.py``, which
the port may not import (its package ``__init__`` imports JAX): numpy only,
the same draws in the same order, so a seed gives the same arrays bit for
bit in both packages.  It mirrors the reference's evaluation data generator
(``scripts/simulate.R``): group-structured NB counts with a logistic
mean-dependent dropout layer, returning the noisy counts, the true
(pre-dropout) counts, the dropout mask and the cell/gene annotations.

The reference sweeps dropout.mid in {0, 1, 3, 5} and groups in {1, 2, 3, 6}
at 200 genes x 2000 cells, seed 42; ``simulation_grid()`` gives that grid.
The dropout model follows splatter's: the keep probability of a count with
underlying mean mu is 1 - logistic(k (x0 - ln mu)) with shape k and
midpoint x0 (= dropout.mid); higher midpoints drop more low-expression
genes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Simulation:
    counts: np.ndarray        # (cells, genes) observed (zero-inflated) counts
    true_counts: np.ndarray   # (cells, genes) pre-dropout NB counts
    dropout_mask: np.ndarray  # (cells, genes) bool, True where a count was dropped
    groups: np.ndarray        # (cells,) int group id
    de_factors: np.ndarray    # (groups, genes) per-group DE multipliers
    size_factors: np.ndarray  # (cells,) simulated library-size factors


def simulate_counts(
    n_cells: int = 2000,
    n_genes: int = 200,
    n_groups: int = 2,
    dropout_mid: float = 3.0,
    dropout_shape: float = -1.0,
    de_prob: float = 0.1,
    de_strength: float = 1.5,
    theta: float = 2.0,
    mean_scale: float = 3.0,
    seed: int = 42,
    ensure_nonzero: bool = True,
) -> Simulation:
    """Simulate group-structured ZINB counts with known ground truth.

    dropout_mid/dropout_shape parameterize splatter's logistic dropout:
    P(drop | mu) = 1 / (1 + exp(-shape * (ln mu - mid))) with shape < 0, so
    low-mean genes drop out more (scripts/simulate.R:47,57 `dropout.mid`).
    """
    rs = np.random.RandomState(seed)

    base = rs.gamma(2.0, 1.0, size=(1, n_genes))  # gene mean profile
    # per-group log-normal DE factors on a random de_prob subset of genes
    de = np.ones((n_groups, n_genes))
    if n_groups > 1:
        for g in range(n_groups):
            de_genes = rs.uniform(size=n_genes) < de_prob
            fac = rs.lognormal(np.log(de_strength), 0.4, size=n_genes)
            down = rs.uniform(size=n_genes) < 0.5
            fac = np.where(down, 1.0 / fac, fac)
            de[g] = np.where(de_genes, fac, 1.0)

    sizes = np.full(n_groups, n_cells // n_groups)
    sizes[: n_cells - sizes.sum()] += 1
    groups = np.repeat(np.arange(n_groups), sizes)

    size_factors = rs.lognormal(0.0, 0.35, size=(n_cells,))
    mu = base * de[groups] * size_factors[:, None] * mean_scale

    true_counts = rs.negative_binomial(theta, theta / (theta + mu)).astype(np.float32)

    # splatter logistic dropout on the underlying log-mean; the reference
    # grid passes dropout.present=(dropout != 0) (scripts/simulate.R:56-57),
    # so dropout_mid == 0 means NO dropout layer at all, not a logistic
    # curve centered at 0
    if dropout_mid == 0.0:
        dropout_mask = np.zeros(true_counts.shape, dtype=bool)
    else:
        logit = dropout_shape * (np.log(mu + 1e-10) - dropout_mid)
        p_drop = 1.0 / (1.0 + np.exp(-logit))
        dropout_mask = rs.uniform(size=true_counts.shape) < p_drop
    counts = np.where(dropout_mask, 0.0, true_counts).astype(np.float32)

    if ensure_nonzero:
        # keep every gene/cell trainable (the reference filters these out;
        # keeping index alignment is simpler for fixtures); clear the mask at
        # resurrected entries so mask and counts stay consistent
        zero_g = counts.sum(0) == 0
        counts[0, zero_g] = np.maximum(true_counts[0, zero_g], 1.0)
        dropout_mask[0, zero_g] = False
        zero_c = counts.sum(1) == 0
        counts[zero_c, 0] = np.maximum(true_counts[zero_c, 0], 1.0)
        dropout_mask[zero_c, 0] = False

    return Simulation(
        counts=counts,
        true_counts=true_counts,
        dropout_mask=dropout_mask,
        groups=groups,
        de_factors=de,
        size_factors=size_factors,
    )


def simulation_grid(
    n_cells: int = 2000, n_genes: int = 200, seed: int = 42
) -> Iterator[Tuple[str, Simulation]]:
    """The reference evaluation grid (scripts/simulate.R:39-52):
    dropout.mid ∈ {0, 1, 3, 5} × groups ∈ {1, 2, 3, 6} × swap ∈ {F, T},
    where swap exchanges the cell/gene counts (the 200-cell × 2000-gene
    regime stressing genes ≫ cells)."""
    for mid in (0.0, 1.0, 3.0, 5.0):
        for groups in (1, 2, 3, 6):
            for swap in (False, True):
                nc, ng = (n_genes, n_cells) if swap else (n_cells, n_genes)
                name = f"sim-drop{int(mid)}-group{groups}" + (
                    "-swap" if swap else ""
                )
                yield name, simulate_counts(
                    n_cells=nc,
                    n_genes=ng,
                    n_groups=groups,
                    dropout_mid=mid,
                    seed=seed,
                )


def to_anndata(sim: Simulation):
    """Wrap a Simulation as an AnnData (obs carries 'group')."""
    import pandas as pd

    from .adata import AnnData

    n_cells, n_genes = sim.counts.shape
    obs = pd.DataFrame(
        {"group": [f"Group{g + 1}" for g in sim.groups]},
        index=pd.Index([f"cell{i}" for i in range(n_cells)]),
    )
    var = pd.DataFrame(index=pd.Index([f"gene{i}" for i in range(n_genes)]))
    return AnnData(sim.counts.copy(), obs, var)
