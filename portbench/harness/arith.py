"""The yardstick's arithmetic: published peaks, the loss kernels' bytes and
operations, and the model's matrix-product FLOPs per row.

Frozen copies.  The peaks, ``bound_ms`` and the operation counts of K1 and
K2 are ``chip_smoke.py:390-391`` (``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``),
``chip_smoke.py:488`` (``_bound_ms``), ``chip_smoke.py:459`` (``_k1_ops``) and
``chip_smoke.py:472`` (``_k2_ops``); the byte counts are those of
``chip_smoke.py:1117-1118``.  They are counted from the kernels' sources
(``dca_tpu_torch/csrc/fused_nll.cu``): each input read once, each output
written once, a transcendental one operation.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; the port runs TF32 off

# recurrence steps a Stirling lgamma / digamma takes at most (z < 8 tests)
MAX_PUSHES = 8


def bound_ms(n_bytes, n_ops):
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over the float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _inputs(with_pi):
    return 4 if with_pi else 3  # y, mu, theta and pi, each (B, G)


def k1_bytes(rows, genes, with_pi):
    """K1 reads y, mu, theta (and pi) once and writes its 4 floats: sum,
    count, loss and denominator."""
    return _inputs(with_pi) * 4 * rows * genes + 4 * 4


def k2_bytes(rows, genes, with_pi):
    """K2 reads y, mu, theta (and pi), the incoming gradient and K1's
    denominator, and writes a (B, G) gradient for each of mu, theta (and
    pi)."""
    n = rows * genes
    return _inputs(with_pi) * 4 * n + 2 * 4 + (_inputs(with_pi) - 1) * 4 * n


def k1_ops(rows, genes, with_pi, pushes):
    """K1's operations: 22 + 3 k per log Gamma (k recurrence steps), 27
    around the three, 25 more for the ZINB terms; ``pushes`` is the sum of
    k over the elements' three log Gammas."""
    return float(rows * genes * (27 + 3 * 22 + (25 if with_pi else 0)) + 3 * pushes)


def k2_ops(rows, genes, with_pi, pushes):
    """K2's operations: 21 + 3 k per digamma, 28 around the two, 43 more for
    the ZINB terms; ``pushes`` is the sum of k over the two digammas."""
    return float(rows * genes * (28 + 2 * 21 + (43 if with_pi else 0)) + 3 * pushes)


def k1_bound_ms(rows, genes, with_pi):
    """K1's bound at (rows, genes).  The recurrence steps depend on the
    data; with every element at its most (3 * MAX_PUSHES) the operations
    still take less time than the bytes (tested), so the bound is the
    bytes' whatever the data."""
    ops = k1_ops(rows, genes, with_pi, 0)
    return bound_ms(k1_bytes(rows, genes, with_pi), ops)[0]


def k2_bound_ms(rows, genes, with_pi):
    """K2's bound at (rows, genes); as ``k1_bound_ms``, bound by bytes."""
    ops = k2_ops(rows, genes, with_pi, 0)
    return bound_ms(k2_bytes(rows, genes, with_pi), ops)[0]


def dense_widths(genes, hidden, n_heads):
    """(in, out) of every dense layer: the trunk, then ``n_heads`` heads of
    ``genes`` outputs each on the trunk's last hidden layer."""
    widths = []
    prev = genes
    for h in hidden:
        widths.append((prev, h))
        prev = h
    widths += [(prev, genes)] * n_heads
    return widths


def forward_flops_per_row(genes, hidden, n_heads):
    """Matrix-product FLOPs of one row's forward: 2 per multiply-add."""
    return 2.0 * sum(i * o for i, o in dense_widths(genes, hidden, n_heads))


def train_flops_per_row(genes, hidden, n_heads):
    """One row of a training step: the forward, the weights' gradients (as
    many FLOPs again) and the inputs' gradients of every layer but the
    first (the count matrix needs none).  No recomputation is counted."""
    fwd = forward_flops_per_row(genes, hidden, n_heads)
    first_in, first_out = dense_widths(genes, hidden, n_heads)[0]
    return 3.0 * fwd - 2.0 * first_in * first_out
