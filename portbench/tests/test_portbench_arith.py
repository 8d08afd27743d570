"""The yardstick's counts against values worked by hand at the training
step's (32, 3451)."""

import pytest

from harness import arith

G = 3451
N = 32 * G  # 110,432 elements


def test_model_flops_per_row():
    # trunk 3451-64-32-64, two heads (NB) or three (ZINB) of 64 x 3451
    assert arith.forward_flops_per_row(G, [64, 32, 64], 2) == 2 * (220864 + 2048 + 2048
                                                                   + 2 * 220864)
    assert arith.train_flops_per_row(G, [64, 32, 64], 2) == 3_558_400
    assert arith.forward_flops_per_row(G, [64, 32, 64], 3) == 1_775_104
    assert arith.train_flops_per_row(G, [64, 32, 64], 3) == 4_883_584


@pytest.mark.parametrize("with_pi, k1, k2", [(False, 1_325_200, 2_208_648),
                                             (True, 1_766_928, 3_092_104)])
def test_loss_kernel_bytes(with_pi, k1, k2):
    assert arith.k1_bytes(32, G, with_pi) == k1  # 3 or 4 inputs, 4 floats out
    assert arith.k2_bytes(32, G, with_pi) == k2  # + g and denom, 2 or 3 outputs
    assert arith.k1_bound_ms(32, G, with_pi) == pytest.approx(k1 / 3.35e12 * 1e3)
    assert arith.k2_bound_ms(32, G, with_pi) == pytest.approx(k2 / 3.35e12 * 1e3)


@pytest.mark.parametrize("rows", [25, 32, 273, 26215])
@pytest.mark.parametrize("with_pi", [False, True])
def test_bytes_bound_the_loss_kernels_whatever_the_data(rows, with_pi):
    """Every element at its most recurrence steps still leaves the
    operations' time under the bytes', so the bound needs no data."""
    n = rows * G
    worst_k1 = arith.k1_ops(rows, G, with_pi, 3 * arith.MAX_PUSHES * n)
    worst_k2 = arith.k2_ops(rows, G, with_pi, 2 * arith.MAX_PUSHES * n)
    assert arith.bound_ms(arith.k1_bytes(rows, G, with_pi), worst_k1)[1] == "bytes"
    assert arith.bound_ms(arith.k2_bytes(rows, G, with_pi), worst_k2)[1] == "bytes"
    assert arith.k1_ops(32, G, False, 0) == N * 93
    assert arith.k2_ops(32, G, True, 0) == N * 113
