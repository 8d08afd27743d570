"""The plain reference against the port on the CPU at a small size, for
both configurations; and the control, the reference in TF32 in the
program's place, against the cells' limits."""

import pytest
import torch

from harness import cell as C
from harness import reference as R
from harness.manifest import load_manifest

CPU = torch.device("cpu")
# the port's plain CPU path and the reference agree to rounding: a bound
# far under every limit the chip's readings set
CPU_AGREEMENT = 1e-5


def _cells():
    return [w["name"] for w in load_manifest()["workloads"]]


def _readings(cell, seed, **kw):
    s = C.setup(cell, seed, CPU)
    prog = C.program_readings(s)
    params, moving = s.after
    layers, heads = C.layer_names(cell.config["hidden_size"]), C.head_names(cell.config)
    inputs, truth = C.reference_epoch(cell, s, CPU)
    if not kw:
        at = R.eval_at(inputs, params, moving, layers, heads, s.n_train)
        return C.compare(cell, s, prog, truth, {"val_state_gap": _rel(prog["val_loss"], at)})[0]
    _, r = C.reference_epoch(cell, s, CPU, inputs=inputs, **kw)
    like = {"loss": r["loss"], "val_loss": r["val_loss"], "params": r["params"]}
    at = R.eval_at(inputs, r["params"], r["moving"], layers, heads, s.n_train)
    return C.compare(cell, s, like, truth, {"val_state_gap": _rel(r["val_loss"], at)})[0]


def _rel(a, b):
    return abs(a - b) / b


@pytest.mark.parametrize("workload", _cells())
def test_reference_follows_the_port(tiny_cell, workload):
    numbers = _readings(tiny_cell(workload), 2**31 + 7)
    assert max(numbers.values()) < CPU_AGREEMENT, numbers


@pytest.mark.parametrize("workload", _cells())
def test_control_in_tf32_fails_the_limits(tiny_cell, workload):
    cell = tiny_cell(workload)
    numbers = _readings(cell, 3, precision="tf32")
    assert not C.judge(numbers, cell.limits), numbers


def test_the_bias_before_batchnorm_is_left_out(tiny_cell):
    """The Dense biases under BatchNorm get no gradient but rounding; the
    rule on the reference's first gradient leaves them out, no name."""
    cell = tiny_cell("nb-conddisp.paul15")
    s = C.setup(cell, 5, CPU)
    inputs, truth = C.reference_epoch(cell, s, CPU)
    g0 = truth["grad0"]
    med = sorted(g0.values())[len(g0) // 2]
    out = {k for k, v in g0.items() if v < 1e-3 * med}
    assert out == {f"trunk.{n}.bias" for n in C.layer_names(cell.config["hidden_size"])}


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, 3.0], dtype=torch.float32)
    assert R._round_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 3.0]
