"""``optim_gb_per_s`` on hand-built traces: the leaves it counts from each
configuration's widths (the elements of nb-conddisp's 13 parameters and
zinb-conddisp's 15 at 3451 genes), its rate from the kernel's launches,
and None where no launch of the kernel is in the slice."""

import types

import pytest

from harness.manifest import load_manifest, reader, resolve
from harness.trace import Trace

G = 3451


def _config(workload):
    return resolve(load_manifest(), workload).config


def _ctx(trace, workload):
    return types.SimpleNamespace(trace=trace, fit={}, schedule={}, config=_config(workload),
                                 traffic={}, genes=G)


def _trace(durations, other=("nll_bwd_kernel", 5e-6)):
    device, t = [], 0.0
    for dur in durations:
        device += [(other[0], t, other[1], "kernel"),
                   ("void (anonymous namespace)::rmsprop_kernel(Table, Hyper)", t + 1e-5, dur,
                    "kernel")]
        t += 1e-4
    return Trace(0.0, 1.0, device, [])


@pytest.mark.parametrize("workload, n_leaves, elements", [
    ("nb-conddisp.paul15", 13, 673_910),
    ("zinb-conddisp.paul15", 15, 898_225),
])
def test_optim_gb_per_s_counts_the_leaves_and_reads_the_launches(workload, n_leaves, elements):
    read = reader("optim_gb_per_s")
    sizes = read.__globals__["leaves"](_config(workload), G)
    assert (len(sizes), sum(sizes)) == (n_leaves, elements)
    at = 20 * elements / 4e12  # seconds a launch at 4,000 GB/s
    # three launches at twice, once and four times that: 3 / 7 of the rate
    got = read(_ctx(_trace([2 * at, at, 4 * at]), workload))
    assert got == pytest.approx(4000.0 * 3 / 7)


@pytest.mark.parametrize("workload", ["nb-conddisp.paul15", "zinb-conddisp.paul15"])
def test_optim_gb_per_s_without_the_kernel_is_none(workload):
    read = reader("optim_gb_per_s")
    assert read(_ctx(None, workload)) is None  # an untraced run
    parent = Trace(0.0, 1.0, [("nll_bwd_kernel", 0.1, 5e-6, "kernel")], [])
    assert read(_ctx(parent, workload)) is None  # a program without K5
