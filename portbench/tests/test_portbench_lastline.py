"""The shape of a run's result line, and a run with no CUDA device: it
fails and prints no result."""

import json

import pytest
import torch

import run

CPU = torch.device("cpu")


def test_result_line_of_an_untraced_run(tiny_cell):
    cell = tiny_cell("nb-conddisp.paul15")
    result = run.run_cell(cell, 11, 0.5, 0, CPU)
    keys = list(result)
    assert keys[:3] == ["correct", "attempted", "failed"] and keys[-1] == "check"
    assert {"metrics", "device"} <= set(keys)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name, m in result["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["check"]) == set(cell.limits)
    for v in result["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(result, allow_nan=False)


def test_result_line_of_a_traced_run(tiny_cell):
    """On the CPU the device trace is not taken: its metrics are left out;
    the fit's and the program record's stay (no graph is replayed there,
    and a fit of half a second is too short a stretch for the thread's CPU
    share)."""
    cell = tiny_cell("zinb-conddisp.paul15")
    result = run.run_cell(cell, 12, 0.5, 1, CPU)
    names = set(result["metrics"])
    assert names == {"mfu", "epoch_host_ms"}
    assert names <= {m["name"] for m in cell.per_layer}
    assert 0 < result["metrics"]["mfu"]["value"] < 100
    assert result["metrics"]["epoch_host_ms"]["value"] > 0
    assert result["fit"]["trainer"] == "in_memory" and "tier" not in result["fit"]
    json.dumps(result, allow_nan=False)


def test_the_check_reads_the_program_at_every_state_it_reached(tiny_cell):
    """The warm-up's state, each further one-epoch fit's and the window's
    last are judged, and the control at the same states is judged by the
    same limits."""
    cell = tiny_cell("nb-conddisp.paul15")
    result = run.run_cell(cell, 2**31 + 5, 0.5, 0, CPU)
    detail = result["check_detail"]
    names = ["warm"] + [f"fit{i + 1}" for i in range(cell.traffic["state_fits"])] + ["final"]
    assert list(detail["state_gaps"]) == names
    assert result["check"]["state_gap"]["value"] == max(detail["state_gaps"].values())
    assert list(detail["control"]["state_gaps"]) == names
    assert detail["control"]["correct"] is (
        detail["control"]["state_gap"] <= cell.limits["state_gap"]["limit"])


def test_no_cuda_device_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", "nb-conddisp.paul15", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA device" in out.err


def test_the_slice_is_cut_at_the_fits_points_of_progress(tiny_cell, monkeypatch):
    """The tracer starts and stops the profiler inside the fit, on its own
    thread, at the program's points of progress; its span is the window
    (the CPU's profiler stands in for the card's)."""
    import torch.profiler as tp

    from harness import cell as C
    from harness import trace as T

    real = tp.profile
    monkeypatch.setattr(tp, "profile", lambda activities=None, **k: real(
        activities=[tp.ProfilerActivity.CPU], **k))
    cell = tiny_cell("nb-conddisp.paul15")
    s = C.setup(cell, 21, CPU)
    tracer = T.SliceTracer(0.2, 0.2)
    hist, wall, epochs = C.timed_fit(s, cell, 1.5, tracer)
    tr = tracer.finish()
    assert tr is not None and 0 < tr.window_s <= wall
    assert tracer.lead_taken_s >= 0.2 and tracer.overhead_s > 0
    assert 0.2 <= tracer.lead_begun_s <= tracer.lead_taken_s
    assert any(name.startswith("aten::") for name, *_ in tr.host)
    assert C.epochs_before(hist.epoch_s, wall - tracer.overhead_s, tracer.lead_taken_s) < epochs


def test_loss_launches_are_labelled_by_the_schedule():
    from harness.trace import Trace, label_loss_launches

    def k(kind):
        name = "nll_fwd_kernel<true, false>" if kind == "1" else "nll_bwd_kernel<true, false>"
        return (name, 0.0, 1e-5, "kernel")

    # a window cut mid-epoch: a stray K2, two steps, the trailing step, the
    # validation chunk, two steps of the next epoch (the last one unknown)
    tr = Trace(0.0, 1.0, [k(c) for c in "2" + "12" * 2 + "12" + "1" + "12" * 2], [])
    got = [(kind, rows) for kind, rows, _ in
           label_loss_launches(tr, {"batch": 32, "rem": 25, "val_chunks": [273]})]
    assert got == [("K1", 32), ("K2", 32), ("K1", 32), ("K2", 32), ("K1", 25), ("K2", 25),
                   ("K1", 273), ("K1", 32), ("K2", 32)]
    # a streamed fit's validation chunks, which the record does not give
    got = [(kind, rows) for kind, rows, _ in
           label_loss_launches(tr, {"batch": 32, "rem": 25, "val_chunks": None})]
    assert got == [("K1", 32), ("K2", 32), ("K1", 32), ("K2", 32), ("K1", 25), ("K2", 25),
                   ("K1", 32), ("K2", 32)]
