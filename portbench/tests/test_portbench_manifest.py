"""The manifest resolves every cell to its files by name, obeys the
benchmark contract's shape, and takes a new cell, configuration, mix and
metric as new files and entries alone."""

import json
import os
import re
import shutil

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _cells():
    return [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("workload", _cells())
def test_every_cell_resolves_to_its_files(workload):
    cell = manifest.resolve(manifest.load_manifest(), workload)
    assert cell.config["name"] == cell.name.split(".")[0]
    assert cell.traffic["name"] == cell.name.split(".", 1)[1]
    assert {"setup_s", "train_cells_per_s"} <= {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))
    assert set(cell.limits) == {"loss_gap", "state_gap", "leaf_gap"}


def test_manifest_keeps_the_contract():
    m = manifest.load_manifest()
    assert set(m) == KEYS["top"]
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[section]]
        assert len(names) == len(set(names))
        for e in m[section]:
            assert set(e) - {"workloads"} == KEYS[section], e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and section in ("configs", "workloads", "per_layer"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= e["bound"] <= 0.25 for e in e2e.values())
    for e in m["per_layer"]:
        assert e["moves"] in e2e
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    assert len(pairs) == len(m["workloads"])
    assert all(w["chips"] == 1 for w in m["workloads"])


def test_a_new_cell_is_new_files_and_entries(tmp_path, monkeypatch):
    """A cell, a configuration, a mix and a metric that exist only in a
    temporary copy of the manifest and of the benchmark's folder; and a
    cell of sparse traffic whose fit ``train()``'s gate streams (its
    documented DCA_TPU_DEVICE_BYTES lowered, here alone), which runs to a
    correct end through the streaming trainer."""
    bench = tmp_path / "portbench"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest.load_manifest()
    cfg = json.loads((bench / "configs" / "zinb-conddisp.json").read_text())
    cfg["name"] = "zinb-wide"
    (bench / "configs" / "zinb-wide.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "paul15.json").read_text())
    mix.update(name="tutorial", n_cells=2000, n_genes=200)
    (bench / "traffic" / "tutorial.json").write_text(json.dumps(mix))
    (bench / "limits" / "zinb-wide.tutorial.json").write_text(
        (bench / "limits" / "zinb-conddisp.paul15.json").read_text())
    (bench / "metrics" / "epochs_run.py").write_text(
        "def read(ctx):\n    return ctx.fit['epochs']\n")
    m["configs"].append({"name": "zinb-wide", "source": "https://example.org",
                         "file": "portbench/configs/zinb-wide.json", "reduced": [],
                         "why": "new"})
    m["workloads"].append({"name": "zinb-wide.tutorial", "config": "zinb-wide",
                           "traffic": "tutorial", "chips": 1, "why": "new"})
    m["per_layer"].append({"name": "epochs_run", "unit": "count", "better": "higher",
                           "source": "program_counter", "layer": "device",
                           "moves": "train_cells_per_s", "workloads": ["zinb-wide.tutorial"]})
    rate = next(e for e in m["end_to_end"] if e["name"] == "train_cells_per_s")
    rate["workloads"].append("zinb-wide.tutorial")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    loaded = manifest.load_manifest(str(tmp_path / "BENCHMARK.json"))
    cell = manifest.resolve(loaded, "zinb-wide.tutorial", bench_dir=str(bench))
    assert cell.config["name"] == "zinb-wide" and cell.traffic["n_genes"] == 200
    assert [x["name"] for x in cell.end_to_end] == ["setup_s", "train_cells_per_s"]
    assert [x["name"] for x in cell.per_layer][-1] == "epochs_run"
    read = manifest.reader("epochs_run", bench_dir=str(bench))
    assert read(type("Ctx", (), {"fit": {"epochs": 7}})) == 7
    with pytest.raises(KeyError):
        manifest.resolve(manifest.load_manifest(), "zinb-wide.tutorial")
    assert not os.path.exists(os.path.join(manifest.BENCH_DIR, "traffic", "tutorial.json"))

    import torch

    import run
    from dca_tpu_torch.train import loop

    mix.update(name="corpus_tiny", generator="nb_csr", n_cells=600, n_genes=80,
               mean_scale=0.3, state_fits=1)
    del mix["cpu_test"]
    (bench / "traffic" / "corpus_tiny.json").write_text(json.dumps(mix))
    (bench / "limits" / "nb-conddisp.corpus_tiny.json").write_text(
        (bench / "limits" / "nb-conddisp.paul15.json").read_text())
    m["workloads"].append({"name": "nb-conddisp.corpus_tiny", "config": "nb-conddisp",
                           "traffic": "corpus_tiny", "chips": 1, "why": "new"})
    rate["workloads"].append("nb-conddisp.corpus_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.resolve(manifest.load_manifest(str(tmp_path / "BENCHMARK.json")),
                            "nb-conddisp.corpus_tiny", bench_dir=str(bench))
    assert cell.per_layer == []  # every metric names the cells it reads
    streamed = []
    real = loop._train_streaming
    monkeypatch.setattr(loop, "_train_streaming",
                        lambda *a, **k: streamed.append(1) or real(*a, **k))
    monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", "100000")
    result = run.run_cell(cell, 2**31 + 23, 0.5, 0, torch.device("cpu"))
    assert result["correct"] is True, result["check"]
    assert set(result["metrics"]) == {"setup_s", "train_cells_per_s"}
    assert len(streamed) == 2 + mix["state_fits"]  # warm-up, state fits, window
    traced = run.run_cell(cell, 2**31 + 29, 0.5, 1, torch.device("cpu"))
    assert traced["correct"] is True, traced["check"]
    assert traced["fit"]["trainer"] == "streaming"  # as the program's record shows
