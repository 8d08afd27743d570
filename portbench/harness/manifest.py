"""``BENCHMARK.json`` and the files a cell names: the harness finds each
configuration, traffic mix, limit file and per-layer metric reader by name,
so a new cell, configuration, mix or metric is new files and entries
alone.

* ``portbench/configs/<config>.json``: the model and its training settings;
* ``portbench/traffic/<traffic>.json``: a generator's name and parameters;
* ``portbench/harness/generators/<generator>.py``: ``make(traffic, seed)``,
  the counts of a mix (``harness/traffic.py``);
* ``portbench/limits/<cell>.json``: the limit of each number the check
  compares, with the readings it was set from;
* ``portbench/metrics/<metric>.py``: a reader, ``read(ctx)``, that gives
  the metric's value or None.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's entries of the metrics this cell reports
    per_layer: list


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_manifest(path=None):
    return _load_json(path or os.path.join(ROOT, "BENCHMARK.json"))


def _reports(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def resolve(manifest, workload, bench_dir=BENCH_DIR):
    """The ``Cell`` of ``workload``: its entry, configuration, traffic mix,
    limits, and the metrics it reports.  Raises KeyError for a name the
    manifest does not hold and OSError for a file that is not there."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in the manifest; it has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _load_json(os.path.join(os.path.dirname(bench_dir), configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", workload + ".json"))
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)])


def load_module(path, name):
    """The module of the Python file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name, bench_dir=BENCH_DIR):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = os.path.join(bench_dir, "metrics", metric_name + ".py")
    module = "portbench_metric_" + metric_name.replace(".", "_").replace("-", "_")
    return load_module(path, module).read
