"""Fixtures of the benchmark's CPU tests: the harness on the import path,
the environment restored after each test, and a cell of the manifest
shrunk to the size its traffic mix names for the CPU ("cpu_test")."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _restore_environ():
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture
def tiny_cell():
    from harness.manifest import load_manifest, resolve

    def make(workload):
        cell = resolve(load_manifest(), workload)
        # the mix's own CPU-test size (its "cpu_test" entry)
        cell.traffic.update(cell.traffic["cpu_test"])
        return cell

    return make
