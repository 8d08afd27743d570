"""The count matrices of the traffic mixes: a mix's file
(``portbench/traffic/<name>.json``) names its generator, and
``make_counts`` calls ``make(traffic, seed)`` of
``portbench/harness/generators/<generator>.py`` on it, so a new layout is
a new file.  Those there:

* ``nb_dense``: dense negative-binomial counts (Paul15's shape), a float32
  ndarray;
* ``nb_csr``: the same law drawn sparse, a float32 CSR matrix, for corpora
  whose dense form the host cannot hold.
"""

from __future__ import annotations

import os
import re

from .manifest import load_module

GENERATORS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "generators")


def generator(name):
    """The module of generator ``name``; ValueError where there is none."""
    path = os.path.join(GENERATORS, name + ".py")
    if not re.fullmatch(r"[A-Za-z0-9_]+", name) or not os.path.isfile(path):
        raise ValueError(f"unknown generator {name!r}")
    return load_module(path, "portbench_generator_" + name)


def make_counts(traffic, seed):
    """The counts of ``traffic`` (a dict) drawn from ``seed`` (< 2**31),
    cells x genes."""
    return generator(traffic["generator"]).make(traffic, seed)
