"""Checkpoints of the whole training state, in the JAX package's files.

The port of ``dca_tpu/train/checkpoint.py``: ``TrainCheckpoint`` saves the
parameters, the BN statistics, the optimizer state, the learning rate and
the callbacks' counters every ``checkpoint_every`` epochs, and
``train(resume=True)`` restores the latest, so a fit survives a crash.

Files, as the JAX package writes them, under ``<output_dir>/checkpoints``:

  * ``ckpt_<epoch>.json``: step, lr, seed and the callback state, written
    first, then
  * ``ckpt_<epoch>.npz``: one array a tensor, keyed by its pytree path
    (``params/heads/mean/kernel``, ``params/trunk/enc0/bn_beta``,
    ``state/trunk/enc0/moving_mean``, ``opt_state/a/heads/mean/kernel``,
    ``opt_state/t`` for a step count, int32),

each through a temporary file and ``os.replace``, so that the npz, whose
presence names the step, appears only once the pair is whole; the last 2
steps are kept, and ``restore`` falls back a step past a torn pair.  Rank
0 alone writes.  So a checkpoint written by either package resumes in the
other.  The port adds its dropout generator's state (``rng/generator``,
uint8), which the JAX package's restore does not read; a checkpoint
without it restores all the same (``OPTIONAL``).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..bridge import flatten_tree, unflatten_tree
from ..parallel.multihost import is_primary

OPTIONAL = ("rng/",)  # path prefixes a checkpoint of the JAX package lacks


def _to_numpy(leaf):
    return leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)


def _like(arr, leaf):
    """``arr`` as the template leaf's kind: a tensor of its dtype on its
    device, or a numpy array of its dtype."""
    if torch.is_tensor(leaf):
        return torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def optimizer_tree(opt_state, names):
    """The JAX package's tree of a port optimizer state: each per-parameter
    list (aligned with ``model.parameters()``, whose state-dict ``names``
    it takes) as the params tree, each lone tensor (a step count) as it
    is."""
    return {key: (value if torch.is_tensor(value) else
                  unflatten_tree(dict(zip(names, value)), "."))
            for key, value in opt_state.items()}


class TrainCheckpoint:
    """Checkpoint of the full training state (trees of tensors or numpy
    arrays)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def save(
        self,
        step: int,
        params,
        state,
        opt_state,
        *,
        lr: float,
        callback_state: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
        extra: Optional[Dict[str, Any]] = None,
    ):
        """Write step ``step``; ``extra``: more {path: array} entries of the
        npz."""
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        if not is_primary():
            return path  # rank 0 owns the files
        flat = {k: _to_numpy(v) for k, v in flatten_tree(
            {"params": params, "state": state, "opt_state": opt_state}).items()}
        flat.update({k: _to_numpy(v) for k, v in (extra or {}).items()})
        meta = {
            "step": step,
            "lr": lr,
            "seed": seed,
            "callback_state": callback_state or {},
        }
        # the json sidecar first, then the npz whose presence names the
        # step: a crash between the two leaves no discoverable half
        jpath = os.path.join(self.directory, f"ckpt_{step}.json")
        jtmp = jpath + ".tmp"
        with open(jtmp, "w") as f:
            json.dump(meta, f)
        os.replace(jtmp, jpath)
        tmp = path + ".tmp.npz"
        np.savez(tmp, **flat)
        os.replace(tmp, path)
        self._gc(keep=2)
        return path

    def _steps(self):
        steps = []
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                try:
                    steps.append(int(f[len("ckpt_"):-len(".npz")]))
                except ValueError:
                    pass
        return sorted(steps)

    def _gc(self, keep=2):
        for s in self._steps()[:-keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory, f"ckpt_{s}{ext}"))
                except OSError:
                    pass

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, template_tree, step: Optional[int] = None):
        """The arrays of the latest step (or of ``step``) for every leaf of
        ``template_tree`` (a dict of params/state/opt_state trees, and
        optional ``OPTIONAL`` entries), each of its leaf's dtype and device.
        Returns (tree, meta), or (None, None) when no usable checkpoint
        exists.  A step whose npz/json pair is incomplete or corrupt (a
        crash mid-save, a truncated npz) is skipped in favour of the one
        before."""
        candidates = [step] if step is not None else list(reversed(self._steps()))
        for s in candidates:
            try:
                return self._restore_step(template_tree, s)
            except (OSError, KeyError, ValueError, json.JSONDecodeError, zipfile.BadZipFile):
                continue  # a half-written pair: fall back to the previous step
        return None, None

    def _restore_step(self, template_tree, step):
        with np.load(os.path.join(self.directory, f"ckpt_{step}.npz")) as data:
            flat = {}
            for key, leaf in flatten_tree(template_tree).items():
                if key not in data.files and key.startswith(OPTIONAL):
                    continue
                flat[key] = _like(data[key], leaf)
        with open(os.path.join(self.directory, f"ckpt_{step}.json")) as f:
            meta = json.load(f)
        return unflatten_tree(flat), meta
