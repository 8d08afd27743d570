"""A run with the timed path broken underneath comes out not correct: the
look for a chip skipped, the rest of ``run_cell`` on the CPU at each
mix's CPU-test size, with each fault a training cell can have planted in
the program.  (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

import run
from harness.manifest import load_manifest

CPU = torch.device("cpu")


def _cells():
    return [w["name"] for w in load_manifest()["workloads"]]


def _state_unchanged(monkeypatch):
    from dca_tpu_torch.train import loop

    real = loop.get_optimizer

    def frozen(name, clipvalue=None):
        return real(name, clipvalue)._replace(update=lambda *a, **k: None)

    monkeypatch.setattr(loop, "get_optimizer", frozen)


def _half_batch(monkeypatch):
    from dca_tpu_torch.models.network import Autoencoder

    real = Autoencoder.loss_fn

    def half(self, count, size_factors, target, training, *a, **k):
        if training:
            h = max(count.shape[0] // 2, 1)
            count, size_factors, target = count[:h], size_factors[:h], target[:h]
        return real(self, count, size_factors, target, training, *a, **k)

    monkeypatch.setattr(Autoencoder, "loss_fn", half)


def _loss_altered(monkeypatch):
    from dca_tpu_torch.models.network import Autoencoder

    real = Autoencoder.likelihood_loss
    monkeypatch.setattr(Autoencoder, "likelihood_loss",
                        lambda self, *a, **k: real(self, *a, **k) * 1.01)


FAULTS = {"sound": None, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch, "loss_altered": _loss_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", _cells())
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, workload, fault):
    cell = tiny_cell(workload)
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result = run.run_cell(cell, 2**31 + 101, 0.5, 0, CPU)
    assert result["correct"] is (fault == "sound"), result["check"]
