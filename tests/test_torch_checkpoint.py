"""Checkpoint/resume of the port (``dca_tpu_torch/train/checkpoint.py`` and
``train(checkpoint_every=..., resume=...)``) on the CPU.

``TrainCheckpoint`` is held to the JAX package's behaviour (the port of
``tests/test_checkpoint.py``: round trip, the last 2 kept, a torn pair
falling back a step) and to its file format: a checkpoint written by
either package's fit resumes in the other.  There both fits start from the
same checkpoint and draw the same ``np.random.RandomState`` permutations
at dropout 0, so the continued loss and val_loss of the one package must
agree with the other package's own resume at rtol 1e-4, the trajectory
tolerance of ``test_torch_train.py`` (the JAX side runs its fused Pallas
kernels in interpret mode; float rounding in another order grows through
the optimizer's steps).  Within the port a resumed fit is the
uninterrupted fit bit for bit, at dropout 0.1 (the dropout generator's
state is part of the checkpoint), in memory and streamed.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from dca_tpu.data import io as jio
from dca_tpu.data.adata import AnnData as JAnnData
from dca_tpu.models import AE_types as JAE
from dca_tpu.train.checkpoint import TrainCheckpoint as JTrainCheckpoint
from dca_tpu.train.loop import train as jtrain

import dca_tpu_torch
from dca_tpu_torch.data import io
from dca_tpu_torch.data.adata import AnnData
from dca_tpu_torch.models.network import AE_types
from dca_tpu_torch.train.checkpoint import TrainCheckpoint
from dca_tpu_torch.train.loop import train

from conftest import make_counts

torch.set_num_threads(1)  # tier-1 runs several pytest workers at once

HID = (16, 8, 16)


def test_checkpoint_roundtrip(tmp_path):
    ckpt = TrainCheckpoint(str(tmp_path))
    tree = {
        "params": {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 3))}},
        "state": {},
        "opt_state": {"m": torch.zeros(4), "t": torch.tensor(3, dtype=torch.int32)},
    }
    ckpt.save(5, tree["params"], tree["state"], tree["opt_state"], lr=0.01,
              callback_state={"es_wait": 2}, seed=7)
    assert ckpt.latest_step() == 5
    # restore into a template with other values: a restore that echoes the
    # template back fails here
    template = {
        "params": {"a": torch.zeros(4), "b": {"c": torch.zeros((2, 3))}},
        "state": {},
        "opt_state": {"m": torch.full((4,), -1.0), "t": torch.tensor(0, dtype=torch.int32)},
    }
    restored, meta = ckpt.restore(template)
    np.testing.assert_array_equal(restored["params"]["a"].numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(restored["params"]["b"]["c"].numpy(), np.ones((2, 3)))
    np.testing.assert_array_equal(restored["opt_state"]["m"].numpy(), np.zeros(4))
    assert restored["opt_state"]["t"].dtype == torch.int32
    assert int(restored["opt_state"]["t"]) == 3
    assert meta["lr"] == 0.01 and meta["seed"] == 7
    assert meta["callback_state"]["es_wait"] == 2


def test_checkpoint_gc(tmp_path):
    ckpt = TrainCheckpoint(str(tmp_path))
    for s in range(5):
        ckpt.save(s, {"a": torch.zeros(2)}, {}, {}, lr=0.1)
    assert ckpt._steps() == [3, 4]  # keeps the last 2
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.json", "ckpt_3.npz", "ckpt_4.json",
                                            "ckpt_4.npz"]


def test_restore_falls_back_on_torn_checkpoint(tmp_path):
    """A crash between the json sidecar and the npz (or a deleted sidecar)
    does not break resume: restore() falls back to the previous whole
    step."""
    ck = TrainCheckpoint(str(tmp_path))
    ck.save(0, {"w": torch.arange(3.0)}, {}, {}, lr=1e-3)
    ck.save(1, {"w": torch.arange(3.0) + 10}, {}, {}, lr=1e-4)
    os.remove(str(tmp_path / "ckpt_1.json"))  # tear step 1
    got, meta = ck.restore({"params": {"w": torch.zeros(3)}})
    assert meta["step"] == 0 and meta["lr"] == 1e-3
    assert float(got["params"]["w"][2]) == 2.0
    # a truncated npz falls back too
    ck = TrainCheckpoint(str(tmp_path / "trunc"))
    ck.save(0, {"w": torch.arange(3.0)}, {}, {}, lr=1e-3)
    ck.save(1, {"w": torch.arange(3.0) + 10}, {}, {}, lr=1e-4)
    with open(str(tmp_path / "trunc" / "ckpt_1.npz"), "r+b") as f:
        f.truncate(40)
    got, meta = ck.restore({"params": {"w": torch.zeros(3)}})
    assert meta["step"] == 0 and float(got["params"]["w"][2]) == 2.0


def test_checkpoint_files_are_the_jax_packages(tmp_path):
    """The npz keys are the JAX package's pytree paths, the step count
    int32, and the JAX package's TrainCheckpoint reads the port's pair
    (and ignores the generator's state)."""
    import jax.numpy as jnp

    ad = io.normalize(io.read_dataset(AnnData(make_counts(60, 12, seed=2))))
    net = AE_types["zinb-conddisp"](input_size=12, hidden_size=(8, 4, 8), device="cpu").build()
    train(ad, net, epochs=2, verbose=False, optimizer="Adam", output_dir=str(tmp_path),
          checkpoint_every=1)
    d = str(tmp_path / "checkpoints")
    with np.load(os.path.join(d, "ckpt_1.npz")) as data:
        keys = set(data.files)
        assert data["opt_state/t"].dtype == np.int32 and int(data["opt_state/t"]) == 2 * 2
        assert data["rng/generator"].dtype == np.uint8
    for key in ("params/heads/mean/kernel", "params/trunk/enc0/bn_beta",
                "state/trunk/enc0/moving_mean", "opt_state/m/heads/mean/kernel",
                "opt_state/v/trunk/center/bias", "opt_state/t"):
        assert key in keys, key
    jnet = JAE["zinb-conddisp"](input_size=12, hidden_size=(8, 4, 8)).build()
    from dca_tpu.train.optim import get_optimizer as jget

    template = {"params": jnet.params, "state": jnet.state,
                "opt_state": jget("Adam").init(jnet.params)}
    tree, meta = JTrainCheckpoint(d).restore(template)
    assert meta["step"] == 1 and tree["opt_state"]["t"].dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(tree["params"]["heads"]["mean"]["kernel"]),
                                  net.model.heads["mean"].kernel.detach().numpy())
    with open(os.path.join(d, "ckpt_1.json")) as f:
        assert set(json.load(f)) == {"step", "lr", "seed", "callback_state"}


def _data():
    counts = make_counts(200, 50)
    return (jio.normalize(jio.read_dataset(JAnnData(counts.copy()))),
            io.normalize(io.read_dataset(AnnData(counts.copy()))))


FIT = dict(verbose=False, seed=9, reduce_lr=2, early_stop=0)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("optimizer", ["RMSprop", "Adam"])
def test_checkpoints_cross_over(tmp_path, monkeypatch, writer, optimizer):
    """A 3-epoch fit of one package with checkpoint_every=1, resumed to 6
    epochs by each package from copies of its checkpoints: the other
    package's epochs 4-6 within rtol 1e-4 of the writer's own, the
    learning rates (ReduceLROnPlateau at patience 2 takes the callback
    counters across) equal, and Adam's step count carried over."""
    monkeypatch.setenv("DCA_TPU_FUSED_LOSS", "1")
    jad, ad = _data()

    def jnet():
        return JAE["zinb-conddisp"](input_size=50, hidden_size=HID, seed=7).build()

    def tnet():
        return AE_types["zinb-conddisp"](input_size=50, hidden_size=HID, seed=7,
                                         device="cpu").build()

    fits = {"jax": lambda out, **kw: jtrain(jad, jnet(), output_dir=out, compiled=False,
                                            optimizer=optimizer, **FIT, **kw),
            "torch": lambda out, **kw: train(ad, tnet(), output_dir=out, optimizer=optimizer,
                                             **FIT, **kw)}
    first = str(tmp_path / "first")
    fits[writer](first, epochs=3, checkpoint_every=1)
    hist = {}
    for pkg in ("jax", "torch"):
        out = str(tmp_path / pkg)
        shutil.copytree(first, out)
        hist[pkg] = fits[pkg](out, epochs=6, checkpoint_every=1, resume=True).history
        if optimizer == "Adam":
            with np.load(os.path.join(out, "checkpoints", "ckpt_5.npz")) as data:
                t = int(data["opt_state/t"])
            assert t == 6 * 6, (pkg, t)  # 6 epochs of 6 steps (180 train rows, batch 32)
    for key in ("loss", "val_loss"):
        assert len(hist["torch"][key]) == 3
        np.testing.assert_allclose(hist["torch"][key], hist["jax"][key], rtol=1e-4,
                                   err_msg=key)
    assert hist["torch"]["lr"] == hist["jax"]["lr"]


def _dropout_net():
    return AE_types["zinb-conddisp"](input_size=50, hidden_size=HID, hidden_dropout=0.1,
                                     seed=3, device="cpu").build()


@pytest.mark.parametrize("where", ["in_memory", "streaming"])
def test_resume_is_the_uninterrupted_fit(tmp_path, capsys, where):
    """At dropout 0.1: 2 epochs, then resume=True to 5, give the
    uninterrupted 5-epoch fit's epochs 3-5 bit for bit, the final
    parameters too; streamed (max_device_cells=64) as in memory."""
    _, ad = _data()
    kw = dict(FIT, epochs=5, verbose=True)
    if where == "streaming":
        kw.update(max_device_cells=64, batch_size=32)
    whole = _dropout_net()
    h_whole = train(ad, whole, **kw).history
    out = str(tmp_path / "run")
    train(ad, _dropout_net(), output_dir=out, checkpoint_every=1, **{**kw, "epochs": 2})
    resumed = _dropout_net()
    capsys.readouterr()
    h_res = train(ad, resumed, output_dir=out, checkpoint_every=1, resume=True, **kw).history
    text = capsys.readouterr().out
    tag = " [streaming]" if where == "streaming" else ""
    assert f"dca_tpu_torch: resumed from epoch 2{tag}" in text
    for key in ("loss", "val_loss", "lr"):
        assert h_res[key] == h_whole[key][2:], key
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_resume_without_a_checkpoint_starts_at_epoch_0(tmp_path):
    """resume=True over an empty directory trains from the start, as the
    JAX package does; without output_dir nothing is written or read."""
    _, ad = _data()
    h = train(ad, _dropout_net(), output_dir=str(tmp_path), resume=True, **{**FIT, "epochs": 2})
    assert len(h.history["loss"]) == 2
    assert os.listdir(tmp_path / "checkpoints") == []
    h = train(ad, _dropout_net(), checkpoint_every=1, resume=True, **{**FIT, "epochs": 1})
    assert len(h.history["loss"]) == 1


def test_dca_resumes_through_training_kwds(tmp_path):
    """dca(training_kwds={"output_dir", "checkpoint_every", "resume"}): a
    second call after the fit ended resumes after its last epoch and trains
    nothing more, so it denoises with the checkpoint's weights."""
    counts = make_counts(80, 20, seed=5)
    kw = dict(epochs=2, device="cpu", hidden_size=(8, 4, 8), copy=True, return_info=True,
              training_kwds={"output_dir": str(tmp_path), "checkpoint_every": 1,
                             "resume": True})
    first = dca_tpu_torch.dca(AnnData(counts.copy()), **kw)
    assert len(first.uns["dca_loss_history"]["loss"]) == 2
    again = dca_tpu_torch.dca(AnnData(counts.copy()), **kw)
    assert again.uns["dca_loss_history"] == {}
    np.testing.assert_array_equal(again.X, first.X)
