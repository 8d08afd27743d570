"""Sparse traffic through the program's own streaming path: the reference's
sparse inputs are the dense ones bit for bit, so the check reads the same
numbers from either; the loss kernels' schedule of a streamed fit holds
its steps as the program cuts them."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from harness import cell as C
from harness import reference as R

CPU = torch.device("cpu")


def _counts(n=300, g=60, seed=4):
    rs = np.random.RandomState(seed)
    c = rs.negative_binomial(0.7, 0.7 / (0.7 + rs.gamma(0.5, 1.0, (1, g)) * 1.5),
                             size=(n, g)).astype(np.float32)
    c[:, c.sum(0) == 0] += 1.0
    c[c.sum(1) == 0, 0] += 1.0
    return c


@pytest.mark.parametrize("block", [16384, 7])
def test_sparse_inputs_are_the_dense_inputs_bit_for_bit(block):
    counts = _counts()
    dense = R.Inputs(counts, CPU, block=block)
    sparse = R.SparseInputs(sp.csr_matrix(counts), CPU, block=block)
    assert torch.equal(dense.sf, sparse.sf)
    idx = torch.from_numpy(np.random.RandomState(0).permutation(len(counts))[:32])
    for a, b in zip(dense.rows(idx), sparse.rows(idx)):
        assert a.dtype == b.dtype and a.is_contiguous() and b.is_contiguous()
        assert torch.equal(a, b)
    for a, b in zip(dense.block(250, 300), sparse.block(250, 300)):
        assert torch.equal(a, b)
    assert R.inputs_of(sp.csr_matrix(counts), CPU).__class__ is R.SparseInputs
    assert R.inputs_of(counts, CPU).__class__ is R.Inputs


def test_the_check_reads_the_same_numbers_from_sparse_and_dense_counts(tiny_cell):
    """The program's states and the reference's epoch, from the same raw
    counts held dense and held sparse: every number, the detail's, and
    the control's alike."""
    cell = tiny_cell("nb-conddisp.paul15")
    s = C.setup(cell, 2**31 + 19, CPU)
    dense_counts = s.counts
    numbers, detail = C.check(cell, s, CPU)
    s.counts = sp.csr_matrix(dense_counts)
    numbers_sp, detail_sp = C.check(cell, s, CPU)
    assert numbers_sp == numbers
    assert detail_sp["state_gaps"] == detail["state_gaps"]
    assert detail_sp["leaf_gaps"] == detail["leaf_gaps"]
    assert detail_sp["control"] == detail["control"]


def _stream_cut(n, g, bs, part_cells, val_split):
    """The kinds and row counts of an epoch's parts as the program's
    streaming trainer cuts them (``_stream_tasks``) for an n x g input in
    parts of ``part_cells``."""
    from dca_tpu_torch.data.loader import StreamingData
    from dca_tpu_torch.train.loop import _stream_tasks

    x = sp.csr_matrix(_counts(n, g))
    split = int(n * (1.0 - val_split))
    b = min(bs, max(split, 1))
    chunk = max((min(part_cells, split) // b) * b, b)
    sf = np.ones(n, np.float32)
    tr = StreamingData(x[:split], x[:split], sf[:split], chunk)
    va = StreamingData(x[split:], x[split:], sf[split:], chunk) if split < n else None
    perm = np.random.RandomState(1).permutation(split)
    return [(t.kind, t.n) for t in _stream_tasks(tr, va, perm, b)]


@pytest.mark.parametrize("n,bs,part_cells,val_split", [
    (2730, 32, 131072, 0.1), (2730, 32, 320, 0.1), (1000, 32, 100, 0.25),
    (1000, 7, 64, 0.1), (101, 32, 16, 0.1), (500, 32, 200, 0.0)])
def test_the_streamed_schedule_holds_whatever_the_parts(tiny_cell, n, bs, part_cells,
                                                        val_split):
    """The streamed schedule's batch and trailing step are the program's
    at any part size; its validation chunks, which the record does not
    give, are left unlabelled."""
    cell = tiny_cell("nb-conddisp.paul15")
    cell.config.update(batch_size=bs, validation_split=val_split)
    s = C.Setup()
    s.n, s.n_train = n, int(n * (1.0 - val_split))
    sched = C.schedule(cell, s, "streaming")
    parts = _stream_cut(n, 10, bs, part_cells, val_split)
    assert sched["val_chunks"] is None
    assert [k for kind, k in parts if kind == "rem"] == ([sched["rem"]] if sched["rem"] else [])
    assert all(k % sched["batch"] == 0 for kind, k in parts if kind == "full")
    assert sum(k for kind, k in parts if kind != "val") == s.n_train
    assert C.schedule(cell, s, "in_memory")["val_chunks"] == ([n - s.n_train]
                                                              if n > s.n_train else [])


def test_a_streamed_fit_runs_the_schedule_the_harness_reads(tiny_cell, monkeypatch):
    """A small fit that train()'s gate streams (the documented
    DCA_TPU_DEVICE_BYTES lowered): its record shows the streaming trainer,
    and the trailing step of each epoch the program cut is the
    schedule's."""
    from dca_tpu_torch.train import loop

    monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", "1000")
    cut = []
    real = loop._stream_tasks

    def spy(*a, **k):
        tasks = real(*a, **k)
        cut.append([(t.kind, t.n) for t in tasks])
        return tasks

    monkeypatch.setattr(loop, "_stream_tasks", spy)
    cell = tiny_cell("nb-conddisp.paul15")
    cell.traffic.update(generator="nb_csr", state_fits=0)
    s = C.setup(cell, 7, CPU)
    assert sp.issparse(s.counts) and cut
    C.timed_fit(s, cell, 0.3, record=True)
    trainer, tier = C.trainer_seen(s.timeline)
    assert (trainer, tier) == ("streaming", "prefetch")
    sched = C.schedule(cell, s, trainer)
    for parts in cut:
        assert [k for kind, k in parts if kind == "rem"] == [sched["rem"]]
        assert all(k % sched["batch"] == 0 for kind, k in parts if kind == "full")
