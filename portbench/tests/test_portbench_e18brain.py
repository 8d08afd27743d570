"""The corpus cell's files: ``nb_csr_detected`` draws ``nb_csr``'s law by
blocks, never holding the dense matrix, and drops the genes and cells
with no count as ``dca()``'s filter does, forcing no value; at the
corpus' 27,998 genes its two medians meet the traffic file's published
figures; the cell streams through ``train()``'s own gate and ends
correct; the stream readers read a recorded streamed fit."""

import statistics
import tracemalloc
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import run
from harness import cell as C
from harness import traffic
from harness.manifest import load_manifest, reader, resolve

CELL = "nb-conddisp-e18brain.e18brain262k"
CPU = torch.device("cpu")
READERS = ("stream_wait_share", "prep_busy_share", "stage_roofline")


def _mix(**sizes):
    mix = resolve(load_manifest(), CELL).traffic
    mix.update(sizes)
    return mix


def test_it_never_holds_the_dense_matrix(monkeypatch):
    """It draws by blocks of cells: no draw and no host array as large as
    the cells x genes matrix."""
    gen = traffic.generator("nb_csr_detected")
    monkeypatch.setattr(gen, "BLOCK_ELEMENTS", 20_000)
    n_cells, n_genes = 3000, 100
    drawn = []
    real = torch.poisson

    def poisson(rates, *a, **k):
        drawn.append(rates.numel())
        return real(rates, *a, **k)

    monkeypatch.setattr(torch, "poisson", poisson)
    mix = _mix(n_cells=n_cells, n_genes=n_genes, mean_scale=0.01)
    tracemalloc.start()
    try:
        x = gen.make(mix, 3)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    dense_bytes = n_cells * n_genes * 4
    assert len(drawn) == -(-n_cells // (20_000 // n_genes))
    assert max(drawn) <= 20_000 and sum(drawn) == n_cells * n_genes
    assert peak < dense_bytes / 2, (peak, dense_bytes)
    assert sp.isspmatrix_csr(x) and x.nnz < n_cells * n_genes / 4


@pytest.mark.parametrize("scale", [0.5, 0.002])
def test_it_drops_the_empty_genes_and_cells_and_forces_nothing(scale):
    """The matrix is ``nb_csr``'s draw on the same seed with the genes and
    cells that drew no count taken out, where ``nb_csr`` forces a 1 into
    them: every kept gene and cell has a count, and every value is
    drawn."""
    mix = _mix(n_cells=400, n_genes=600, mean_scale=scale)
    x = traffic.make_counts(mix, 17)
    y = traffic.make_counts(dict(mix, generator="nb_csr"), 17)
    assert sp.isspmatrix_csr(x) and x.dtype == np.float32 and x.has_sorted_indices
    assert (np.diff(x.indptr) > 0).all()
    assert (np.bincount(x.indices, minlength=x.shape[1]) > 0).all()
    assert x.shape[1] < 600  # some genes drew nothing at this size
    # nb_csr's repair: 1 in every cell of a gene that drew nothing, then 1
    # in the first gene of a cell that drew nothing
    y = y.toarray()
    forced = (y >= 1).all(0)
    lonely = (y[:, ~forced] == 0).all(1)
    assert lonely.any() == (scale < 0.01) and x.shape[0] == 400 - lonely.sum()
    assert np.array_equal(x.toarray(), y[~lonely][:, ~forced])


def test_its_medians_are_the_published_ones_at_the_corpus_width():
    """At 2,000 cells of the corpus' 27,998 genes, on the seed a run
    derives from a large one, the median genes detected and the median
    UMI counts a cell are within 5% of the figures the traffic file
    cites; the same seed gives the same matrix."""
    mix = _mix(n_cells=2000)
    assert mix["n_genes"] == 27998
    seed = C.derive_seeds(2**31 + 4099)["data"]
    x = traffic.make_counts(mix, seed)
    genes = statistics.median(np.diff(x.indptr))
    umi = statistics.median(np.asarray(x.sum(1)).ravel())
    pub = mix["published"]
    assert abs(genes / pub["median_genes_per_cell"]["value"] - 1) < 0.05, genes
    assert abs(umi / pub["median_umi_per_cell"]["value"] - 1) < 0.05, umi
    assert 20000 < x.shape[1] < 27998
    small = _mix(n_cells=300, n_genes=2000)
    a, b = traffic.make_counts(small, 5), traffic.make_counts(small, 5)
    c = traffic.make_counts(small, 6)
    assert a.shape == b.shape and (a != b).nnz == 0
    assert a.shape != c.shape or (a != c).nnz > 0


def test_its_traffic_cites_a_source_and_assumes_the_rest():
    mix = _mix()
    pub = mix["published"]
    assert {"cells", "genes", "median_genes_per_cell", "median_umi_per_cell"} <= set(pub)
    assert all("10x Genomics" in pub[k]["source"] or "dataset" in pub[k]["source"]
               for k in pub)
    for key in ("gene_gamma_shape", "depth_sigma", "nb_size", "mean_scale"):
        assert key in mix["assumed"], key
    assert "not checked" in mix["assumed"]["published_figures"]
    cfg = resolve(load_manifest(), CELL).config
    assert cfg["reduced"] == ["cells"] and cfg["cells"] == mix["n_cells"]


def test_the_cell_streams_through_trains_gate_and_is_correct(tiny_cell, monkeypatch):
    """At the mix's CPU size, with train()'s documented DCA_TPU_DEVICE_BYTES
    lowered here alone, the cell runs through the streaming trainer (as
    the traced run's record shows) and both runs end correct against the
    plain reference; the traced run reads the stream readers."""
    monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", "100000")
    cell = tiny_cell(CELL)
    result = run.run_cell(cell, 2**31 + 37, 0.5, 0, CPU)
    assert result["correct"] is True, result["check"]
    assert set(result["metrics"]) == {"setup_s", "train_cells_per_s", "epoch_ms_p95"}
    traced = run.run_cell(cell, 2**31 + 41, 0.5, 1, CPU)
    assert traced["correct"] is True, traced["check"]
    assert traced["fit"]["trainer"] == "streaming"
    assert {"stream_wait_share", "prep_busy_share"} <= set(traced["metrics"])
    assert "stage_roofline" not in traced["metrics"]  # no CUDA events on the CPU


def _streamed_ctx(tiny_cell, monkeypatch):
    monkeypatch.setenv("DCA_TPU_DEVICE_BYTES", "100000")
    cell = tiny_cell(CELL)
    cell.traffic["state_fits"] = 0
    s = C.setup(cell, 2**31 + 43, CPU)
    hist, wall, epochs = C.timed_fit(s, cell, 0.5, record=True)
    fit = {"epochs": epochs, "unprofiled_epochs": epochs}
    return types.SimpleNamespace(timeline=s.timeline, fit=fit, trace=None, genes=s.genes,
                                 config=cell.config, traffic=cell.traffic, schedule=None)


def test_the_stream_readers_read_a_streamed_fit(tiny_cell, monkeypatch):
    ctx = _streamed_ctx(tiny_cell, monkeypatch)
    for name in ("stream_wait_share", "prep_busy_share"):
        value = reader(name)(ctx)
        assert value is not None and 0.0 <= value <= 1.0, (name, value)
    assert reader("stage_roofline")(ctx) is None  # the CPU records no stage span
    for name in READERS:
        assert reader(name)(types.SimpleNamespace(timeline=None, fit={})) is None


def _span(name, epoch, t0, t1, tid=1, **attrs):
    from dca_tpu_torch.timeline import Span

    return Span(name, epoch, 1, attrs, tid, t0, t1)


def _count(name, n, epoch, **attrs):
    from dca_tpu_torch.timeline import Count

    return Count(name, n, epoch, 1, attrs, 1, 0.0)


def test_stage_roofline_is_the_bound_over_the_device_time():
    """Two stages of 10 rows x 1000 genes, 64 MB each from the host: a
    bound of 1 ms (the link) + 120 kB / 3.35 TB/s each, over 4 ms of
    device time; an epoch after the profiler's start is left out, as is a
    record without ``rows`` or ``stream.bytes`` (a program without them)."""
    from harness.arith import HBM_BYTES_PER_S

    spans = [_span("dca.fit.epoch", 0, 0.0, 1.0),
             _span("dca.stream.stage", 0, 0.1, 0.101, part=0, kind="full", rows=10),
             _span("dca.stream.stage", 0, 0.2, 0.203, part=1, kind="val", rows=10),
             _span("dca.fit.epoch", 1, 1.0, 2.0),
             _span("dca.stream.stage", 1, 1.1, 1.9, part=0, kind="full", rows=10)]
    counts = [_count("stream.bytes", 64e6, e, part=p, kind="full", rows=10)
              for e, p in ((0, 0), (0, 1), (1, 0))]
    rec = types.SimpleNamespace(spans=spans, counts=counts)
    ctx = types.SimpleNamespace(timeline=rec, fit={"unprofiled_epochs": 1}, genes=1000)
    want = 100.0 * 2 * (1e-3 + 10 * 1000 * 4 * 3 / HBM_BYTES_PER_S) / 4e-3
    assert reader("stage_roofline")(ctx) == pytest.approx(want, rel=1e-9)
    bare = types.SimpleNamespace(
        spans=[s._replace(attrs={"part": s.attrs.get("part")}) for s in spans], counts=[])
    assert reader("stage_roofline")(types.SimpleNamespace(timeline=bare, fit={},
                                                          genes=1000)) is None


def test_the_wait_and_prep_shares_take_their_threads():
    """The waits on the fit's thread and the preps on any other, over the
    unprofiled epochs' walls."""
    spans = [_span("dca.fit.epoch", 0, 0.0, 2.0),
             _span("dca.stream.wait", 0, 0.0, 0.5, part=0, kind="full", rows=8),
             _span("dca.stream.wait", 0, 0.5, 0.6, tid=2, part=9, kind="full", rows=8),
             _span("dca.stream.prep", 0, 0.0, 0.4, tid=2, part=0, kind="full", rows=8),
             _span("dca.stream.prep", 0, 0.6, 1.4, tid=2, part=1, kind="full", rows=8),
             _span("dca.fit.epoch", 1, 2.0, 4.0),
             _span("dca.stream.wait", 1, 2.0, 3.9, part=0, kind="full", rows=8)]
    rec = types.SimpleNamespace(spans=spans, counts=[])
    ctx = types.SimpleNamespace(timeline=rec, fit={"unprofiled_epochs": 1})
    assert reader("stream_wait_share")(ctx) == pytest.approx(0.25)
    assert reader("prep_busy_share")(ctx) == pytest.approx(0.6)


def test_the_prep_share_reads_0_where_no_part_is_prepared():
    """On the resident tier (waits and stages, no prep) the prep share
    reads 0; a record with no ``dca.stream.*`` span (an in-memory fit)
    gives neither share."""
    spans = [_span("dca.fit.epoch", 0, 0.0, 2.0),
             _span("dca.stream.wait", 0, 0.0, 0.2, part=0, kind="full", rows=8),
             _span("dca.stream.stage", 0, 0.0, 0.1, part=0, kind="full", rows=8)]
    ctx = types.SimpleNamespace(timeline=types.SimpleNamespace(spans=spans, counts=[]),
                                fit={"unprofiled_epochs": 1})
    assert reader("prep_busy_share")(ctx) == 0.0
    assert reader("stream_wait_share")(ctx) == pytest.approx(0.1)
    in_memory = [_span("dca.fit.epoch", 0, 0.0, 2.0), _span("dca.fit.steps", 0, 0.0, 1.5)]
    ctx.timeline = types.SimpleNamespace(spans=in_memory, counts=[])
    for name in ("stream_wait_share", "prep_busy_share"):
        assert reader(name)(ctx) is None
