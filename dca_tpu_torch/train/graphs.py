"""A training epoch's steps, run one op at a time or replayed from CUDA
graphs.

The counterpart of the JAX package's compiled epoch (``dca_tpu/train/
loop.py``: ``epoch_fn``, one jitted ``lax.scan`` over the full steps, and
``rem_step_fn``, one jitted step for the trailing batch).  Both runners
take the step of ``parallel/step.py``, which reads its rows, its step
index and its learning rate from a ``StepBuffers`` and writes its loss
there, and run one epoch for a permutation of the train rows:

  * ``EagerEpoch`` calls the step from Python, once a step: the CPU fit,
    the ``debug`` fit (its sanitizer reads values back) and the
    data-parallel fit (its collectives are not captured);
  * ``GraphEpoch`` captures the full step and the trailing step once, as
    two CUDA graphs, and replays the full one n_full times and the
    trailing one once an epoch, after one host-to-device copy of the
    permutation.  Before capturing, it runs each step once eagerly on the
    capture stream, which builds the kernel library, allocates and zeroes
    K1's workspace (a synchronizing first call) and creates cuBLAS's handle,
    and
    then restores in place every tensor the steps wrote and the dropout
    generator's state, so the warm-up moves nothing of the fit.  The fit's
    generator is registered with each graph, so a replay draws the dropout
    masks an eager step would.  Capture once per fit; a failure raises,
    and nothing falls back to the eager runner.

``GraphFit`` captures the whole epoch of the fit on the device
(``train/compiled.py``, the counterpart of the JAX package's
``dca_tpu/train/compiled.py``): the steps, the validation, the callbacks
and the history writes, as one graph whose epoch is a conditional IF node
opened while the fit has not stopped; the host enqueues a replay an epoch.

``GraphSteps`` does the warm-up, the captures and the replays for a set of
keyed steps: ``GraphEpoch``'s full and trailing step, and the streaming
trainer's full and trailing step on each of its two part buffers
(``train/loop.py::_train_streaming``, the counterpart of the JAX package's
``chunk_fn``/``rem_fn``).

The kernels' launch counters (``ops/fused_loss.launches``,
``ops/fused_dense.launches``) count launches on the card: a wrapper counts
when it enqueues its kernel, which under capture enqueues it into the graph
and launches nothing, so ``GraphSteps`` tallies each graph's launches apart
from the counters (``ops/counters.capturing``) and adds them at every
replay.  The warm-up's launches are real and are counted.

Fits may run at once in several threads (the trials of ``hyper.py``), each
on a stream of its own.  So a capture runs in CUDA's "thread_local" mode,
which lets other threads allocate, synchronize their streams and read back
meanwhile, on a stream made for the capturing thread (``_own_stream``),
outside PyTorch's pool, whose 32 streams go to every thread in turn and
would let another thread's work into the graph; and captures take turns
(``_CAPTURE_LOCK``), PyTorch's rule of one capture at a time in a process.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time

import torch

from ..ops import counters

_CAPTURE_LOCK = threading.Lock()
_own = threading.local()


def _own_stream(device, role="capture"):
    """This thread's stream of ``role`` on CUDA ``device``: a non-blocking
    stream made for it by the kernel library (``dca_stream_create``), once
    per thread, device and role and kept for the thread's life.  The roles:
    "capture", the stream that captures a graph, and "body", the stream that
    captures the body of ``GraphFit``'s IF node."""
    from ..ops._build import KernelError, library

    index = device.index if device.index is not None else torch.cuda.current_device()
    mine = _own.__dict__.setdefault("streams", {})
    stream = mine.get((index, role))
    if stream is None:
        lib = library()
        handle = ctypes.c_void_p()
        err = lib.dca_stream_create(index, ctypes.byref(handle))
        if err != 0:
            raise KernelError(f"stream creation failed: CUDA error {err} "
                              f"({lib.dca_cuda_error_string(err).decode()})")
        stream = torch.cuda.ExternalStream(handle.value, device=torch.device("cuda", index))
        mine[(index, role)] = stream
    return stream


def _warm_up(fns, state, generator, device, stream):
    """Run each of ``fns`` once on ``stream``, then restore in place every
    tensor of ``state`` and the ``generator``'s state, so that the run
    moves nothing of the fit."""
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        saved = [t.detach().clone() for t in state]
        rng = generator.get_state()
        for fn in fns:
            fn()
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        generator.set_state(rng)
    torch.cuda.current_stream(device).wait_stream(stream)


class EagerEpoch:
    """Runs an epoch's steps from Python: ``step(trailing=False)`` n_full
    times, then ``step(trailing=True)`` if there are trailing rows."""

    def __init__(self, step, bufs, rem):
        self.step = step
        self.bufs = bufs
        self.rem = rem

    def start(self, perm):
        """Load the epoch's permutation (a host int64 array) and zero the
        step counter."""
        self.bufs.perm.copy_(torch.from_numpy(perm))
        self.bufs.step_i.zero_()

    def __call__(self, perm):
        self.start(perm)
        for _ in range(self.bufs.n_full):
            self.step()
        if self.rem:
            self.step(trailing=True)


class GraphSteps:
    """Captures each of ``steps`` ({key: zero-argument callable}) as a
    CUDA graph once, and replays them by key.

    Before capturing, each step runs once eagerly on the capture stream,
    which builds the kernel library, allocates and zeroes this thread's K1
    workspace (a synchronizing first call) and creates cuBLAS's handle and
    workspace for the stream; then every tensor
    of ``state`` (each tensor the steps write) and the dropout
    ``generator``'s state are restored in place, so the warm-up moves
    nothing of the fit.  The generator is registered with each graph, so a
    replay draws the dropout masks an eager call would.  The graphs share
    one memory pool.  ``capture_s`` is the wall time of the warm-up and
    the captures; a failed capture raises.  ``launches[key]`` is the tally
    of a replay's launches (``ops/counters.capturing``)."""

    def __init__(self, steps, state, generator, device):
        t0 = time.perf_counter()
        stream = _own_stream(device)
        _warm_up(steps.values(), list(state), generator, device, stream)
        self.graphs = {}
        self.launches = {}
        pool = None
        for key, fn in steps.items():
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(generator)
            with _CAPTURE_LOCK, counters.capturing(stream.cuda_stream) as tally:
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    fn()
            self.launches[key] = tally
            self.graphs[key] = graph
            pool = graph.pool()
        stream.synchronize()  # the warm-up; not the device: others may capture
        self.capture_s = time.perf_counter() - t0

    def replay(self, key, times=1):
        """Replay the graph of ``key`` ``times`` times and count its
        launches."""
        graph = self.graphs[key]
        for _ in range(times):
            graph.replay()
        counters.add(self.launches[key], times)


class GraphEpoch(EagerEpoch):
    """Replays an epoch's steps from two CUDA graphs captured at
    construction (``GraphSteps``, keyed by ``trailing``).  ``state`` lists
    every tensor the steps write besides ``bufs``: the parameters (PReLU's
    alphas among them), the BN statistics and every tensor of the optimizer
    state (``optim.state_tensors``: its per-parameter tensors and its step
    count, which the warm-up advances too); ``generator`` is the fit's
    dropout generator.  ``capture_s`` is the wall time of the warm-up and
    the captures."""

    def __init__(self, step, bufs, rem, state, generator):
        super().__init__(step, bufs, rem)
        kinds = ([False] if bufs.n_full else []) + ([True] if rem else [])
        self.steps = GraphSteps({k: functools.partial(step, trailing=k) for k in kinds},
                                list(state) + [bufs.step_i, bufs.losses], generator,
                                bufs.perm.device)
        self.graphs, self.launches = self.steps.graphs, self.steps.launches
        self.capture_s = self.steps.capture_s

    def __call__(self, perm):
        self.start(perm)
        if self.bufs.n_full:
            self.steps.replay(False, self.bufs.n_full)
        if self.rem:
            self.steps.replay(True)


class GraphFit:
    """A fit's whole epoch, ``body`` (its steps, the validation, the
    callbacks and the history writes: ``train/compiled.py``), captured as
    one CUDA graph whose body is a conditional IF node that the device
    opens only while the fit's flag ``stop`` (a one-element bool tensor) is
    false (``ops/conditional.py``).  ``run(epochs)`` enqueues one replay an
    epoch, back to back, with no wait on the device: a replay after the
    stop runs the kernel that reads the flag and nothing else.  Each replay
    goes through ``CUDAGraph.replay``, which advances the registered
    dropout generator's offset, so every epoch draws its own masks (one
    replay of a graph that looped over the epochs would draw the same ones
    every epoch).

    As ``GraphSteps``: before the capture the body runs once eagerly on the
    stream that captures it (``_own_stream(device, "body")``), which builds
    the kernel library, makes this thread's K1 workspace and cuBLAS's
    handle and workspace for the stream, then every tensor of ``state``
    (each tensor the body writes) and the generator's state are restored
    in place; the generator is registered with the graph; the capture runs
    in "thread_local" mode under ``_CAPTURE_LOCK``; a failed capture
    raises.  ``capture_s`` is the wall time of the warm-up and the capture.
    ``node_launches`` and ``body_launches`` are the tallies of a replay's
    launches outside the node (the flag's kernel) and inside it
    (``credit``)."""

    def __init__(self, body, state, generator, stop, device):
        from ..ops.conditional import if_body

        t0 = time.perf_counter()
        stream = _own_stream(device)
        inner = _own_stream(device, "body")
        _warm_up([body], list(state), generator, device, inner)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        pool = torch.cuda.graph_pool_handle()
        with _CAPTURE_LOCK, counters.capturing(stream.cuda_stream) as node_tally, \
                counters.capturing(inner.cuda_stream) as body_tally:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                with if_body(stop, stream, inner, pool):
                    body()
        self.node_launches, self.body_launches = node_tally, body_tally
        inner.synchronize()  # the warm-up; not the device: others may capture
        self.capture_s = time.perf_counter() - t0

    def run(self, epochs, after_epoch=None):
        """Enqueue ``epochs`` replays on the current stream, with a CUDA
        event before the first and after each (``after_epoch()`` is called
        after each enqueue); returns the ``epochs + 1`` events.
        ``enqueue_s`` is the host's wall time of the enqueue."""
        events = [torch.cuda.Event(enable_timing=True) for _ in range(epochs + 1)]
        t0 = time.perf_counter()
        events[0].record()
        for e in range(epochs):
            self.graph.replay()
            events[e + 1].record()
            if after_epoch is not None:
                after_epoch()
        self.enqueue_s = time.perf_counter() - t0
        return events

    def credit(self, replays, ran):
        """Count ``replays`` replays of which the body ran in ``ran``."""
        counters.add(self.node_launches, replays)
        counters.add(self.body_launches, ran)
