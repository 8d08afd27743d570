"""A training epoch's steps, run one op at a time or replayed from CUDA
graphs.

The counterpart of the JAX package's compiled epoch (``dca_tpu/train/
loop.py``: ``epoch_fn``, one jitted ``lax.scan`` over the full steps, and
``rem_step_fn``, one jitted step for the trailing batch).  Both runners
take the step of ``parallel/step.py``, which reads its rows, its step
index and its learning rate from a ``StepBuffers`` and writes its loss
there, and run one epoch for a permutation of the train rows:

  * ``EagerEpoch`` calls the step from Python, once a step: the CPU fit,
    the ``debug`` fit (its sanitizer reads values back) and a fit over a
    gloo group (gloo's collectives run on the host, which a CUDA graph
    cannot capture: the CPU's ranks, and ranks that share one card);
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

Over an NCCL group (``parallel/step.py``'s sharded step: one rank a card)
the steps are captured and replayed too, the counterpart of the JAX
package's one ``jax.jit`` over the mesh (``dca_tpu/parallel/step.py``):
the step's collectives (BatchNorm's sums, the input layer's sum over the
model group, the loss's (sum, count) pair and the flat gradient buffers,
``_AllReduceSum``'s backward among them, which the autograd thread issues)
go through ``ProcessGroupNCCL`` on the capture stream, which joins its
NCCL stream to the capture by events, so each lands in the graph as NCCL
kernel nodes, and a replay runs them with no host hop.  Three rules make
that hold on every rank: the warm-up runs every step once eagerly, which
creates the communicator of every group the step uses (a communicator
made inside a capture is illegal); every rank restores the same state
after it, and captures the same steps in the same order; the predicate
``capture_steps`` reads only what every rank shares.  A replayed
collective is invisible to PyTorch's NCCL watchdog; every rank of a group
has the progress rule of ``parallel/launch.py`` instead (the launcher's
for the ranks it starts, the group's own for the others), and its abort
of a failed fit's group destroys the fit's graphs meanwhile
(``release_graphs``), since NCCL finishes the abort of a communicator only
once no graph holds its collectives.

``GraphFit`` captures the whole epoch of the fit on the device
(``train/compiled.py``, the counterpart of the JAX package's
``dca_tpu/train/compiled.py``): the steps, the validation, the callbacks
and the history writes, as one graph whose epoch is a conditional IF node
opened while the fit has not stopped; the host enqueues a replay an epoch.
Over NCCL the epoch's collectives are captured as the steps' are, and the
same three rules hold (the warm-up, an epoch run eagerly on the capture
stream, makes every communicator); since CUDA refuses them inside a
conditional node's body, a rank's whole-epoch graph has no IF node and the
host reads ``stop`` after each replay.

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

import contextlib
import ctypes
import functools
import threading
import time
import weakref

import torch

from ..ops import counters
from ..parallel.launch import post_progress

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


def capture_steps(device, backend, debug, graphs=True):
    """Whether a fit replays its steps from CUDA graphs: on a CUDA
    ``device`` with no process group (``backend`` None) or over NCCL,
    unless ``debug`` (its sanitizer reads values back) or ``graphs`` is
    False (``train(_graphs=False)``).  Gloo's collectives run on the host
    and cannot be captured.  Every argument is the same on every rank of a
    group, so every rank gives the same answer."""
    return (bool(graphs) and not debug and torch.device(device).type == "cuda"
            and backend in (None, "nccl"))


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
    times, then ``step(trailing=True)`` if there are trailing rows, each
    step a point of progress of a launched rank (``launch.post_progress``)."""

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
            post_progress()
        if self.rem:
            self.step(trailing=True)
            post_progress()


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
        _register(self)

    def replay(self, key, times=1):
        """Replay the graph of ``key`` ``times`` times and count its
        launches; raises once the graphs are released."""
        with self.lock:
            if not self.graphs:
                raise _released()
            graph = self.graphs[key]
            for _ in range(times):
                graph.replay()
        counters.add(self.launches[key], times)

    def release(self):
        """Destroy the graphs (a replay in flight ends first, on its own)."""
        with self.lock:
            for graph in self.graphs.values():
                graph.reset()
            self.graphs.clear()


_LIVE = weakref.WeakSet()  # every GraphSteps and GraphFit of this process
_LIVE_LOCK = threading.Lock()


def _register(graphs):
    """Register ``graphs`` (a ``GraphSteps`` or a ``GraphFit``) as captured
    by this thread, for ``release_graphs``."""
    graphs.thread = threading.get_ident()
    graphs.lock = threading.Lock()  # the replays against ``release``
    with _LIVE_LOCK:
        _LIVE.add(graphs)


def _released():
    return RuntimeError("the fit's CUDA graphs were released (release_graphs): its process "
                        "group is being aborted")


def release_graphs(thread):
    """Destroy the graphs that thread ``thread`` captured (``GraphSteps``'
    step graphs, ``GraphFit``'s whole-epoch graph: their ``release``), from
    another thread: the one that aborts a failed fit's NCCL group
    (``parallel/launch.py``, the launcher's monitor or a group's checker).
    NCCL does not finish the abort of a communicator while a CUDA graph
    holding its collectives lives, and the failed fit's thread, waiting on
    its device or in the fit, cannot free them itself; its next replay
    raises."""
    with _LIVE_LOCK:
        live = [graphs for graphs in _LIVE if graphs.thread == thread]
    for graphs in live:
        graphs.release()


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
    one CUDA graph.

    With ``conditional`` (a fit on one device, no process group) the
    graph's epoch is the body of a conditional IF node that the device
    opens only while the fit's flag ``stop`` (a one-element bool tensor) is
    false (``ops/conditional.py``).  ``run(epochs)`` enqueues one replay an
    epoch, back to back, with no wait on the device: a replay after the
    stop runs the kernel that reads the flag and nothing else.

    Without it (a rank of an NCCL group) the epoch, its collectives
    included, is the graph itself: CUDA refuses NCCL's collectives inside
    a conditional node's body under NCCL's defaults ("CUDA error: invalid
    argument" at the body's capture; with ``NCCL_GRAPH_MIXING_SUPPORT=0``
    it captures, but NCCL's abort of the group then did not return once
    the graph was freed, and that setting voids NCCL's ordering of the
    step graphs' replays against the eager collectives after them:
    ``chip_abort.py``'s ``if-body`` variants, PERF.md).  ``run_each``
    then replays it once an epoch, waits for each replay by polling its
    event (``wait``: a point of progress an epoch, so the group's progress
    rule follows the device, never blocked while a peer may be gone) and
    reads ``stop`` after it, stopping there.

    Each replay goes through ``CUDAGraph.replay``, which advances the
    registered dropout generator's offset, so every epoch draws its own
    masks (one replay of a graph that looped over the epochs would draw
    the same ones every epoch).  As ``GraphSteps``: before the capture the
    body runs once eagerly on the stream that captures it (the "body"
    stream of ``_own_stream`` with the IF node, the capture stream
    without), which builds the kernel library, makes this thread's K1
    workspace, cuBLAS's handle and workspace for the stream and, under a
    group, every communicator the epoch uses; then every tensor of
    ``state`` (each tensor the body writes) and the generator's state are
    restored in place; the generator is registered with the graph; the
    capture runs in "thread_local" mode under ``_CAPTURE_LOCK``; a failed
    capture raises; ``release_graphs`` destroys the graph of a failed
    fit.  ``capture_s`` is the wall time of the warm-up and the capture.
    ``node_launches`` and ``body_launches`` are the tallies of a replay's
    launches outside the node (the flag's kernel) and inside it, the
    whole graph's without one (``credit``)."""

    def __init__(self, body, state, generator, stop, device, conditional=True):
        from ..ops.conditional import if_body

        t0 = time.perf_counter()
        self.stop = stop
        stream = _own_stream(device)
        inner = _own_stream(device, "body") if conditional else stream
        _warm_up([body], list(state), generator, device, inner)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        pool = torch.cuda.graph_pool_handle()
        with contextlib.ExitStack() as stack:
            stack.enter_context(_CAPTURE_LOCK)
            body_tally = stack.enter_context(counters.capturing(inner.cuda_stream))
            node_tally = (stack.enter_context(counters.capturing(stream.cuda_stream))
                          if conditional else {})
            stack.enter_context(torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                                 capture_error_mode="thread_local"))
            if conditional:
                stack.enter_context(if_body(stop, stream, inner, pool))
            body()
        self.node_launches, self.body_launches = node_tally, body_tally
        inner.synchronize()  # the warm-up; not the device: others may capture
        self.capture_s = time.perf_counter() - t0
        _register(self)

    def _replay(self):
        with self.lock:
            if self.graph is None:
                raise _released()
            self.graph.replay()

    def run(self, epochs, after_epoch=None):
        """Enqueue ``epochs`` replays of the conditional graph on the
        current stream, with a CUDA event before the first and after each
        (``after_epoch()`` is called after each enqueue); returns the
        ``epochs + 1`` events.  ``enqueue_s`` is the host's wall time of the
        enqueue.  A replay after ``release`` raises."""
        events = [torch.cuda.Event(enable_timing=True) for _ in range(epochs + 1)]
        t0 = time.perf_counter()
        events[0].record()
        for e in range(epochs):
            self._replay()
            events[e + 1].record()
            if after_epoch is not None:
                after_epoch()
        self.enqueue_s = time.perf_counter() - t0
        return events

    def run_each(self, epochs, post, check, after_epoch=None):
        """Replay the graph once an epoch on the current stream, up to
        ``epochs`` times, each after the last has run (``wait`` on its
        event, with ``post`` and ``check``), and read ``stop`` after each:
        the epoch that sets it is the last.  Returns the events, one before
        the first replay and one after each; ``enqueue_s`` is the host's
        time in the replays' launches."""
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()
        self.enqueue_s = 0.0
        for _ in range(epochs):
            t0 = time.perf_counter()
            self._replay()
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            self.enqueue_s += time.perf_counter() - t0
            if after_epoch is not None:
                after_epoch()
            self.wait(events[-2:], post, check)
            if bool(self.stop):  # the epoch has run: no wait on the device
                break
        return events

    @staticmethod
    def wait(events, post, check, poll=1e-4):
        """Wait until the device has run the replays that ``events``
        follow (the first is the one before them) without blocking on it:
        poll each replay's event, with a sleep of ``poll`` seconds and a
        call of ``check()`` between polls, and call ``post()`` once the
        device has completed each.  A fit under a process group waits so
        (``post``, ``check``: its progress rule, ``launch.post_progress``
        and ``launch.check_failed``, which raise once the rule has failed
        a rank), since a peer that dies or falls silent leaves a replay
        waiting in its collectives until the rule aborts the group."""
        for event in events[1:]:
            while not event.query():
                check()
                time.sleep(poll)
            post()

    def release(self):
        """Destroy the graph (a replay in flight ends first, on its own)."""
        with self.lock:
            if self.graph is not None:
                self.graph.reset()
                self.graph = None

    def credit(self, replays, ran):
        """Count ``replays`` replays of which the body ran in ``ran``."""
        counters.add(self.node_launches, replays)
        counters.add(self.body_launches, ran)
