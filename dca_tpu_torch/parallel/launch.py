"""Several devices from one process: ``train(devices=N)`` with no process
group starts its own ranks.

The port's counterpart of the JAX package's single-program mesh
(``dca_tpu/parallel/mesh.py::resolve_mesh`` over every visible device of
one program).  The port trains over a process group, one process per
device (``parallel/step.py``), so a call that asks for N > 1 devices
without one makes it: the caller becomes rank 0 and starts N - 1 local
workers, each ``python -m dca_tpu_torch.parallel.launch`` (no
``multiprocessing`` spawn, which would re-import the caller's
``__main__``: a script needs no ``if __name__ == "__main__"`` guard).
Then every rank runs the per-rank fit of ``train`` on the caller's
arguments, and the group is torn down after it.  So ``dca(adata,
devices=4)`` in a notebook and ``python -m dca_tpu_torch in.tsv out/
--devices all`` run without torchrun; under torchrun the ranks already
share a group and nothing is started here.

  * Rendezvous: rank 0 opens a ``torch.distributed.TCPStore`` on
    127.0.0.1 at port 0 and hands the port it got to the workers; the
    group is NCCL on CUDA devices and gloo on the CPU, N ranks there.
  * Inputs: the count matrix, the target, the size factors and the
    deferred z-scale vectors (a CSR matrix as its three arrays) cross once
    through shared memory (``memfd_create``: anonymous files that the
    workers inherit and map copy-on-write), not pickled N times.  The
    kernel frees them when the last process holding one closes it, so
    nothing is left behind whatever way the call ends.
  * The network: its type, constructor keywords and current parameters
    and BatchNorm state (resumed or loaded weights included) cross
    through the store; the training keywords as given.  Rank 0 alone
    writes ``output_dir``, as under torchrun.
  * Failures: a worker that exits before the fit has ended, or that has
    not joined within TIMEOUT_S, ends the call: every worker is killed and
    the call raises, naming the rank and the tail of its stderr.  So does
    a rank that falls silent: each rank posts its progress to the store
    from the fit loop itself (``post_progress``: each epoch ended, each
    step run from Python, each streamed part dispatched), never from a
    thread of its own, which would go on beating while the loop hangs;
    once no rank has moved for TIMEOUT_S the monitor fails the rank that
    is behind (``behind``).  Over gloo rank 0's pending collective fails
    as soon as its peer is gone; over NCCL the monitor aborts the group
    (``_abort_group``: ``_abort_process_group``, which ends a collective
    in flight, replayed from a CUDA graph or not, while the monitor
    destroys rank 0's step graphs, without which NCCL does not finish the
    abort), and rank 0 runs with TORCH_NCCL_ASYNC_ERROR_HANDLING=2 (abort
    the communicators, keep the process), so that the abort does not take
    the caller's process down; rank 0's next post of progress, or its
    next replay, then raises, before it enqueues more work on the aborted
    group.  Each collective's own timeout is twice TIMEOUT_S, a backstop
    behind the progress rule.  No process
    group and no child outlives the call.
  * Ranks that the launcher did not start (torchrun's, ``multihost.
    initialize``'s, ``init_process_group`` by hand) get the same progress
    rule from ``train`` (``watching``): each posts to the group's own
    store, under keys of the fit, and a checker thread on every rank
    aborts the group, the fit's graphs released, once no rank has moved
    for the timeout; the fit then raises ``LaunchError`` naming the rank
    behind.
  * The ranks of a gloo group (the CPU's, or ranks that share one card)
    compute with one intra-op thread each, unless ``threads`` is given;
    the caller's own count comes back after the fit.  NCCL ranks keep
    torch's default, as ranks started by hand do.
  * Kernels are built in the caller before the workers start, and each
    worker takes its own CUDA device by index (``mesh.rank_devices`` reads
    ``devices``).
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import functools
import itertools
import mmap
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0  # a worker's start-up, and the longest a fit may go with no rank moving
# the intra-op threads of a gloo rank, unless ``threads`` says otherwise:
# N ranks of as many threads as the host has cores spin against each other
# in gloo's collectives (a CPU epoch many times slower).  NCCL ranks keep
# torch's default: their host work, the streaming tier's staging, needs
# the threads.
RANK_THREADS = 1
SPEC_KEY = "dca_tpu_torch/spec"
NCCL_HANDLING = "TORCH_NCCL_ASYNC_ERROR_HANDLING"
_MEMFD_NAME = "dca_tpu_torch"


# ---------------------------------------------------------------------------
# the inputs in shared memory
# ---------------------------------------------------------------------------


class SharedArrays:
    """numpy arrays copied once into anonymous shared memory, one memfd
    each, for processes that inherit the descriptors (``pass_fds``):
    ``specs`` {name: (fd, dtype, shape)} attaches them there (``attach``).
    ``close`` drops this process's hold; the memory goes with the last."""

    def __init__(self, arrays):
        self.fds, self.specs, self.nbytes = [], {}, 0
        try:
            for name, a in arrays.items():
                a = np.ascontiguousarray(a)
                fd = None
                if a.nbytes:
                    fd = os.memfd_create(_MEMFD_NAME)
                    self.fds.append(fd)
                    os.ftruncate(fd, a.nbytes)
                    with mmap.mmap(fd, a.nbytes) as mm:
                        mm[:] = a.reshape(-1).view(np.uint8).data
                self.specs[name] = (fd, a.dtype.str, a.shape)
                self.nbytes += a.nbytes
        except BaseException:
            self.close()
            raise

    def close(self):
        for fd in self.fds:
            os.close(fd)
        self.fds = []


def attach(specs):
    """{name: array} of ``SharedArrays.specs`` in this process, mapped
    copy-on-write: the arrays read the shared pages, and a write (a CSR
    matrix's in-place canonicalisation) copies its page for this process
    alone."""
    out = {}
    for name, (fd, dtype, shape) in specs.items():
        dtype = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if n == 0:
            out[name] = np.zeros(shape, dtype)
            continue
        mm = mmap.mmap(fd, n, flags=mmap.MAP_PRIVATE, prot=mmap.PROT_READ | mmap.PROT_WRITE)
        os.close(fd)
        out[name] = np.frombuffer(mm, dtype=dtype).reshape(shape)
    return out


def _matrix_arrays(prefix, M, arrays):
    """Put matrix ``M`` into ``arrays`` under ``prefix``; its description."""
    if sp.issparse(M):
        M = M.tocsr()
        for part in ("data", "indices", "indptr"):
            arrays[f"{prefix}.{part}"] = getattr(M, part)
        return ("csr", prefix, M.shape)
    arrays[prefix] = np.asarray(M)
    return ("dense", prefix, None)


def _matrix(desc, arrays):
    kind, prefix, shape = desc
    if kind == "csr":
        return sp.csr_matrix((arrays[f"{prefix}.data"], arrays[f"{prefix}.indices"],
                              arrays[f"{prefix}.indptr"]), shape=shape, copy=False)
    return arrays[prefix]


def share_adata(adata):
    """(``SharedArrays`` of what ``train`` reads of ``adata``, the
    description ``adata_from`` rebuilds it from): X, the raw target (once
    where it is X itself), the size factors and the deferred z-scale."""
    arrays, desc = {}, {"uns": {}}
    desc["X"] = _matrix_arrays("X", adata.X, arrays)
    raw = getattr(adata, "raw", None)
    if raw is not None:
        desc["raw"] = "X" if raw.X is adata.X else _matrix_arrays("raw", raw.X, arrays)
        desc["raw_var_names"] = [str(v) for v in raw.var_names]
    if "size_factors" in adata.obs:
        arrays["size_factors"] = np.asarray(adata.obs["size_factors"])
    for key in ("dca_scale_mean", "dca_scale_std"):
        if key in adata.uns:
            arrays[key] = np.asarray(adata.uns[key])
            desc["uns"][key] = key
    return SharedArrays(arrays), desc


def adata_from(desc, arrays):
    """The port's ``AnnData`` of ``share_adata``'s description over the
    attached ``arrays``: what ``train`` reads of the caller's."""
    import pandas as pd

    from ..data.adata import AnnData, Raw

    X = _matrix(desc["X"], arrays)
    ad = AnnData(X, uns={k: arrays[v] for k, v in desc["uns"].items()})
    if "raw" in desc:
        rX = X if desc["raw"] == "X" else _matrix(desc["raw"], arrays)
        ad.raw = Raw(rX, pd.DataFrame(index=pd.Index(desc["raw_var_names"])), ad.obs_names)
    if "size_factors" in arrays:
        ad.obs["size_factors"] = arrays["size_factors"]
    return ad


# ---------------------------------------------------------------------------
# progress
# ---------------------------------------------------------------------------


class LaunchError(RuntimeError):
    """A rank of a launched fit failed, or did not answer in time."""


def _progress_key(rank):
    return f"dca_tpu_torch/progress/{rank}"


class Progress:
    """A rank's progress, posted to the launcher's ``store`` by the fit
    loop (``post_progress``): each call adds one to this rank's count.
    ``failed``, on rank 0: a callable that raises once the launch has
    failed, called before each post, so that rank 0 stops at its next
    point of progress instead of enqueuing work on an aborted group."""

    def __init__(self, store, rank, failed=None):
        self.store = store
        self.rank = rank
        self.failed = failed
        self.count = 0

    def __call__(self):
        if self.failed is not None:
            self.failed()
        self.count += 1
        self.store.set(_progress_key(self.rank), str(self.count))


_POSTER = threading.local()  # .post: the Progress of the fit this thread runs


@contextlib.contextmanager
def posting(progress):
    """``post_progress`` calls ``progress`` in this thread inside."""
    _POSTER.post = progress
    try:
        yield
    finally:
        _POSTER.post = None


def post_progress():
    """One point of progress of the fit this thread runs, called by the
    fit loop itself: each epoch ended (``_FitCallbacks.end_epoch``, the
    compiled fit's eager epochs), each step that ``EagerEpoch`` runs and
    each streamed part dispatched.  Every rank runs the same points in
    the same order, so the counts compare.  Nothing outside a launch."""
    post = getattr(_POSTER, "post", None)
    if post is not None:
        post()


def check_failed():
    """Raise ``LaunchError`` where the progress rule of the fit this thread
    runs has failed a rank; between points of progress (``GraphFit.wait``)."""
    post = getattr(_POSTER, "post", None)
    if post is not None and post.failed is not None:
        post.failed()


def behind(counts, moved):
    """The rank that is behind: the least count of ``counts`` ({rank:
    count}); of equal counts the one that moved last the longest ago
    (``moved``, {rank: time})."""
    return min(counts, key=lambda r: (counts[r], moved[r], r))


class _Stall:
    """The progress rule over ``world`` ranks' counts in ``store`` (a rank
    whose key is not set yet has not begun: its count is 0): once no rank
    has moved for ``timeout`` seconds, ``check`` names the rank that is
    behind (``behind``).  The clock starts at construction."""

    def __init__(self, store, world, timeout):
        self.store = store
        self.keys = [_progress_key(r) for r in range(world)]
        self.timeout = timeout
        now = time.monotonic()
        self.counts = dict.fromkeys(range(world), 0)
        self.moved = dict.fromkeys(range(world), now)
        self.lock = threading.Lock()  # the monitor's thread and rank 0's settle

    def check(self):
        """The rank that is behind once no rank has moved for the timeout,
        else None."""
        with self.lock:
            now = time.monotonic()
            for r, key in enumerate(self.keys):
                if not self.store.check([key]):
                    continue
                count = int(self.store.get(key))
                if count != self.counts[r]:
                    self.counts[r], self.moved[r] = count, now
            if now - max(self.moved.values()) > self.timeout:
                return behind(self.counts, self.moved)
            return None


# ---------------------------------------------------------------------------
# the progress rule of a group that the launcher did not start
# ---------------------------------------------------------------------------


_FITS = itertools.count()  # the fits on a group in this process: their keys' namespace
SETTLE_S = 5.0  # past the stall timeout, the longest a failed collective waits for the verdict
POLL_S = 0.1  # the checker's interval


class _GroupWatch:
    """The launcher's progress rule for the ranks of a group that it did
    not start (torchrun's, ``multihost.initialize``'s, ``init_process_group``
    by hand), for one fit: this rank posts its ``progress`` to the group's
    own store (the one torchrun or the caller made), under keys of this
    fit (``_FITS`` advances alike on every rank, since every rank runs the
    same fits), from the fit thread; a checker thread runs ``_Stall`` over
    every rank's keys, and once no rank has moved for ``timeout`` seconds
    records the rank behind and aborts the group with the fit thread's
    CUDA graphs released (``_abort_group``); so does a store that stops
    answering, its host gone.  The fit thread's next post then raises
    ``LaunchError`` (``raise_failed``)."""

    def __init__(self, timeout):
        self.rank, self.world, self.timeout = dist.get_rank(), dist.get_world_size(), timeout
        store = dist.PrefixStore(f"dca_tpu_torch/fit/{next(_FITS)}",
                                 dist.distributed_c10d._get_default_store())
        self.progress = Progress(store, self.rank, self.raise_failed)
        store.set(_progress_key(self.rank), "0")
        # the checker's own client: a fit thread waiting in the store
        # (a subgroup's rendezvous) does not hold it up
        self.stall = _Stall(store.clone(), self.world, timeout)
        self.fit_thread = threading.get_ident()
        self.failed = None
        self.ended = threading.Event()
        self.checker = threading.Thread(target=self._watch, daemon=True)
        self.checker.start()

    def _watch(self):
        while not self.ended.wait(POLL_S):
            try:
                rank = self.stall.check()
            except RuntimeError as e:  # the store's server is gone with its process
                what = (f"the process group's store stopped answering ({type(e).__name__}): "
                        "the rank that hosts it (rank 0, unless an agent such as torchrun's "
                        "does) is gone")
            else:
                if rank is None:
                    continue
                counts = [self.stall.counts[r] for r in sorted(self.stall.counts)]
                what = (f"rank {rank} of {self.world} made no progress for {self.timeout:g} s "
                        f"(progress counts {counts}, by rank)")
            self.failed = (f"{what}; the fit was stopped and the process group aborted on "
                           f"rank {self.rank}")
            _abort_group(self.fit_thread)
            return

    def raise_failed(self):
        """Raise ``LaunchError`` once the rule has failed a rank."""
        if self.failed is not None:
            raise LaunchError(self.failed)

    def settle(self, wait):
        """Whether the rule fails a rank within ``wait`` seconds."""
        t_end = time.monotonic() + wait
        while self.failed is None and self.checker.is_alive() and time.monotonic() < t_end:
            time.sleep(POLL_S / 2)
        return self.failed is not None

    def stop(self):
        """End the checks; an abort under way is waited for, up to the
        timeout (the fit's error is raised after it either way)."""
        self.ended.set()
        self.checker.join(self.timeout)
        self.stall = None  # its store client


def _in_collective(err):
    """Whether ``err`` was raised inside ``torch.distributed``: a failed
    collective, whose cause may be a peer."""
    tb = err.__traceback__
    while tb is not None:
        if f"torch{os.sep}distributed{os.sep}" in tb.tb_frame.f_code.co_filename:
            return True
        tb = tb.tb_next
    return False


def _gloo_backends():
    """The gloo backend of every process group of this process."""
    out = []
    for pg in list(dist.distributed_c10d._world.pg_map):
        try:
            backend = pg._get_backend(torch.device("cpu"))
        except RuntimeError:  # a group with no CPU backend
            continue
        if backend.name() == "gloo":
            out.append(backend)
    return out


@contextlib.contextmanager
def watching(mesh):
    """The progress rule (``_GroupWatch``) around a fit over ``mesh``
    (``parallel/mesh.py``, None for none) whose ranks the launcher did not
    start; nothing for no mesh or a launched rank (``posting`` already set
    its own rule).  The timeout is ``initialize``'s where it made the group
    with one, else TIMEOUT_S.  Gloo cannot abort a collective in flight,
    so inside, each gloo group's collectives time out after the timeout at
    most (their own timeouts come back after).  A collective that fails
    inside (a gloo peer gone, an aborted NCCL group) waits up to the
    timeout and SETTLE_S for the rule's verdict, then raises it as
    ``LaunchError``."""
    from .multihost import group_timeout

    if mesh is None or getattr(_POSTER, "post", None) is not None:
        yield
        return
    timeout = group_timeout() or TIMEOUT_S
    cap = datetime.timedelta(seconds=timeout)
    saved = [(b, b.options._timeout) for b in _gloo_backends()]
    for b, t in saved:
        b._set_default_timeout(min(t, cap))
    watch = _GroupWatch(timeout)
    try:
        with posting(watch.progress):
            yield
    except BaseException as e:
        if not isinstance(e, LaunchError) and (
                watch.failed is not None
                or (_in_collective(e) and watch.settle(timeout + SETTLE_S))):
            raise LaunchError(watch.failed) from e
        raise
    finally:
        watch.stop()
        if watch.failed is None:
            for b, t in saved:
                b._set_default_timeout(t)


# ---------------------------------------------------------------------------
# the caller: rank 0
# ---------------------------------------------------------------------------


class _Worker:
    """One started worker: its process and the tail of its stderr."""

    def __init__(self, rank, cmd, env, fds):
        self.rank = rank
        self.tail = collections.deque(maxlen=60)
        self.proc = subprocess.Popen(cmd, env=env, pass_fds=fds, stdin=subprocess.DEVNULL,
                                     stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                     text=True, errors="replace")
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stderr:
            self.tail.append(line)

    def stderr(self):
        self.reader.join(5.0)
        return "".join(self.tail)[-3000:]

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.reader.join(5.0)


def worker_command(rank, world, port):
    """The command line of worker ``rank``."""
    return [sys.executable, "-m", "dca_tpu_torch.parallel.launch", str(port), str(rank),
            str(world)]


class _Monitor:
    """Polls the workers while rank 0 fits: the first that exits with an
    error is the failure, or, once ``stall`` is set (a ``_Stall``), the
    rank that is behind when no rank has moved for its timeout; then every
    worker is killed and ``abort``, where it is set (the NCCL group's), is
    called, so that rank 0's pending collective fails at once (over gloo it
    does by itself)."""

    def __init__(self, workers):
        self.workers = workers
        self.failed = None
        self.abort = None
        self.aborted = False
        self.stall = None
        self.lock = threading.Lock()
        self.ended = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self):
        while not self.ended.wait(0.1):
            if self.check():
                return

    def check(self):
        """Whether a worker has exited with an error (its code), or no rank
        has moved for the stall's timeout (the rank behind), or one was
        already failed."""
        for w in self.workers:
            if self.failed is None and w.proc.poll():
                self.fail(w, f"exited with code {w.proc.returncode}")
        stall = self.stall
        if self.failed is None and stall is not None:
            rank = stall.check()
            if rank is not None:
                worker = next((w for w in self.workers if w.rank == rank), None)
                self.fail(worker, f"made no progress for {stall.timeout:g} s (progress "
                                  f"counts {[stall.counts[r] for r in sorted(stall.counts)]}, "
                                  "by rank)")
        return self.failed is not None

    def raise_failed(self):
        """Raise ``LaunchError`` if the launch has failed (rank 0's
        ``Progress.failed``)."""
        if self.failed is not None:
            raise LaunchError("the launch failed; the fit was stopped")

    def settle(self, wait=2.0):
        """After rank 0's fit raised: whether a worker's exit with an error
        comes within ``wait`` seconds (a collective fails on rank 0 as soon
        as its peer's process is gone, before this thread may see it)."""
        t_end = time.monotonic() + wait
        while not self.check() and time.monotonic() < t_end:
            time.sleep(0.05)
        return self.failed is not None

    def fail(self, worker, what):
        """Record the failure of ``worker`` (None: rank 0, this process),
        kill every worker and abort the group, once."""
        with self.lock:
            first = self.failed is None
            if first:
                self.failed = (worker, what)
            abort = self.abort if first else None
            self.aborted = self.aborted or abort is not None
        for w in self.workers:
            w.kill()
        if abort is not None:
            abort()

    def stop(self):
        """No more watching, and no abort: the group is left as a whole."""
        with self.lock:
            self.abort = None
        self.ended.set()
        self.thread.join()


def _wait_ready(store, workers, monitor, timeout):
    """Wait until every worker has attached the inputs and built its
    network, or fail the first that exits or stays silent."""
    keys = [f"ready/{w.rank}" for w in workers]
    t_end = time.monotonic() + timeout
    while not store.check(keys):
        if monitor.failed is not None:
            return
        if time.monotonic() > t_end:
            silent = [w for w, k in zip(workers, keys) if not store.check([k])]
            monitor.fail(silent[0], f"did not join within {timeout:g} s")
            return
        time.sleep(0.05)


def _abort_group(thread):
    """Abort the process group (``_abort_process_group``) and, meanwhile,
    destroy the step graphs of the fit that ``thread`` (rank 0's) runs
    (``graphs.release_graphs``): the abort sets NCCL's abort flag at once,
    which ends a collective in flight, replayed or not, but finishes only
    once no CUDA graph holds the communicator's collectives."""
    from ..train.graphs import release_graphs

    aborting = threading.Thread(target=dist.distributed_c10d._abort_process_group,
                                daemon=True)
    aborting.start()
    release_graphs(thread)
    aborting.join()


def _raise_failure(monitor, world, cause=None):
    worker, what = monitor.failed
    if worker is None:
        raise LaunchError(f"rank 0 of {world} (this process, pid {os.getpid()}) {what}; the "
                          "fit was stopped and every rank ended") from cause
    raise LaunchError(f"rank {worker.rank} of {world} (pid {worker.proc.pid}) {what}; the "
                      f"fit was stopped and every rank ended. Its stderr ends:\n"
                      f"{worker.stderr()}") from cause


def launch_train(train, adata, network, kwargs, devices):
    """Run ``train(adata, network, **kwargs)`` on one rank a device of
    ``devices`` (``rank_devices``), the caller as rank 0 on ``network``;
    returns rank 0's ``History``, whose ``launch`` holds the ranks, the
    seconds until the group was formed and the shared-memory bytes.
    ``network`` then holds the whole trained parameters."""
    from ..models.network import AE_types
    from .mesh import _GRIDS, check_grid
    from .multihost import initialize

    world = len(devices)
    check_grid(world, max(int(kwargs.get("model_parallel") or 1), 1))
    if type(network) not in AE_types.values():
        raise TypeError(f"devices={kwargs.get('devices')!r}: the ranks rebuild the network "
                        f"from its type, and {type(network).__name__} is not one of AE_types")
    timeout = TIMEOUT_S
    backend = "nccl" if devices[0].type == "cuda" and devices[1] != devices[0] else "gloo"
    t0 = time.perf_counter()
    if devices[0].type == "cuda":
        from ..ops import _build

        _build.library()  # once here, not at each rank's first launch
    shared, desc = share_adata(adata)
    store = workers = monitor = None
    current = torch.cuda.current_device() if devices[0].type == "cuda" else None
    threads = torch.get_num_threads()
    if not kwargs.get("threads") and backend == "gloo":
        torch.set_num_threads(RANK_THREADS)
    # init_process_group wraps sys.excepthook to prefix the rank; the
    # caller's comes back with its group's end, as does the caller's NCCL
    # error handling
    hook = sys.excepthook
    handling = os.environ.get(NCCL_HANDLING)
    try:
        store = dist.TCPStore("127.0.0.1", 0, None, True,
                              datetime.timedelta(seconds=timeout), wait_for_workers=False)
        params, state = network.numpy_trees()
        for r in range(world):
            store.set(_progress_key(r), "0")
        store.set(SPEC_KEY, pickle.dumps(dict(
            ae_type=network.ae_type, ctor=network._ctor_config(), params=params, state=state,
            train=kwargs, adata=desc, arrays=shared.specs, backend=backend,
            devices=[str(d) for d in devices], timeout=timeout)))
        pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [pkg] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        workers = [_Worker(r, worker_command(r, world, store.port), env, shared.fds)
                   for r in range(1, world)]
        monitor = _Monitor(workers)
        _wait_ready(store, workers, monitor, timeout)
        if monitor.failed is not None:
            _raise_failure(monitor, world)
        if backend == "nccl":
            # read by each NCCL group as it is made, the grids' too: on an
            # error or a timeout abort the communicators, but keep rank 0's
            # process, the caller's (the default ends it)
            os.environ[NCCL_HANDLING] = "2"
        initialize(num_processes=world, process_id=0, backend=backend, device=devices[0],
                   store=store, timeout=2 * timeout)
        if backend == "nccl":
            monitor.abort = functools.partial(_abort_group, threading.get_ident())
        # the monitor's own client: the progress rule polls beside the fit
        monitor.stall = _Stall(dist.TCPStore("127.0.0.1", store.port, None, False,
                                             datetime.timedelta(seconds=timeout)),
                               world, timeout)
        t_group = time.perf_counter() - t0
        try:
            with posting(Progress(store, 0, monitor.raise_failed)):
                hist = train(adata, network, **kwargs)
            # every rank leaves the group together: NCCL's teardown waits for
            # the other ranks' (a worker's hung while this rank waited for it)
            dist.barrier()
            monitor.stop()
            dist.destroy_process_group()
        except BaseException as e:
            # a rank's own error (a ValueError of its arguments, on every
            # rank alike) is rank 0's to raise; a failed collective, or
            # any error after the monitor aborted the group, names the
            # rank that ended first
            if monitor.aborted or (isinstance(e, RuntimeError) and monitor.settle()):
                _raise_failure(monitor, world, e)
            raise
        for w in workers:
            try:
                w.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                monitor.fail(w, f"did not end within {timeout:g} s of the fit")
            if w.proc.returncode:
                monitor.fail(w, f"exited with code {w.proc.returncode} after the fit")
            if monitor.failed is not None:
                _raise_failure(monitor, world)
        hist.launch = dict(ranks=world, backend=backend, group_s=t_group,
                           shared_bytes=shared.nbytes)
        return hist
    finally:
        if monitor is not None:
            monitor.stop()
            monitor.stall = None  # its store client
        for w in workers or ():
            w.kill()
        if dist.is_initialized():
            dist.destroy_process_group()
        sys.excepthook = hook
        if handling is None:
            os.environ.pop(NCCL_HANDLING, None)
        else:
            os.environ[NCCL_HANDLING] = handling
        torch.set_num_threads(threads)
        _GRIDS.clear()  # the grids' groups went with the group
        shared.close()
        del store
        if current is not None:
            torch.cuda.set_device(current)


# ---------------------------------------------------------------------------
# a worker
# ---------------------------------------------------------------------------


def _worker_main(port, rank, world):
    from ..models.network import AE_types
    from ..train.loop import train
    from .multihost import initialize

    store = dist.TCPStore("127.0.0.1", port, None, False, datetime.timedelta(seconds=60))
    spec = pickle.loads(store.get(SPEC_KEY))
    store.set_timeout(datetime.timedelta(seconds=spec["timeout"]))
    device = torch.device(spec["devices"][rank])
    if not spec["train"].get("threads") and spec["backend"] == "gloo":
        torch.set_num_threads(RANK_THREADS)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    adata = adata_from(spec["adata"], attach(spec["arrays"]))
    network = AE_types[spec["ae_type"]](device=device, **spec["ctor"]).build()
    network.load_trees(spec["params"], spec["state"])
    store.set(f"ready/{rank}", "1")
    initialize(num_processes=world, process_id=rank, backend=spec["backend"], device=device,
               store=store, timeout=2 * spec["timeout"])
    with posting(Progress(store, rank)):
        train(adata, network, **spec["train"])
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main(*(int(a) for a in sys.argv[1:4]))
