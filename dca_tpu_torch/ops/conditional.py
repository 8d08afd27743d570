"""The conditional IF node of the whole-fit CUDA graph
(``train/graphs.py::GraphFit``): its wrapper, its launch counter and its
plain version.

No TPU kernel corresponds to it: it replaces the condition of the JAX
package's ``lax.while_loop`` over the epochs (``dca_tpu/train/
compiled.py``).  ``if_body`` appends to a graph being captured the kernel
of ``csrc/graph_if.cu``, which reads the fit's device flag ``stop`` and
sets the node's condition at every launch of the graph, then the IF node,
and captures the block's work into the node's body: a replay runs the body
only while ``stop`` is false.  The plain version (``if_reference``) is the
condition the kernel gives the node.  The wrapper exists only for CUDA
graphs; the fit on the CPU, and every fit that is not captured, reads
``stop`` back once an epoch instead (``train/compiled.py``).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import counters

# the kernel's launches: one at every launch of a graph that holds it, so
# a replayed graph credits its capture's tally at every replay
# (``counters.add``)
launches = {"graph_if": 0}


def reset_launches():
    counters.reset(launches)


def if_reference(stop):
    """The node's condition for ``stop``: true where the body runs."""
    return torch.logical_not(stop)


def _raise_on(lib, err, what):
    if err != 0:
        from ._build import KernelError

        raise KernelError(f"{what} failed: CUDA error {err} "
                          f"({lib.dca_cuda_error_string(err).decode()})")


@contextlib.contextmanager
def if_body(stop, stream, body_stream, pool):
    """While ``stream`` captures a CUDA graph into the memory pool ``pool``
    (``torch.cuda.graph(graph, pool=pool, stream=stream)``), append the
    kernel that sets the IF node's condition from ``stop`` (a one-element
    bool tensor on the card) and the node, and capture the block's work
    into the node's body on ``body_stream``, which is current in the block.

    PyTorch's allocator routes the graph's allocations to ``pool`` by the
    capture's id, and the body is a capture of its own: while it captures,
    its stream's allocations are routed to the same pool, and after it the
    parent stream's, by stream (each ``begin`` adds a use of the pool, and
    a ``release`` takes it off again), so every tensor of the body comes
    from the graph's pool and lives as long as the graph.  The body stream
    must have run the body's work once before (``GraphFit``'s warm-up):
    cuBLAS's workspace for a stream is allocated at its first product and
    kept.  Yields a list that holds, after the block, the body's kernel,
    memcpy, memset and other nodes (``train/graphs.py::node_counts``)."""
    from ._build import library

    if not stop.is_cuda or stop.dtype != torch.bool or stop.numel() != 1:
        raise ValueError(f"the IF node needs a one-element bool CUDA flag, not "
                         f"{stop.dtype} {tuple(stop.shape)} on {stop.device}")
    lib = library()
    index = stop.device.index
    err = lib.dca_graph_if_begin(stream.cuda_stream, body_stream.cuda_stream, stop.data_ptr())
    _raise_on(lib, err, "the IF node's capture (graph_if)")
    counters.record(launches, ["graph_if"], stream.cuda_stream)
    torch._C._cuda_endAllocateToPool(index, pool)
    end = None
    counts = (ctypes.c_longlong * 4)()
    nodes = []
    try:
        with torch.cuda.stream(body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            try:
                yield nodes
            finally:
                end = lib.dca_graph_if_end(body_stream.cuda_stream, counts)
                nodes[:] = list(counts)
                torch._C._cuda_endAllocateToPool(index, pool)
                torch._C._cuda_releasePool(index, pool)
    finally:
        with torch.cuda.stream(stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(index, pool)
            torch._C._cuda_releasePool(index, pool)
    _raise_on(lib, end, "the end of the IF node's body")
