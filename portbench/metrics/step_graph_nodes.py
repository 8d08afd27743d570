"""step_graph_nodes: the nodes of the full training step's CUDA graph, as
the program counted them when it captured the graph (the kernel library's
``cudaGraphGetNodes`` over the graph being captured, kept by
``dca_tpu_torch/train/graphs.py`` as ``last_nodes["full"]`` and the
recorder's ``graphs.nodes`` counter): the in-program counterpart of
``step_kernels``.  None where no graph was captured (the CPU) or the
program keeps no such count."""


def read(ctx):
    try:
        from dca_tpu_torch.train import graphs
    except ImportError:
        return None
    nodes = getattr(graphs, "last_nodes", None) or {}
    n = nodes.get("full")
    return int(n) if n else None
