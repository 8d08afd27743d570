"""optim_gb_per_s: the RMSprop update's rate, in GB/s: the bytes of the
slice's ``rmsprop_kernel`` launches (the port's K5, one a step for every
64 leaves) over the sum of their device times.  A launch reads the
parameter, gradient and accumulator and writes the parameter and
accumulator of each element of its leaves once: 20 bytes an element.  The
leaves are counted from the configuration's widths: a kernel and a bias
for each dense layer (``arith.dense_widths``), and a BatchNorm offset for
each hidden layer where ``batchnorm``.  A rate and not a share of the HBM
rate: the update's 13-18 MB at Paul15's widths stay in the 50 MB L2
between steps, where it outruns the HBM rate (PERF.md).  None where no
such launch ran (a program without K5)."""

from harness.arith import dense_widths
from harness.cell import head_names

BYTES_PER_ELEMENT = 20
MAX_LEAVES = 64  # leaves a launch (dca_tpu_torch/csrc/fused_optim.cu)


def leaves(config, genes):
    """The elements of each leaf the update writes, in no order."""
    hidden = config["hidden_size"]
    out = []
    for i, o in dense_widths(genes, hidden, len(head_names(config))):
        out += [i * o, o]
    if config.get("batchnorm"):
        out += list(hidden)
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    spent = [dur for _, _, dur, _ in ctx.trace.kernels("rmsprop_kernel")]
    if not spent or sum(spent) <= 0:
        return None
    sizes = leaves(ctx.config, ctx.genes)
    steps = len(spent) / -(-len(sizes) // MAX_LEAVES)
    return 1e-9 * steps * BYTES_PER_ELEMENT * sum(sizes) / sum(spent)
