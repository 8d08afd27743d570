"""step_kernels: the device kernels in the traced slice over the training
steps in it, a step counted by its loss backward (K2,
``nll_bwd_kernel``)."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    steps = len(tr.kernels("nll_bwd_kernel"))
    if steps == 0:
        return None
    return len(tr.kernels()) / steps
