"""k2_roofline: K2's share of its bound, in %: the sum of the bounds of the
slice's ``nll_bwd_kernel`` launches, each at the shape the epoch's
schedule gives it (``harness/trace.py::label_loss_launches``), over the
sum of their device times.  The bound is ``harness/arith.py``'s."""

from harness.arith import k2_bound_ms
from harness.trace import label_loss_launches


def read(ctx):
    if ctx.trace is None:
        return None
    with_pi = ctx.config["ae_type"].startswith("zinb")
    launches = [(rows, dur) for k, rows, dur in label_loss_launches(ctx.trace, ctx.schedule)
                if k == "K2"]
    spent = sum(dur for _, dur in launches)
    if not launches or spent <= 0:
        return None
    bound = sum(k2_bound_ms(rows, ctx.genes, with_pi) * 1e-3 for rows, _ in launches)
    return 100.0 * bound / spent
