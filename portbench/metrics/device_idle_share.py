"""device_idle_share: 1 - the union of the slice's kernel, copy and memset
intervals over the slice's length (device trace)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s
