"""The share of the traced sub-window in which no kernel, copy or set ran
on the device: one minus the union of their intervals over its length."""
from devtrace import busy_us


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr.device or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(tr.device) / tr.window_us)
