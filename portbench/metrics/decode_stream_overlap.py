"""The share of the decode kernels' device time during which a decode
kernel on another CUDA stream also ran (the lanes' horizontal fusion)."""
from devtrace import overlap_share

from metrics.decode_roofline import decode_events


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    share = overlap_share(decode_events(tr))
    return None if share is None else 100.0 * share
