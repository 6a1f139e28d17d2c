"""The decode's least time over its traced device time, for the tiles it
decoded.  A decode call is the kernels of one CUDA stream up to and
including its head kernel, which runs one block a tile; the first call
of each stream (which may have begun before the trace) and kernels after
a stream's last head are left out.  Least time: ``flops.least_seconds``
at the rung's peak."""
import collections

import flops

# the decode's CUDA kernels at every rung and schedule
KERNELS = ("conv_regtile_kernel", "gap_corr_regtile_kernel", "head_kernel",
           "conv_imma_kernel", "gap_corr_imma_kernel", "conv_blocked_kernel",
           "conv_blocked_imma_kernel")
HEAD = "head_kernel"


def decode_events(tr):
    return [e for e in tr.device if any(k in e.name for k in KERNELS)]


def calls(tr):
    """[(tiles, device us)] of the whole decode calls in the trace."""
    by_stream = collections.defaultdict(list)
    for e in decode_events(tr):
        by_stream[e.stream].append(e)
    out = []
    for evs in by_stream.values():
        us, first = 0.0, True
        for e in sorted(evs, key=lambda e: e.ts):
            us += e.dur
            if HEAD in e.name:
                if not first and e.grid:
                    n = 1
                    for g in e.grid:
                        n *= g
                    out.append((n, us))
                us, first = 0.0, False
    return out


def read(ctx):
    tr, peaks = ctx.get("trace"), ctx.get("peaks")
    if tr is None or peaks is None:
        return None
    done = calls(tr)
    us = sum(u for _, u in done)
    if not done or us <= 0:
        return None
    cfg = ctx["cfg"]
    least = sum(flops.least_seconds(n, cfg["tile"], cfg["extractor"],
                                    cfg["decode_dtype"], peaks)
                for n, _ in done)
    return 100.0 * least / (us / 1e6)
