"""The 95th percentile of the window's batch latencies (yield to
``on_result``, host clock) over the batches that came back before the
profiler started, so that it holds no batch the profiler slowed: how
long a shard of a scan waits for its verdicts.  The host's lanes set
it, and it repeats too loosely from run to run to be bounded end to
end."""
import numpy as np


def read(ctx):
    ms = ctx.get("batch_ms")
    if not ms:
        return None
    return float(np.percentile(np.asarray(ms, dtype=float), 95))
