"""Time the host's threads spent waiting for the card to hand a tensor
back (the program's ``sync`` spans, on every thread), ms per batch
finished in the recording."""
import spans


def read(ctx):
    return spans.wait_ms_per_batch(ctx, "sync")
