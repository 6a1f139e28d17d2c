"""Host time of the ingest lane's stage function (the upload's pinned
staging and copy, the tile offsets, the ingest launch), less the spans
in which it waited for the card, ms per batch finished in the
recording: the program's ``stage.ingest`` spans."""
import spans


def read(ctx):
    return spans.host_ms_per_batch(ctx, "stage.ingest")
