"""Host time of escalation on the rs lanes (the decision after round
1, the plan, each round's gathers, launches and RS), less the spans in
which it waited for the card, ms per batch finished in the recording:
the program's ``escalate`` spans."""
import spans


def read(ctx):
    return spans.host_ms_per_batch(ctx, "escalate")
