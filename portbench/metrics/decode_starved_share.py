"""The share of the decode lanes' time in the recording that they spent
waiting for input (the program's ``lane.wait_in`` spans on the threads
that ran ``stage.decode``): how often the card's main work had nothing
handed to it."""
import spans


def read(ctx):
    return spans.starved_share(ctx, "decode")
