"""Tiles decoded a verified image: the mean of the results' tiles_used
over the window."""


def read(ctx):
    used = ctx.get("tiles_used")
    if used is None or not len(used):
        return None
    return float(used.mean())
