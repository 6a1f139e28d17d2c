"""Device time of host-to-device copies in the traced sub-window, per
batch whose result came back inside it."""


def read(ctx):
    tr, n = ctx.get("trace"), ctx.get("batches_traced")
    if tr is None or not n:
        return None
    copies = [e.dur for e in tr.device if "HtoD" in e.name]
    if not copies:
        return None
    return sum(copies) / 1e3 / n
