"""The whole detection step's share of the rung's peak: one tile's
extractor operations per verified image times the window's images/s
(the end-to-end metric's own reading), over the peak.  Escalation's
extra tiles are work the user did not ask for and are not counted.  It
stands beside the kernels' rooflines: where a change takes a kernel off
the path and its roofline reads nothing, the step's share still reads."""
import flops


def read(ctx):
    peaks, ips = ctx.get("peaks"), ctx.get("images_per_s")
    if peaks is None or not ips:
        return None
    cfg = ctx["cfg"]
    ex = cfg["extractor"]
    per_image = flops.extractor_flops(
        1, cfg["tile"], channels=ex["channels"], depth=ex["depth"],
        n_bits=ex["n_bits"])
    return 100.0 * per_image * ips / peaks[cfg["decode_dtype"]]
