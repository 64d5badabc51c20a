"""kernels: the least time of the cell's work a step (each hand kernel's
count under ``kernels/``, from the configuration and sizes and the
reference's pair count, at the card's published peaks) over the device
time a step of ALL device ops in the traced frames, in percent. Nothing
on a card without published peaks or without counted work."""

from benchmark.roofline import least_time


def read(ctx):
    t = ctx.trace
    if ctx.peaks is None or not ctx.work or not t["device_s"]:
        return None
    least = sum(least_time(ops, nbytes, ctx.peaks)
                for ops, nbytes in ctx.work.values())
    return 100.0 * least / (t["device_s"] / t["steps"])
