"""sweeps (PyTorch glue): device milliseconds a step of every device op
that is not a hand kernel (gathers and index ops, copies, elementwise,
sorts, reductions, memcpy and memset), over the traced frames."""

from benchmark.trace import HAND


def read(ctx):
    t = ctx.trace
    if not t["steps"] or not t["device_s"]:
        return None
    return 1e3 * (t["device_s"] - t["by_category"].get(HAND, 0.0)) \
        / t["steps"]
