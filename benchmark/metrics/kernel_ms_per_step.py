"""kernels: device milliseconds a step of the hand kernels (the name
patterns under ``kernels/``), over the traced frames. Nothing when no
hand kernel ran."""

from benchmark.trace import HAND


def read(ctx):
    t = ctx.trace
    hand = t["by_category"].get(HAND, 0.0)
    if not t["steps"] or not hand:
        return None
    return 1e3 * hand / t["steps"]
