"""device: the share of the traced window (the host span around the
traced frames) in which no device op ran, in percent."""


def read(ctx):
    t = ctx.trace
    if not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
