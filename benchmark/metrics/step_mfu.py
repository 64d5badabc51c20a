"""device: the whole step's share of the card's float32 peak: the counted
operations a step (every hand kernel's count under ``kernels/``) over the
untraced wall a step times the peak, in percent. It bounds every kernel's
share from above however the work is split between kernels."""


def read(ctx):
    u = ctx.untraced
    if ctx.peaks is None or not ctx.work or not u["steps"]:
        return None
    ops = sum(o for o, _ in ctx.work.values())
    return 100.0 * ops / (u["wall_s"] / u["steps"] * ctx.peaks["flops"])
