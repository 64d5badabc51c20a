"""runner: host milliseconds a step that the frame's call takes to return
(``run_info``, before the frame's host read), over the untraced window of
a traced run (the profiler slows the host). The benchmark's own span."""


def read(ctx):
    u = ctx.untraced
    if not u["steps"]:
        return None
    return 1e3 * u["call_s"] / u["steps"]
