"""Reduction of the program's own spans in a ``torch.profiler`` Chrome
trace: for each span name its count, its host time, its self time and the
device-idle time put down to it.

The program's spans are the host ranges it opens while a profiler
records: events named ``psph.*`` (``cpu_op`` from PyTorch's fast record
function, ``user_annotation`` from ``record_function``), on the thread
that runs it (the window's thread), nested by time. Each instant of
the window belongs to the innermost program span open at it, or to no
span; the window's device-idle time is put down the same way, so the idle
of every span and the idle outside them sum to the window's idle time.
:func:`reduce` takes the window, its thread and its idle intervals as
``trace.summarise`` finds them. ``tools/trace_summary.py --by-span`` in
the program's package reduces a trace the same way, over the whole trace.
"""

from __future__ import annotations

PREFIX = "psph."
CATS = ("cpu_op", "user_annotation")


def _segments(spans, w0, w1):
    """The window cut where spans open and close: (t0, t1, innermost span's
    name or None) in time order, and {name: [count, host]}. `spans`:
    (t0, t1, name) clipped to the window, sorted by start then longest
    first; a span that outlasts the span around it is cut at its end."""
    segs, stack, stats = [], [], {}
    t_out = w0                     # where the time outside every span resumes

    def close(t):
        nonlocal t_out
        while stack and stack[-1][1] <= t:
            name, end, cursor = stack.pop()
            segs.append((cursor, end, name))
            if stack:
                stack[-1][2] = end
            else:
                t_out = end

    for t0, t1, name in spans:
        close(t0)
        if stack:
            t1 = min(t1, stack[-1][1])
            segs.append((stack[-1][2], t0, stack[-1][0]))
        else:
            segs.append((t_out, t0, None))
        stack.append([name, t1, t0])
        st = stats.setdefault(name, [0, 0.0])
        st[0] += 1
        st[1] += t1 - t0
    close(float("inf"))
    segs.append((t_out, w1, None))
    return segs, stats


def reduce(events, w0: float, w1: float, tid, idle) -> dict:
    """{by_name {name: {count, host_s, self_s, idle_s}}, outside_s,
    program_host_s} over the window [w0, w1] (the trace's microseconds) of
    the `psph.*` spans on thread `tid`. `idle`: the window's device-idle
    intervals, sorted and disjoint. ``host_s``: the summed duration;
    ``self_s``: the part no child span covers; ``idle_s``: the idle time
    at which the span is the innermost open; ``outside_s``: the idle time
    inside no program span; ``program_host_s``: the time inside any."""
    spans = sorted(((max(w0, float(e["ts"])),
                     min(w1, float(e["ts"]) + float(e["dur"])), e["name"])
                    for e in events
                    if e.get("cat") in CATS and e.get("tid") == tid
                    and e.get("name", "").startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    spans = [s for s in spans if s[1] > s[0]]
    segs, stats = _segments(spans, w0, w1)
    self_t = dict.fromkeys(stats, 0.0)
    idle_t = dict.fromkeys(list(stats) + [None], 0.0)
    k = 0
    for a, b, name in segs:
        if b <= a:
            continue
        if name is not None:
            self_t[name] += b - a
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        j = k
        while j < len(idle) and idle[j][0] < b:
            idle_t[name] += min(b, idle[j][1]) - max(a, idle[j][0])
            j += 1
    us = 1e-6
    outside = sum(b - a for a, b, name in segs if name is None)
    return {
        "by_name": {n: {"count": c, "host_s": h * us,
                        "self_s": self_t[n] * us, "idle_s": idle_t[n] * us}
                    for n, (c, h) in stats.items()},
        "outside_s": idle_t[None] * us,
        "program_host_s": ((w1 - w0) - outside) * us,
    }
