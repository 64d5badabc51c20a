"""Reduction of a ``torch.profiler`` Chrome trace to what the per-layer
metrics read: device time by op and by category, busy time and idle gaps
inside the traced window, each gap named by what the host was running.

The device ops are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. The window is the host span the harness opened
around the traced frames (a ``record_function``). The categories besides
the hand kernels (whose name patterns live in ``kernels/``) follow the
order of the program's own trace summary: a name takes the first pattern
that matches.
"""

from __future__ import annotations

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
HAND = "hand kernels"
_PATTERNS = (
    ("other", r"^nccl"),
    ("memcpy and memset", r"^(memcpy|memset)"),
    ("sorts", r"sort|radix"),
    ("gathers and index ops", r"index|gather|scatter|take|embedding"),
    ("copies", r"copy|cat_?array|catarray|concat|transpose|permute"),
    ("reductions", r"reduce|scan|cumsum|argmax|argmin|norm_kernel"),
    ("elementwise", r"elementwise|pointwise|vectorized|unrolled|"
                    r"distribution|fill"),
)


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    base = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return base.split("(")[0].split("<")[0]


def category(name: str, cat: str, hand_patterns) -> str:
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memcpy and memset"
    base = short_name(name)
    if any(re.search(p, base) for p in hand_patterns):
        return HAND
    low = base.lower()
    for label, pat in _PATTERNS:
        if re.search(pat, low):
            return label
    return "other"


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def summarise(events: list, window: str, hand_patterns) -> dict:
    """{window_s, busy_s, device_s, by_op {name: s}, by_category {cat: s},
    gaps {host op: idle s}} over the window named `window`."""
    spans = [e for e in events if e.get("name") == window
             and e.get("cat") in HOST_CATS]
    if not spans:
        raise ValueError(f"no host span {window!r} in the trace")
    span = max(spans, key=lambda e: float(e["dur"]))
    w0, w1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
    by_op, by_cat, ivals = {}, {}, []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0 = max(w0, float(e["ts"]))
        t1 = min(w1, float(e["ts"]) + float(e["dur"]))
        if t1 <= t0:
            continue
        name = short_name(e.get("name", ""))
        by_op[name] = by_op.get(name, 0.0) + (t1 - t0)
        c = category(e.get("name", ""), e["cat"], hand_patterns)
        by_cat[c] = by_cat.get(c, 0.0) + (t1 - t0)
        ivals.append((t0, t1))
    busy = _union(ivals)
    gaps, t = [], w0
    for t0, t1 in busy:
        if t0 > t:
            gaps.append((t, t0))
        t = max(t, t1)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "")) for e in events
                   if e.get("cat") in HOST_CATS
                   and e.get("tid") == span.get("tid")
                   and e is not span),
                  key=lambda x: (x[0], -x[1]))
    named = {}
    stack, k = [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while k < len(host) and host[k][0] <= mid:
            stack.append(host[k])
            k += 1
        stack = [h for h in stack if h[1] > mid]
        label = stack[-1][2] if stack else "host outside any op"
        named[label] = named.get(label, 0.0) + (g1 - g0)
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": sum(t1 - t0 for t0, t1 in busy) * us,
        "device_s": sum(by_op.values()) * us,
        "by_op": {k: v * us for k, v in by_op.items()},
        "by_category": {k: v * us for k, v in by_cat.items()},
        "gaps": {k: v * us for k, v in named.items()},
    }


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
