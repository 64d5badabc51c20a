"""Summarise a ``torch.profiler`` Chrome trace: the card's ops by self time
(PyTorch port of the root ``tools/trace_summary.py``, which read a JAX
xplane trace).

    python -m planetmodel_sph_tpu_torch.tools.trace_summary [TRACE] \\
        [--top N] [--by-category | --by-span]

TRACE is a ``trace.json`` (``utils/profiling.trace`` exports one; a
directory is searched for its newest ``*.json``). The device ops are the
trace's kernel, memcpy and memset events; a kernel's duration is its self
time (nothing nests on the card). It prints the total device self time,
then the top N device ops by self time, each with its occurrences, its
category and, where the trace has Python frames (``utils/profiling.trace``
records them), the port's source line that launched it
(the innermost frame of the package outside ``ops/cuda/``, so a hand
kernel is named at its wrapper's caller). ``--by-category`` prints ms and %
of each category instead: the hand kernels (the names of
``ops/cuda/launch.LAUNCHES``), gathers and index ops, copies, memcpy and
memset, sorts, reductions, elementwise and other; they sum to the total.
``--by-span`` prints the program's spans instead (``utils/profiling``: the
``psph.*`` host ranges of the thread that holds most of them, ``cpu_op``
or ``user_annotation`` events): for each name
its count, host ms (summed duration), self ms (the part no child span
covers) and idle ms (the device-idle time at which it was the innermost
open span), then the idle time outside every span and the time inside
any; the idle of the spans and outside them sum to the window's idle.
Last, the device's idle share over the traced window (from the first to
the last event of the trace, host or device): the share of the window in
which no device op ran. The profiler slows the host (Python frames most),
so that share overstates what an untraced run leaves idle; where
``tools.trace_run`` wrote the run's untraced time beside the trace
(``untraced.json``: its steps and warm ms a step), one more line gives the
idle share of the untraced run, 1 - busy / (steps x untraced ms a step),
the busy time taken from the trace (the profiler leaves device ops'
durations as they are).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")       # a program span is either
CATEGORIES = ("hand kernels", "gathers and index ops", "copies",
              "memcpy and memset", "sorts", "reductions", "elementwise",
              "other")
# name patterns of each category but the hand kernels, in the order they
# are tried (a name takes the first that matches)
_PATTERNS = (
    ("other", r"^nccl"),              # collectives, whatever they reduce
    ("memcpy and memset", r"^(memcpy|memset)"),
    ("sorts", r"sort|radix"),
    ("gathers and index ops", r"index|gather|scatter|take|embedding"),
    ("copies", r"copy|cat_?array|catarray|concat|transpose|permute"),
    ("reductions", r"reduce|scan|cumsum|argmax|argmin|norm_kernel"),
    ("elementwise", r"elementwise|pointwise|vectorized|unrolled|"
                    r"distribution|fill"),
)
# the untraced run's {"steps", "ms_per_step"}, beside the trace
UNTRACED = "untraced.json"
_SRC = re.compile(r"((?:planetmodel_sph_tpu_torch/)[\w/.]+\.py)\((\d+)\)")


def short_name(name):
    """A kernel's name without its return type, anonymous namespace and
    arguments."""
    return name.removeprefix("void ").replace("(anonymous namespace)::",
                                              "").split("(")[0]


def category(name, cat="kernel"):
    """The category of a device op by its event category and name."""
    from ..ops.cuda import launch
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memcpy and memset"
    base = short_name(name)
    if any(base.startswith(k) for k in launch.LAUNCHES):
        return "hand kernels"
    low = base.lower()
    for label, pat in _PATTERNS:
        if re.search(pat, low):
            return label
    return "other"


def trace_file(path):
    """The trace file at `path`, or the newest ``*.json`` under it."""
    if os.path.isfile(path):
        return path
    files = [f for f in glob.glob(os.path.join(path, "**", "*.json"),
                                  recursive=True)
             if os.path.basename(f) != UNTRACED]
    if not files:
        sys.exit(f"no Chrome trace (*.json) under {path}")
    return max(files, key=os.path.getmtime)


def load(path):
    """The trace's complete events ("ph": "X")."""
    with open(trace_file(path)) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _sources(events):
    """{correlation id: 'path.py:line'} of each launch whose host thread
    has Python frames of the package around it (innermost frame outside
    ops/cuda/)."""
    by_thread = {}
    for e in events:
        if e.get("cat") in ("python_function", "cuda_runtime"):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = {}
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []                    # open python frames: (end, source)
        for e in evs:
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            if e.get("cat") == "python_function":
                m = _SRC.search(e.get("name", ""))
                src = (f"{m.group(1).split('planetmodel_sph_tpu_torch/')[1]}"
                       f":{m.group(2)}") if m else None
                if src and src.startswith("ops/cuda/"):
                    src = None
                stack.append((e["ts"] + e["dur"], src))
                continue
            corr = (e.get("args") or {}).get("correlation")
            src = next((s for _, s in reversed(stack) if s), None)
            if corr is not None and src:
                out[corr] = src
    return out


def summarise(events):
    """(ops, total_us, busy_us, window_us): ops {name: dict(us, occ,
    category, source)} over the device events, the sum of their self
    times, the union of their intervals and the trace's span."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    srcs = _sources(events)
    ops = {}
    for e in dev:
        name = e.get("name", "")
        op = ops.setdefault(name, dict(us=0.0, occ=0, sources={},
                                       category=category(name, e["cat"])))
        op["us"] += float(e["dur"])
        op["occ"] += 1
        src = srcs.get((e.get("args") or {}).get("correlation"))
        if src:
            op["sources"][src] = op["sources"].get(src, 0) + 1
    for op in ops.values():
        s = op.pop("sources")
        op["source"] = max(s, key=s.get) if s else ""
    total = sum(op["us"] for op in ops.values())
    busy, end = 0.0, None
    for e in sorted(dev, key=lambda e: e["ts"]):
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    window = 0.0
    if events:
        window = (max(float(e["ts"]) + float(e["dur"]) for e in events)
                  - min(float(e["ts"]) for e in events))
    return ops, total, busy, window


def _idle(events, w0, w1):
    """The device-idle intervals of [w0, w1], sorted and disjoint."""
    gaps, t = [], w0
    for e in sorted((e for e in events if e.get("cat") in DEVICE_CATS),
                    key=lambda e: float(e["ts"])):
        t0 = max(w0, float(e["ts"]))
        t1 = min(w1, float(e["ts"]) + float(e["dur"]))
        if t1 <= t0:
            continue
        if t0 > t:
            gaps.append((t, t0))
        t = max(t, t1)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _span_segments(spans, w0, w1):
    """The window cut where spans open and close: (t0, t1, innermost span's
    name or None) in time order, and {name: [count, host us]}. `spans`:
    (t0, t1, name) sorted by start then longest first; a span that
    outlasts the span around it is cut at its end."""
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


def by_span(events):
    """(spans, outside_us, program_us) of the program's spans over the
    trace's window (its first to its last event) on the thread holding
    most of them: spans {name: dict(count, host_us, self_us, idle_us)},
    the device-idle time inside no span and the time inside any."""
    from ..utils.profiling import PREFIX
    if not events:
        return {}, 0.0, 0.0
    mine = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("name", "").startswith(PREFIX)]
    w0 = min(float(e["ts"]) for e in events)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    idle = _idle(events, w0, w1)
    if not mine:
        return {}, sum(b - a for a, b in idle), 0.0
    threads = {}
    for e in mine:
        key = (e.get("pid"), e.get("tid"))
        threads[key] = threads.get(key, 0) + 1
    thread = max(threads, key=threads.get)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in mine
                    if (e.get("pid"), e.get("tid")) == thread),
                   key=lambda s: (s[0], -s[1]))
    segs, stats = _span_segments([s for s in spans if s[1] > s[0]], w0, w1)
    self_us = dict.fromkeys(stats, 0.0)
    idle_us = dict.fromkeys(list(stats) + [None], 0.0)
    k = 0
    for a, b, name in segs:
        if b <= a:
            continue
        if name is not None:
            self_us[name] += b - a
        while k < len(idle) and idle[k][1] <= a:
            k += 1
        j = k
        while j < len(idle) and idle[j][0] < b:
            idle_us[name] += min(b, idle[j][1]) - max(a, idle[j][0])
            j += 1
    outside = sum(b - a for a, b, name in segs if name is None)
    table = {n: dict(count=c, host_us=h, self_us=self_us[n],
                     idle_us=idle_us[n]) for n, (c, h) in stats.items()}
    return table, idle_us[None], (w1 - w0) - outside


def untraced(path):
    """The untraced run's {"steps", "ms_per_step"} written beside the
    trace at `path`, or None."""
    side = os.path.join(os.path.dirname(trace_file(path)), UNTRACED)
    if not os.path.exists(side):
        return None
    with open(side) as f:
        return json.load(f)


def by_category(ops):
    """{category: us} over every category, largest first."""
    agg = dict.fromkeys(CATEGORIES, 0.0)
    for op in ops.values():
        agg[op["category"]] += op["us"]
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    from ..utils.profiling import default_logdir
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", nargs="?", default=default_logdir(),
                    help="a trace.json, or a directory holding one")
    ap.add_argument("--top", type=int, default=30)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--by-category", action="store_true")
    mode.add_argument("--by-span", action="store_true",
                      help="the program's spans (psph.*) and the device's "
                           "idle time put down to them")
    args = ap.parse_args(argv)

    events = load(args.trace)
    ops, total, busy, window = summarise(events)
    print(f"total device self time: {total/1e3:.3f} ms over {len(ops)} ops",
          flush=True)
    if args.by_category:
        for c, us in by_category(ops).items():
            share = 100 * us / total if total else 0.0
            print(f"{us/1e3:10.3f} ms  {share:5.1f}%  {c}")
    elif args.by_span:
        spans, outside, program = by_span(events)
        print(f"{'count':>7} {'host ms':>10} {'self ms':>10} "
              f"{'idle ms':>10}  span")
        for name, r in sorted(spans.items(),
                              key=lambda kv: -kv[1]["host_us"]):
            print(f"{r['count']:7d} {r['host_us']/1e3:10.3f} "
                  f"{r['self_us']/1e3:10.3f} {r['idle_us']/1e3:10.3f}  "
                  f"{name}")
        print(f"device idle outside the program's spans "
              f"{outside/1e3:.3f} ms; the program's spans hold "
              f"{program/1e3:.3f} ms of the host", flush=True)
    else:
        print(f"{'self ms':>9} {'%':>5} {'occ':>5}  {'category':21} "
              f"{'op':28} source")
        ranked = sorted(ops.items(), key=lambda kv: -kv[1]["us"])
        for name, op in ranked[:args.top]:
            share = 100 * op["us"] / total if total else 0.0
            short = short_name(name).removeprefix("at::native::")
            print(f"{op['us']/1e3:9.3f} {share:5.1f} {op['occ']:5d}  "
                  f"{op['category'][:21]:21} {short[:28]:28} "
                  f"{op['source']}")
    idle = 100 * (1 - busy / window) if window else 100.0
    print(f"device idle {idle:.1f}% of the traced window ({busy/1e3:.3f} "
          f"ms busy of {window/1e3:.3f} ms)", flush=True)
    run = untraced(args.trace)
    if run is not None:
        wall = run["steps"] * run["ms_per_step"] * 1e3
        idle = 100 * (1 - busy / wall) if wall else 100.0
        print(f"device idle {idle:.1f}% of the untraced run ({busy/1e3:.3f} "
              f"ms busy of {run['steps']} steps at {run['ms_per_step']:.4f} "
              "ms a step untraced)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
