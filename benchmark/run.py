"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout on a machine with the cell's cards. It makes
the cell's inputs from the seed (``traffic.py``), sets the program up
(``planet.prime``) and warms it on the cell's own frames, then runs
frames back to back from the set-up's state, one host read of the frame's
diagnostics after each, returning to that state every cycle of the
traffic's ``cycle_frames`` frames, until the first whole cycle at which S
seconds have passed. With ``--trace 0`` it reports the cell's
end-to-end metrics; with ``--trace 1`` the same window times the
dispatch untraced, and a few more frames traced by ``torch.profiler``
give the per-layer metrics. Either way it then frees the program's state
and holds what the timed path produced against the configuration's plain
reference (``check.py``).

The last line of standard output is one JSON object: correct, attempted
and failed frames, the metrics, the device, with ``--trace 1`` the
breakdown of the traced window, the parts of set-up, and last the
compared numbers beside their limits, which are also the last lines of standard error. Without a
card, or with fewer than the cell asks for, it exits with code 2 and
prints no result; if JAX or the JAX package is loaded once the window has
closed, with code 3.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import sys
import tempfile
import time
import types

import numpy as np
import torch

from . import check, registry, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "planetmodel_sph_tpu")
WINDOW = "bench_window"


def process_age_s() -> float:
    """Seconds since this process started (from /proc, 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        after = f.read().rsplit(")", 1)[1].split()
    start = int(after[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def rate(frames: int, steps: int, n: int, wall_s: float) -> float:
    """Particle-steps a second over a window: all it completed over its
    wall."""
    return frames * steps * n / wall_s


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Sampler:
    """One frame drawn uniformly from all frames of a window by a
    generator seeded from the run's seed (a reservoir of one): ``kept`` is
    (fields at the frame's start, fields at its end)."""

    def __init__(self, seed: int):
        self.rng = random.Random(int(seed))
        self.seen = 0
        self.kept = None

    def offer(self, item):
        self.seen += 1
        if self.rng.randrange(self.seen) == 0:
            self.kept = item


class Window:
    """Frames back to back from the set-up's state `start`, to which the
    window returns every `cycle` frames, so that every window covers the
    same part of the trajectory however fast the program runs. Records
    each frame's wall (its call to the end of its host read) and its
    call's host span (call to return, before the read), and the failed
    frames: those whose structure overflow counters are not zero
    (interactions the program dropped) or whose energy is not finite."""

    def __init__(self, system, start, steps, cycle, sync):
        self.system, self.start, self.sync = system, start, sync
        self.steps, self.cycle = steps, cycle
        self.frame_s, self.call_s = [], []
        self.failed = 0
        self.wall_s = 0.0

    def run(self, seconds=None, frames=None, sampler=None, span=None):
        """Until `frames` frames, or the first whole cycle at which
        `seconds` have passed; returns the last state."""
        t0 = time.perf_counter()
        while True:
            if len(self.frame_s) % self.cycle == 0:
                state = self.start
            tf0 = time.perf_counter()
            prev = state
            if span is None:
                state, info = self.system.frame(state, self.steps)
            else:
                with span("frame_run"):
                    state, info = self.system.frame(state, self.steps)
            tc = time.perf_counter()
            d = self.system.read(state, info)
            tf1 = time.perf_counter()
            self.frame_s.append(tf1 - tf0)
            self.call_s.append(tc - tf0)
            if (d["nbr_overflow"] + d["tree_overflow"] > 0
                    or not math.isfinite(d["total_energy"])):
                self.failed += 1
            if sampler is not None:
                sampler.offer((self.system.fields(prev),
                               self.system.fields(state)))
            done = len(self.frame_s)
            if (seconds is not None and tf1 - t0 >= seconds
                    and done % self.cycle == 0):
                break
            if frames is not None and done >= frames:
                break
        self.sync()
        self.wall_s = time.perf_counter() - t0
        return state


def _n(state) -> int:
    pos = state["pos"] if isinstance(state, dict) else state.pos
    return int(pos.shape[0])


def work_per_step(cell, n: int, pairs: int) -> dict:
    """{kernel: (operations, bytes)} a step of every hand kernel whose
    count applies to this cell's configuration."""
    out = {}
    for name, mod in registry.kernels(cell.here).items():
        w = mod.work(cell.config["config"], n, pairs)
        if w is not None:
            out[name] = w
    return out


def _traced(system, start, steps, cycle, frames, sync, hand, on_card):
    """`frames` frames from the set-up's state under torch.profiler,
    inside one host span; returns (state, the window, the trace's
    summary)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    tw = Window(system, start, steps, cycle, sync)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            state = tw.run(frames=frames,
                           span=torch.profiler.record_function)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        summary = trace.summarise(trace.load(path), WINDOW, hand)
    summary["steps"] = len(tw.frame_s) * steps
    return state, tw, summary


class SetupClock:
    """The parts of set-up: seconds from process start to the clock's
    making (`first`), then the wall of each part marked."""

    def __init__(self, first: str):
        self.parts = {first: process_age_s()}
        self.t = time.perf_counter()

    def mark(self, name: str, sync=lambda: None) -> None:
        """The part `name` ends here, once `sync` has waited for the
        device."""
        sync()
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


def run(cell, seed: int, seconds: float, traced: bool, device,
        system=None, clock=None) -> dict:
    """One run of `cell`: the result, its compared numbers with their
    limits under ``checks``. `system`: what stands in the program's place
    (default: the port, ``program.Program``); `clock`: the set-up's clock,
    if the process started it before. A failed frame in the warm-up or
    after it makes the run not correct."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    clock = clock or SetupClock("process_start_to_run")
    if on_card:
        torch.zeros((), device=dev)
        clock.mark("device_start", sync)
    tr = cell.traffic
    steps, cycle = int(tr["frame_steps"]), int(tr["cycle_frames"])
    cfg = cell.config["config"]
    if system is None:
        from .program import Program
        system = Program(cell.config)
    clock.mark("program_import", sync)
    inputs = traffic.make_inputs(tr, cfg, seed, dev, cell.root)
    clock.mark("inputs", sync)
    start = system.start(inputs)
    start_fields = system.fields(start)
    clock.mark("prime", sync)
    warm = Window(system, start, steps, cycle, sync)
    warm.run(frames=int(tr["warmup_frames"]))
    clock.mark("warm_frames", sync)
    setup_s = process_age_s()
    log(f"set-up {setup_s:.2f} s (process start to the first timed frame): "
        + ", ".join(f"{k} {v:.3f}" for k, v in clock.parts.items()))

    sampler = Sampler(seed)
    win = Window(system, start, steps, cycle, sync)
    state = win.run(seconds=seconds, sampler=sampler)
    frames = len(win.frame_s)
    attempted, failed = frames, win.failed
    summary = None
    if traced:
        hand = [k.PATTERN for k in registry.kernels(cell.here).values()]
        state, tw, summary = _traced(system, start, steps, cycle,
                                     int(tr["trace_frames"]), sync, hand,
                                     on_card)
        attempted += len(tw.frame_s)
        failed += tw.failed
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    end_fields = system.fields(state)
    n = _n(state)

    warm_failed = warm.failed
    # the program's state goes before the reference runs
    del state, start, warm
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    nums, pairs = check.judge(cell.reference(), cfg, inputs, start_fields,
                              sampler.kept, end_fields, steps)
    correct, checks = check.verdict(nums, cell.limits)
    log(f"window {frames} frames in {win.wall_s:.3f} s; the reference's "
        f"check {time.perf_counter() - t_check:.2f} s")

    metrics, extra = {}, {}
    if not traced:
        values = {
            "particle_steps_per_s": rate(frames, steps, n, win.wall_s),
            "frame_ms_p95": 1e3 * percentile(win.frame_s, 95),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = types.SimpleNamespace(
            config=cfg, n=n, steps_per_frame=steps,
            trace=summary,
            untraced={"steps": frames * steps,
                      "call_s": sum(win.call_s), "wall_s": win.wall_s},
            work=work_per_step(cell, n, pairs),
            peaks=peaks(cell.here, device_kind(dev)))
        for m in cell.per_layer:
            v = cell.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra["breakdown"] = {
            "device_ops": trace.top(summary["by_op"]),
            "idle_gaps": trace.top(summary["gaps"])}
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": device_kind(dev),
        "count": int(cell.entry["chips"]),
        "memory_peak_bytes": int(memory_peak),
    }
    if traced:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    return {"correct": bool(correct and failed == 0 and warm_failed == 0),
            "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info, **extra,
            "setup_parts_s": clock.parts, "checks": checks}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_kind(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type


def peaks(here: str, kind: str):
    """The published peaks of the card `kind` (``peaks.json``), or None
    for a device it does not list."""
    table = registry.load_json(os.path.join(here, "peaks.json"))
    return table.get(kind)


def report(result: dict) -> None:
    """The result as the last line of standard output, after the
    compared numbers as the last lines of standard error."""
    for k, c in result["checks"].items():
        ok = c["limit"] is not None and c["value"] <= c["limit"]
        print(f"check {k} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the interpreter's start and the imports
    clock = SetupClock("process_start_to_main")
    cell = registry.cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    clock.mark("card_check")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                 clock=clock)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {found}", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
