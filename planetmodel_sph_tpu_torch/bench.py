"""Steps/s of the cached production step from a settled checkpoint
(PyTorch port of ``planetmodel_sph_tpu.bench.run_bench``).

The timed region ends in ``torch.cuda.synchronize()`` so it measures the
device's work, not the enqueue, and the result names the device it ran on.

    python -m planetmodel_sph_tpu_torch.bench --repeat 3

prints the card's name and power limit, then one JSON line per repeat.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch

from .models import planet
from .runtime import snapshot

REFERENCE_PARTICLE_STEPS_PER_SEC = 3000 * 50.0
SETTLED = "docs/results/drift100k_r5ship/state.psph"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_times(prof, top=12):
    """Device time (s) by kernel name from a torch.profiler run, largest
    first, and their sum (one stream: the sum is the busy time). Only the
    device-side events count: a host op's device time repeats its
    kernels'."""
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.removeprefix("void ").split("(")[0]
        t = ev.self_device_time_total * 1e-6
        by_name[name] = by_name.get(name, 0.0) + t
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return busy, dict(ranked)


def run_bench(checkpoint_path: str = SETTLED, steps: int = 64,
              warmup_steps: int = 64, device="cuda",
              profile: bool = False) -> dict:
    """Load the settled checkpoint with its own config and time `steps`
    steps of ``planet.run_info`` after `warmup_steps` untimed steps (the
    reference warms up with the same step count). `profile`: trace the
    timed run with torch.profiler and add the device's busy time, its idle
    share of that same run's wall, and the largest device times by kernel
    (the trace slows the host, so the wall time of a profiled run is not
    the step rate)."""
    state, cfg, _ = snapshot.load(checkpoint_path, device=device)
    dev = state.pos.device
    if profile and dev.type != "cuda":
        raise ValueError("profile=True reads the card's kernel times: it "
                         "needs device='cuda'")
    if warmup_steps:
        state = planet.run(state, cfg, warmup_steps)
    _sync(dev)
    tracer = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile
        else contextlib.nullcontext())
    with tracer as prof:
        t0 = time.perf_counter()
        state, info = planet.run_info(state, cfg, steps)
        _sync(dev)
        wall = time.perf_counter() - t0
    extra = {}
    if profile:
        busy, ranked = _device_times(prof)
        extra = {"profiled": True, "device_busy_s": busy,
                 "device_idle_share": 1.0 - busy / wall,
                 "device_s_by_kernel": ranked}
    sps = steps / wall
    return extra | {
        "overflow": {k: int(v) for k, v in info.items()},
        "metric": f"particle_steps_per_sec_n{cfg.n}",
        "value": cfg.n * sps,
        "unit": "particle-steps/s",
        "vs_baseline": cfg.n * sps / REFERENCE_PARTICLE_STEPS_PER_SEC,
        "steps_per_sec": sps,
        "n": cfg.n,
        "wall_s": wall,
        "operating_point": "settled",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=SETTLED)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--warmup-steps", type=int, default=64)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="one more run under torch.profiler: device busy "
                    "time and the largest device times by kernel")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    for _ in range(args.repeat):
        print(json.dumps(run_bench(args.checkpoint, args.steps,
                                   args.warmup_steps, args.device)),
              flush=True)
    if args.profile:
        print(json.dumps(run_bench(args.checkpoint, args.steps,
                                   args.warmup_steps, args.device,
                                   profile=True)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
