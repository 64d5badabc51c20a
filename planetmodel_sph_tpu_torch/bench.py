"""Steps/s of the port (``planetmodel_sph_tpu.bench.run_bench`` in PyTorch).

Two operating points, as the reference has: a cold start from a preset's
initial conditions (the early transient of the collapsing ball), or a
settled checkpoint with the config in its header. The timed region ends in
``torch.cuda.synchronize()`` so it measures the device's work, not the
enqueue, and the result names the device it ran on.

    python -m planetmodel_sph_tpu_torch.bench --preset jupiter_3k --n 3000 \\
        --steps 200
    python -m planetmodel_sph_tpu_torch.bench --repeat 3      # settled 100k

prints the card's name and power limit, then one JSON line per repeat.

`vs_baseline` divides by 150,000 particle-steps/s: the rate the Unity
project this system was modelled on targets on a gaming laptop (3000
particles at its fixed 50 steps/s). It is not a rate of any accelerator.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch

from . import config as config_mod
from .models import ics, planet
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


PRESETS = ("default", "jupiter_3k", "jupiter_100k")


def run_bench(checkpoint_path: str | None = SETTLED, steps: int = 64,
              warmup_steps: int | None = None, device="cuda",
              profile: bool = False, preset: str | None = None,
              n: int | None = None) -> dict:
    """Time `steps` steps of ``planet.run_info`` after `warmup_steps`
    untimed steps (default: the same count, as the reference warms up).

    With `preset` the run is a cold start: the preset's config (at `n`
    particles when given), ``ics.jupiter`` and ``planet.prime``. Otherwise
    `checkpoint_path` is loaded with its own config. `profile`: trace the
    timed run with torch.profiler and add the device's busy time, its idle
    share of that same run's wall, and the largest device times by kernel
    (the trace slows the host, so the wall time of a profiled run is not
    the step rate)."""
    if preset is not None:
        if preset not in PRESETS:
            raise ValueError(f"preset={preset!r}: one of {PRESETS}")
        preset_fn = getattr(config_mod, preset)
        cfg = preset_fn(n=n) if n else preset_fn()
        state = planet.prime(ics.jupiter(cfg, device=device), cfg)
        operating_point = "early_transient"
    else:
        state, cfg, _ = snapshot.load(checkpoint_path, device=device)
        operating_point = "settled"
    if warmup_steps is None:
        warmup_steps = steps
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
        "operating_point": operating_point,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=SETTLED)
    ap.add_argument("--preset", choices=PRESETS, default=None,
                    help="cold start from this preset's initial conditions "
                    "instead of the settled checkpoint")
    ap.add_argument("--n", type=int, default=None,
                    help="particle count of the cold start")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--warmup-steps", type=int, default=None)
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
    kw = dict(checkpoint_path=args.checkpoint, steps=args.steps,
              warmup_steps=args.warmup_steps, device=args.device,
              preset=args.preset, n=args.n)
    for _ in range(args.repeat):
        print(json.dumps(run_bench(**kw)), flush=True)
    if args.profile:
        print(json.dumps(run_bench(profile=True, **kw)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
