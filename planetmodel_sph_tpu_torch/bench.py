"""Steps/s of the port (``planetmodel_sph_tpu.bench.run_bench`` in PyTorch).

Two operating points, as the reference has: a cold start from a preset's
initial conditions (the early transient of the collapsing ball), or a
settled checkpoint with the config in its header. The timed region ends in
``torch.cuda.synchronize()`` so it measures the device's work, not the
enqueue, and the result names the device it ran on.

    python -m planetmodel_sph_tpu_torch.bench --preset jupiter_3k --n 3000 \\
        --steps 200
    python -m planetmodel_sph_tpu_torch.bench --repeat 3      # settled 100k
    python -m planetmodel_sph_tpu_torch.bench --set grad_p_mode=symmetric \\
        --set h_mode=relax --set fuse_p2p_sph=false \\
        --set fuse_p2p_residual=false --set p2p_window=256 \\
        --set m2p_window=256             # the settled state, another config
    python -m planetmodel_sph_tpu_torch.bench --preset basalt_impact \\
        --ic two_planet_collision --materials basalt,ice \\
        --separation 2e7 --approach-speed 3e5 --steps 100  # Tillotson impact

prints the card's name and power limit, then one JSON line per repeat.

    python -m planetmodel_sph_tpu_torch.bench --lines

prints the two lines of the repository's benchmark and nothing else: a
cold ``jupiter_3k`` start (n = 3000, 200 steps) and the settled 100k state
(64 steps, metric ``particle_steps_per_sec_n100000``), each a JSON object
that also names the card and its power limit. A run that fails prints a
line with value 0 and its error in its place; the other line still
prints, and the exit code is 1.

`vs_baseline` divides by 150,000 particle-steps/s: the rate the Unity
project this system was modelled on targets on a gaming laptop (3000
particles at its fixed 50 steps/s). It is not a rate of any accelerator.
Line 2 of ``--lines`` divides by the north star's 6,000,000 instead (60
steps/s at n = 100,000): 1.0 meets it.
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
from .ops import eos as eos_ops
from .state import resolve_device
from .utils import checkpoint

REFERENCE_PARTICLE_STEPS_PER_SEC = 3000 * 50.0
NORTH_STAR_PARTICLE_STEPS_PER_SEC = 100_000 * 60.0
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


PRESETS = ("auto", "basalt_impact", "default", "jupiter_3k", "jupiter_100k",
           "parity")
ICS = ("jupiter", "polytrope", "two_planet_collision",
       "differentiated_planet")


def add_ic_arguments(ap) -> None:
    """The cold start's initial conditions and their parameters."""
    ap.add_argument("--ic", choices=ICS, default="jupiter",
                    help="initial conditions of the cold start")
    ap.add_argument("--materials", default=None, metavar="A,B",
                    help="Tillotson materials: the two bodies of "
                    "two_planet_collision, or core,mantle of "
                    "differentiated_planet")
    ap.add_argument("--separation", type=float, default=None,
                    help="two_planet_collision: initial centre separation")
    ap.add_argument("--approach-speed", type=float, default=None,
                    help="two_planet_collision: closing bulk speed")


def parse_materials(text):
    """``--materials A,B`` as a pair of names, or None."""
    if not text:
        return None
    mats = tuple(text.split(","))
    if len(mats) != 2:
        raise SystemExit("--materials wants two comma-separated names, "
                         "e.g. basalt,ice")
    return mats


def ic_kwargs(args) -> dict:
    """Keyword arguments of the chosen initial conditions from parsed
    :func:`add_ic_arguments` options."""
    kw = {}
    mats = parse_materials(args.materials)
    if args.ic == "two_planet_collision":
        if mats:
            kw["materials"] = mats
        if args.separation is not None:
            kw["separation"] = args.separation
        if args.approach_speed is not None:
            kw["approach_speed"] = args.approach_speed
    elif args.ic == "differentiated_planet" and mats:
        kw.update(core_material=mats[0], mantle_material=mats[1])
    return kw


def with_thermal_state(state, stored_cfg, cfg):
    """`state` as a run under `cfg` starts from it. A run under the
    polytropic EOS never updates u (a state stored by one carries its
    initial conditions' u): when `cfg` evolves the internal energy and
    `stored_cfg` did not, u starts from the polytropic relation at the
    stored density, which with gamma = 2 is the same pressure."""
    if cfg.evolves_u and not stored_cfg.evolves_u:
        return state.replace(u=eos_ops.internal_energy(
            state.rho, stored_cfg.eos_k, stored_cfg.eos_gamma))
    return state


def run_bench(checkpoint_path: str | None = SETTLED, steps: int = 64,
              warmup_steps: int | None = None, device="cuda",
              profile: bool = False, preset: str | None = None,
              n: int | None = None, overrides: dict | None = None,
              ic: str = "jupiter", ic_kw: dict | None = None) -> dict:
    """Time `steps` steps of ``planet.run_info`` after `warmup_steps`
    untimed steps (default: the same count, as the reference warms up).

    With `preset` the run is a cold start: the preset's config (at `n`
    particles when given), the initial conditions `ic` (one of ``ICS``,
    with the keyword arguments `ic_kw`) and ``planet.prime``. Otherwise
    `checkpoint_path` is loaded with its own config. `overrides` replace
    SimConfig fields of either; a loaded state is then primed again, so
    its force fields are the new configuration's (and its internal energy
    starts from the polytropic relation when the overrides switch the
    evolved energy on: :func:`with_thermal_state`). `profile`: trace the
    timed run with torch.profiler and add the device's busy time, its idle
    share of that same run's wall, and the largest device times by kernel
    (the trace slows the host, so the wall time of a profiled run is not
    the step rate)."""
    if preset is not None:
        if preset not in PRESETS:
            raise ValueError(f"preset={preset!r}: one of {PRESETS}")
        preset_fn = getattr(config_mod, preset)
        kw = dict(overrides or {})
        if n:
            kw["n"] = n
        cfg = preset_fn(**kw)
        config_mod.check_slice(cfg)
        if ic not in ICS:
            raise ValueError(f"ic={ic!r}: one of {ICS}")
        state = planet.prime(
            getattr(ics, ic)(cfg, device=device, **(ic_kw or {})), cfg)
        operating_point = "early_transient"
    else:
        state, cfg, _ = checkpoint.load(checkpoint_path, device=device)
        if overrides:
            stored, cfg = cfg, cfg.replace(**overrides)
            config_mod.check_slice(cfg)
            state = planet.prime(
                with_thermal_state(state, stored, cfg),
                cfg.replace(rebuild_every=1, respa_every=1))
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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def bench_lines(device="cuda", card: str | None = None) -> list:
    """The two benchmark lines: a cold ``jupiter_3k`` start at n = 3000
    for 200 steps, and the settled 100k state for 64 steps (``vs_baseline``
    over the north star's rate). A run that raises gives a line with value
    0 and its error in its place."""
    runs = (("particle_steps_per_sec_n3000",
             dict(preset="jupiter_3k", n=3000, steps=200)),
            ("particle_steps_per_sec_n100000",
             dict(checkpoint_path=SETTLED, steps=64)))
    lines = []
    for metric, kw in runs:
        try:
            line = run_bench(device=device, **kw)
            if kw.get("checkpoint_path"):
                line["vs_baseline"] = (line["value"]
                                       / NORTH_STAR_PARTICLE_STEPS_PER_SEC)
        except Exception as e:  # noqa: BLE001 -- every line prints
            line = {"metric": metric, "value": 0.0,
                    "unit": "particle-steps/s", "vs_baseline": 0.0,
                    "error": f"{type(e).__name__}: {e}"[:300]}
        line["metric"] = metric
        if card is not None:
            line["card"] = card
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=SETTLED)
    ap.add_argument("--preset", choices=PRESETS, default=None,
                    help="cold start from this preset's initial conditions "
                    "instead of the settled checkpoint")
    ap.add_argument("--n", type=int, default=None,
                    help="particle count of the cold start")
    add_ic_arguments(ap)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--warmup-steps", type=int, default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="SimConfig override (repeatable), applied to the "
                    "preset's or the checkpoint's config")
    ap.add_argument("--profile", action="store_true",
                    help="one more run under torch.profiler: device busy "
                    "time and the largest device times by kernel")
    ap.add_argument("--lines", action="store_true",
                    help="the two benchmark lines (cold jupiter_3k, the "
                    "settled 100k state) and nothing else")
    args = ap.parse_args(argv)
    card = None
    if resolve_device(args.device).type == "cuda":
        card = card_line()
    if args.lines:
        lines = bench_lines(args.device, card)
        for line in lines:
            print(json.dumps(line), flush=True)
        return 1 if any("error" in line for line in lines) else 0
    if card is not None:
        print(card, flush=True)
    kw = dict(checkpoint_path=args.checkpoint, steps=args.steps,
              warmup_steps=args.warmup_steps, device=args.device,
              preset=args.preset, n=args.n,
              overrides=config_mod.parse_overrides(args.set), ic=args.ic,
              ic_kw=ic_kwargs(args))
    for _ in range(args.repeat):
        print(json.dumps(run_bench(**kw)), flush=True)
    if args.profile:
        print(json.dumps(run_bench(profile=True, **kw)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
