"""Command-line harness of the port: `run` and `bench`.

Counterpart of ``planetmodel_sph_tpu/cli.py`` for the paths the port runs:
deterministic runs from a preset's initial conditions or a checkpoint,
diagnostics every N steps, metrics as JSON lines, checkpoint/resume. Runs
on the card unless ``--device cpu`` is given.

    python -m planetmodel_sph_tpu_torch.cli run --preset jupiter_3k \\
        --steps 300 --diag-every 100
    python -m planetmodel_sph_tpu_torch.cli bench --n 3000 --steps 200

What the reference's CLI has and this one refuses by name: rendering and
the live viewer, and ``--devices`` (data parallelism). Checkpoints are
PSPH1 for a ``.psph`` path and npz otherwise, read and written as the
reference does (``utils/checkpoint.py``).

    python -m planetmodel_sph_tpu_torch.cli run --preset parity --steps 100
    python -m planetmodel_sph_tpu_torch.cli run --preset auto --n 50000 \\
        --av 1.0 --balsara --steps 64 --diag-every 32    # grid + tree
    python -m planetmodel_sph_tpu_torch.cli run --preset basalt_impact \\
        --ic two_planet_collision --materials basalt,ice \\
        --separation 2e7 --approach-speed 3e5 --steps 100  # Tillotson impact
    python -m planetmodel_sph_tpu_torch.cli run --eos adiabatic --av 1.0 \\
        --steps 100                      # the evolved internal energy

``--neighbor grid --gravity tree`` on the default preset runs too; its
window capacities (``--set nbr_window=...``, ``p2p_window``, ``m2p_window``)
are the caller's to size, and a run that drops interactions says so.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import bench as bench_mod
from . import config as config_mod
from .models import ics, planet
from .state import resolve_device
from .utils import checkpoint, diagnostics

_PRESETS = {name: getattr(config_mod, name) for name in bench_mod.PRESETS}
_ICS = ("jupiter", "two_planet_collision", "rotating_planet",
        "differentiated_planet")

# options of the reference's CLI that select something not ported: accepted
# by the parser so the refusal can name them
_UNPORTED = {
    "render": "rendering", "render_every": "rendering",
    "animate": "rendering", "serve": "the live viewer",
    "devices": "data parallelism over several devices",
    "debug_nans": "a JAX debugging switch",
}


def _make_ic(args, cfg, device):
    mats = bench_mod.parse_materials(args.materials)
    if mats and args.ic not in ("two_planet_collision",
                                "differentiated_planet"):
        raise SystemExit("--materials goes with --ic two_planet_collision "
                         "(body A, body B) or differentiated_planet (core, "
                         "mantle)")
    if args.ic == "rotating_planet":
        return ics.rotating_planet(cfg, omega=args.omega, device=device)
    if args.ic == "two_planet_collision":
        return ics.two_planet_collision(
            cfg, separation=args.separation,
            approach_speed=args.approach_speed,
            impact_parameter=args.impact_parameter, materials=mats,
            device=device)
    if args.ic == "differentiated_planet":
        kw = dict(zip(("core_material", "mantle_material"), mats or ()))
        return ics.differentiated_planet(cfg, device=device, **kw)
    return getattr(ics, args.ic)(cfg, device=device)


def _build_cfg(args) -> config_mod.SimConfig:
    kw = {}
    for name in ("n", "seed", "dt"):
        v = getattr(args, name)
        if v is not None:
            kw[name] = v
    if args.integrator:
        kw["integrator"] = args.integrator
    if args.gravity:
        kw["gravity_solver"] = args.gravity
    if args.neighbor:
        kw["neighbor_mode"] = args.neighbor
    if args.freeze_velocity:
        kw["freeze_velocity"] = True
    if args.av:
        kw["av_alpha"] = args.av
        kw["av_beta"] = 2.0 * args.av
    if args.balsara:
        kw["av_balsara"] = True
    if args.eos:
        kw["eos_mode"] = args.eos
    kw.update(config_mod.parse_overrides(args.set))
    return _PRESETS[args.preset](**kw)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _refuse_unported(args):
    for name, what in _UNPORTED.items():
        v = getattr(args, name, None)
        if v is not None and v is not False:
            raise SystemExit(f"--{name.replace('_', '-')}: {what} is not "
                             "ported")


def cmd_run(args) -> int:
    _refuse_unported(args)
    device = resolve_device(args.device)
    if args.restore:
        state, cfg, start_step = checkpoint.load(args.restore,
                                                 device=device)
        _log(f"restored {args.restore} at step {start_step} (n={cfg.n})")
    else:
        try:
            cfg = _build_cfg(args)
            config_mod.check_slice(cfg)
            state = _make_ic(args, cfg, device)
        except ValueError as e:
            # a configuration or initial condition that contradicts itself:
            # name it, exit non-zero
            _log(f"error: {e}")
            return 2
        state = planet.prime(state, cfg)
        start_step = 0

    if args.metrics_jsonl and not args.restore:
        # fresh run: truncate, so unrelated runs never mix in one trail (a
        # resume keeps appending to its own)
        open(args.metrics_jsonl, "w").close()

    # run exactly --steps: full diag chunks plus a DIAGNOSED remainder chunk
    t0 = time.perf_counter()
    every = max(1, min(args.diag_every, args.steps))
    n_chunks, rem = divmod(args.steps, every)
    diags_list, step_nos = [], []
    cur = start_step
    if n_chunks:
        state, d = planet.run_with_diagnostics(state, cfg, n_chunks, every)
        diags_list.append(d)
        step_nos.extend(start_step + (i + 1) * every
                        for i in range(n_chunks))
        cur = start_step + n_chunks * every
    if rem:
        state, d = planet.run_with_diagnostics(state, cfg, 1, rem)
        cur += rem
        diags_list.append(d)
        step_nos.append(cur)
    diags = {k: torch.cat([d[k] for d in diags_list]).cpu()
             for k in diags_list[0]}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt_wall = time.perf_counter() - t0
    total = cur - start_step
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    _log(f"{total} steps in {dt_wall:.2f}s = {total/dt_wall:.1f} steps/s "
         f"({cfg.n*total/dt_wall:.3g} particle-steps/s) on {where}")

    for i, step_no in enumerate(step_nos):
        row = {k: float(v[i]) for k, v in sorted(diags.items())}
        keys = ("total_energy", "kinetic_energy", "rho_avg", "rho_max",
                "neighbors_avg", "radius_rms", "momentum_mag")
        brief = " ".join(f"{k}={row[k]:.5g}" for k in keys if k in row)
        _log(f"step {step_no}: {brief}")
        if args.metrics_jsonl:
            with open(args.metrics_jsonl, "a") as f:
                f.write(json.dumps({"step": step_no, **row}) + "\n")

    if args.checkpoint:
        checkpoint.save(args.checkpoint, state, cfg, start_step + total)
        _log(f"checkpoint -> {args.checkpoint}")
    for key in ("nbr_overflow", "tree_overflow"):
        if key in diags and int(diags[key].sum()) > 0:
            _log(f"WARNING: {key}={int(diags[key].sum())} interactions "
                 "dropped — raise the corresponding capacity")
    drift = diagnostics.energy_drift(diags)
    _log(f"energy drift: {float(drift[-1]):.3e}")
    return 0


def cmd_bench(args) -> int:
    result = bench_mod.run_bench(
        n=args.n, steps=args.steps, preset=args.preset, device=args.device,
        overrides=config_mod.parse_overrides(args.set), ic=args.ic,
        ic_kw=bench_mod.ic_kwargs(args))
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="planetmodel_sph_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run a simulation")
    pr.add_argument("--preset", choices=sorted(_PRESETS),
                    default="jupiter_3k")
    pr.add_argument("--ic", choices=sorted(_ICS), default="jupiter")
    pr.add_argument("--n", type=int, default=None)
    pr.add_argument("--seed", type=int, default=None)
    pr.add_argument("--dt", type=float, default=None)
    pr.add_argument("--steps", type=int, default=500)
    pr.add_argument("--diag-every", type=int, default=100)
    pr.add_argument("--integrator",
                    choices=("staggered_euler", "leapfrog_kdk"), default=None)
    pr.add_argument("--gravity", choices=("direct", "tree", "none"),
                    default=None)
    pr.add_argument("--neighbor", choices=("dense", "grid"), default=None)
    pr.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    pr.add_argument("--checkpoint", default=None,
                    help="save the final state: PSPH1 for a .psph path, "
                         "else npz")
    pr.add_argument("--restore", default=None,
                    help="resume from a checkpoint, PSPH1 or npz (its own "
                         "config)")
    pr.add_argument("--metrics-jsonl", default=None)
    pr.add_argument("--omega", type=float, default=0.05,
                    help="solid-body angular velocity for rotating_planet")
    pr.add_argument("--separation", type=float, default=150.0,
                    help="two_planet_collision: initial center separation")
    pr.add_argument("--approach-speed", type=float, default=0.5,
                    help="two_planet_collision: closing bulk speed")
    pr.add_argument("--impact-parameter", type=float, default=0.0,
                    help="two_planet_collision: transverse offset")
    pr.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="generic SimConfig override (repeatable), e.g. "
                         "--set softening_mode=receiver_h")
    pr.add_argument("--av", type=float, default=None, metavar="ALPHA",
                    help="Monaghan artificial viscosity with this alpha "
                         "(beta=2*alpha), fused into pass 2")
    pr.add_argument("--balsara", action="store_true",
                    help="Balsara (1995) AV limiter")
    pr.add_argument("--eos", choices=("polytropic", "adiabatic",
                                      "tillotson"), default=None,
                    help="equation of state; adiabatic and tillotson evolve "
                         "the internal energy")
    pr.add_argument("--materials", default=None, metavar="A,B",
                    help="Tillotson materials: the two bodies of "
                         "two_planet_collision, or core,mantle of "
                         "differentiated_planet (e.g. basalt,ice)")
    pr.add_argument("--freeze-velocity", action="store_true",
                    help="compute fields but never apply accelerations")
    # refused by name in cmd_run (see _UNPORTED)
    for flag in ("--render", "--render-every", "--animate"):
        pr.add_argument(flag, default=None, help=argparse.SUPPRESS)
    pr.add_argument("--serve", type=int, default=None,
                    help=argparse.SUPPRESS)
    pr.add_argument("--devices", type=int, default=None,
                    help=argparse.SUPPRESS)
    pr.add_argument("--debug-nans", action="store_true",
                    help=argparse.SUPPRESS)
    pr.set_defaults(fn=cmd_run)

    pb = sub.add_parser("bench", help="benchmark steps/sec from a cold "
                                      "start")
    pb.add_argument("--n", type=int, default=3000)
    pb.add_argument("--steps", type=int, default=100)
    pb.add_argument("--preset", choices=sorted(_PRESETS),
                    default="jupiter_3k")
    pb.add_argument("--device", default="cuda")
    pb.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="generic SimConfig override (repeatable)")
    bench_mod.add_ic_arguments(pb)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except NotImplementedError as e:
        # an option outside the ported paths: name it, exit non-zero
        _log(f"error: {e}")
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
