"""Command-line harness of the port: `run` and `bench`.

Counterpart of ``planetmodel_sph_tpu/cli.py`` for the paths the port runs:
deterministic runs from a preset's initial conditions or a checkpoint,
diagnostics every N steps, metrics as JSON lines, checkpoint/resume, PNG
frames and a GIF, and the live browser viewer with its steering. Runs on the
card unless ``--device cpu`` is given.

    python -m planetmodel_sph_tpu_torch.cli run --preset jupiter_3k \\
        --steps 300 --diag-every 100
    python -m planetmodel_sph_tpu_torch.cli bench --n 3000 --steps 200

What the reference's CLI has and this one refuses by name: ``--platform``
(a JAX switch; ``--device cpu|cuda`` picks the device here). Checkpoints
are PSPH1 for a ``.psph`` path and npz otherwise, read and written as the
reference does (``utils/checkpoint.py``).

``--debug-nans`` stops the run with ``FloatingPointError`` at the end of
the first chunk (``--diag-every`` steps, or a frame) after which a field
of the state holds a NaN, naming the field, the step and the first op or
kernel that made a NaN (``utils/debug_nans.py``); no checkpoint is written
then. Without it a run does nothing of the kind.

    python -m planetmodel_sph_tpu_torch.cli run --debug-nans --steps 200

``--devices D`` (D > 1) runs the replicated data-parallel layout
(``parallel/dp.py``): the command starts D ranks of its own, one a card over
NCCL (D clamps to the visible cards, and says so), or D ranks on the CPU
over gloo with ``--device cpu``; rank 0 logs and writes the files.
``--set dp_mode=halo`` runs the halo layout (``parallel/halo.py``) the same
way; it refuses a ring that would collect some shard twice (2R >= D, so at
least 2 * halo_ring_radius + 1 ranks) before starting any rank.

    python -m planetmodel_sph_tpu_torch.cli run --device cpu --n 512 \\
        --devices 2 --steps 8 --diag-every 4

    python -m planetmodel_sph_tpu_torch.cli run --steps 200 \\
        --render-every 20 --animate run.gif --render final.png
    python -m planetmodel_sph_tpu_torch.cli run --steps 5000 --serve 8000

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
import os
import sys
import time

import torch

from . import bench as bench_mod
from . import config as config_mod
from .models import ics, planet
from .state import resolve_device, to_numpy
from .utils import checkpoint, debug_nans, diagnostics, render

_PRESETS = {name: getattr(config_mod, name) for name in bench_mod.PRESETS}
_ICS = ("jupiter", "two_planet_collision", "rotating_planet",
        "differentiated_planet")

# options of the reference's CLI that select something not ported: accepted
# by the parser so the refusal can name them
_UNPORTED = {
    "platform": "a JAX backend switch (--device cpu or --device cuda picks "
                "the device here)",
}
# what the data-parallel runner does not do (the reference's skips them)
_NOT_DP = ("render", "render_every", "animate", "serve")


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


def _refuse_unported_options(args):
    for name, what in _UNPORTED.items():
        v = getattr(args, name, None)
        if v is not None and v is not False:
            raise SystemExit(f"--{name.replace('_', '-')}: {what} is not "
                             "ported")


def _refuse_unported(args):
    if args.animate and not args.render_every:
        raise SystemExit("--animate assembles the frames of --render-every: "
                         "give both")
    if args.devices is not None and args.devices > 1:
        used = [f"--{k.replace('_', '-')}" for k in _NOT_DP
                if getattr(args, k) is not None]
        if used:
            raise SystemExit(f"--devices runs no {', '.join(used)}: the "
                             "data-parallel runner renders and serves "
                             "nothing")


def _viewer_control(viewer, cfg):
    """Apply the live viewer's steering between chunks: hold while paused
    (frames keep serving), fold the steered knobs into the config with
    ``cfg.replace`` (nothing is compiled again)."""

    def fold(c):
        paused, overrides, dirty = viewer.control()
        if dirty and overrides:
            c = c.replace(**overrides)
            _log(f"live knobs applied: {overrides}")
        return c, paused

    cfg, paused = fold(cfg)
    if paused:
        _log("paused from the live viewer")
        while paused:
            time.sleep(0.25)
            cfg, paused = fold(cfg)
        _log("resumed")
    return cfg


def _run_frames(args, state, cfg, start_step, viewer, t0, nan_check):
    """Frame-by-frame mode: chunks of --render-every (or --diag-every)
    steps, a PNG frame after each with --render-every, each pushed to the
    live viewer with --serve, whose steering is applied between chunks.
    Returns (state, cfg, [diagnostics per chunk], [step numbers])."""
    render_kw = dict(color_by=args.render_color_by,
                     quiver=args.render_quiver, extent=args.render_extent)
    if args.render_every:
        os.makedirs(args.render_every_dir, exist_ok=True)
    r_every = max(1, min(args.render_every or args.diag_every, args.steps))
    n_frames, rem = divmod(args.steps, r_every)
    diags_list, step_nos, cur = [], [], start_step
    for fi in range(n_frames + (1 if rem else 0)):
        k = r_every if fi < n_frames else rem
        state, d = planet.run_with_diagnostics(state, cfg, 1, k,
                                               nan_check=nan_check)
        cur += k
        diags_list.append(d)
        step_nos.append(cur)
        if args.render_every:
            render.render_png(state, os.path.join(
                args.render_every_dir, f"frame_{fi:05d}.png"), **render_kw)
        if viewer is not None:
            row = {k2: float(v[-1]) for k2, v in d.items()}
            row["step"] = cur
            row["steps_per_sec"] = (cur - start_step) / max(
                time.perf_counter() - t0, 1e-9)
            viewer.update(state, row, **render_kw)
            cfg = _viewer_control(viewer, cfg)
    if args.animate:
        out = render.assemble_gif(args.render_every_dir, args.animate,
                                  fps=args.animate_fps)
        _log(f"animation -> {out}")
    return state, cfg, diags_list, step_nos


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
        start_step = 0

    if args.metrics_jsonl and not args.restore:
        # fresh run: truncate, so unrelated runs never mix in one trail (a
        # resume keeps appending to its own)
        open(args.metrics_jsonl, "w").close()

    if args.devices is not None and args.devices > 1:
        return _run_dp(args, cfg, state, start_step, device)
    if not args.restore:
        state = planet.prime(state, cfg)

    viewer = None
    if args.serve is not None:
        from .utils.liveview import LiveViewer
        viewer = LiveViewer(args.serve)
        _log(f"live view -> http://127.0.0.1:{viewer.port}")

    # --debug-nans: every chunk checked at its end (utils/debug_nans.py)
    nan_check = (debug_nans.NaNCheck(start_step) if args.debug_nans
                 else debug_nans.unchecked)
    # run exactly --steps: full diag chunks plus a DIAGNOSED remainder chunk
    t0 = time.perf_counter()
    try:
        if args.render_every or viewer is not None:
            state, cfg, diags_list, step_nos = _run_frames(
                args, state, cfg, start_step, viewer, t0, nan_check)
        else:
            every = max(1, min(args.diag_every, args.steps))
            n_chunks, rem = divmod(args.steps, every)
            diags_list, step_nos = [], []
            if n_chunks:
                state, d = planet.run_with_diagnostics(
                    state, cfg, n_chunks, every, nan_check=nan_check)
                diags_list.append(d)
                step_nos.extend(start_step + (i + 1) * every
                                for i in range(n_chunks))
            if rem:
                state, d = planet.run_with_diagnostics(
                    state, cfg, 1, rem, nan_check=nan_check)
                diags_list.append(d)
                step_nos.append(start_step + args.steps)
    finally:
        if viewer is not None:
            viewer.close()
    cur = step_nos[-1]
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
    if args.render:
        blocks = cfg if (args.render_blocks
                         and cfg.neighbor_mode == "grid") else None
        if args.render_blocks and blocks is None:
            _log("--render-blocks needs the grid pipeline; overlay skipped")
        out = render.render_png(state, args.render,
                                color_by=args.render_color_by,
                                quiver=args.render_quiver,
                                extent=args.render_extent, blocks=blocks)
        _log(f"render -> {out}")
    for key in ("nbr_overflow", "tree_overflow"):
        if key in diags and int(diags[key].sum()) > 0:
            _log(f"WARNING: {key}={int(diags[key].sum())} interactions "
                 "dropped — raise the corresponding capacity")
    drift = diagnostics.energy_drift(diags)
    _log(f"energy drift: {float(drift[-1]):.3e}")
    return 0


def _run_dp(args, cfg, state, start_step, device) -> int:
    """The data-parallel run: D ranks of this command's own, each priming
    and stepping its shard (``parallel/dp.py``), rank 0 logging and writing
    the files."""
    from .parallel import mesh as mesh_mod
    n_dev = args.devices
    if device.type == "cuda":
        # one rank a card: the count clamps to the visible cards, as the
        # reference's clamps to its devices
        n_dev = min(args.devices, torch.cuda.device_count())
        if n_dev < args.devices:
            _log(f"--devices {args.devices}: {n_dev} card(s) visible, "
                 f"clamped to {n_dev}")
    if cfg.n % n_dev:
        _log(f"error: n={cfg.n} not divisible by {n_dev} devices")
        return 2
    if cfg.dp_mode == "halo":
        from .parallel import halo
        try:
            halo.check_config(cfg, n_dev)
        except ValueError as e:
            raise SystemExit(f"--set dp_mode=halo: {e}") from None
    mesh_mod.spawn(_dp_rank, n_dev, device=device.type,
                   args=(args, cfg, to_numpy(state), start_step))
    return 0


def _dp_rank(mesh, args, cfg, arrays, start_step):
    """One rank of :func:`_run_dp`."""
    from .parallel import dp, halo, mesh as mesh_mod
    from .state import from_numpy
    lead = mesh.rank == 0
    if lead:
        _log(f"dp mesh over {mesh.size} rank(s): {mesh.backend}, rank 0 on "
             f"{mesh.device}")
    state = mesh_mod.shard_state(from_numpy(arrays, device=mesh.device),
                                 mesh)
    if cfg.dp_mode == "halo":
        # sharded sources: Morton-range bricks, the ring halo exchange and
        # all-gathered far-chunk moments (parallel/halo.py)
        state = halo.morton_shard_state(state, mesh)
        state = halo.make_prime(cfg, mesh)(state)
        runner = halo.make_run_diag
    else:
        state = dp.make_prime(cfg, mesh)(state)
        runner = dp.make_run_diag
    # --debug-nans: every rank checks each chunk, the ranks decide together
    nan_check = (debug_nans.NaNCheck(start_step, axis=mesh)
                 if args.debug_nans else debug_nans.unchecked)
    runner = runner(cfg, mesh, nan_check=nan_check)

    # as the single path: full diag chunks plus a diagnosed remainder
    every = max(1, min(args.diag_every, args.steps))
    n_chunks, rem = divmod(args.steps, every)
    t0 = time.perf_counter()
    diags_list, step_nos = [], []
    if n_chunks:
        state, d = runner(state, n_chunks, every)
        diags_list.append(d)
        step_nos.extend(start_step + (i + 1) * every
                        for i in range(n_chunks))
    if rem:
        state, d = runner(state, 1, rem)
        diags_list.append(d)
        step_nos.append(start_step + args.steps)
    diags = {k: torch.cat([d[k] for d in diags_list]).cpu()
             for k in diags_list[0]}
    dt_wall = time.perf_counter() - t0
    total = args.steps
    full = mesh_mod.gather_state(state, mesh) if args.checkpoint else None
    if not lead:
        return
    _log(f"{total} steps in {dt_wall:.2f}s = {total/dt_wall:.1f} steps/s "
         f"(dp x{mesh.size})")
    for i, step_no in enumerate(step_nos):
        row = {k: float(v[i]) for k, v in sorted(diags.items())}
        _log(f"step {step_no}: total_energy={row['total_energy']:.5g} "
             f"neighbors_avg={row['neighbors_avg']:.4g}")
        if args.metrics_jsonl:
            with open(args.metrics_jsonl, "a") as f:
                f.write(json.dumps({"step": step_no, **row}) + "\n")
    if args.checkpoint:
        checkpoint.save(args.checkpoint, full, cfg, start_step + total)
        _log(f"checkpoint -> {args.checkpoint}")
    for key in ("nbr_overflow", "tree_overflow", "halo_violations"):
        tot = int(diags[key].sum()) if key in diags else 0
        if tot > 0:
            hint = ("re-shard with halo.morton_shard_state (particles "
                    "migrated bricks) or raise halo_ring_radius"
                    if key == "halo_violations" else "interactions dropped "
                    "— raise the corresponding capacity")
            _log(f"WARNING: {key}={tot} — {hint}")
    drift = diagnostics.energy_drift(diags)
    _log(f"energy drift: {float(drift[-1]):.3e}")


def cmd_bench(args) -> int:
    result = bench_mod.run_bench(
        n=args.n, steps=args.steps, preset=args.preset, device=args.device,
        overrides=config_mod.parse_overrides(args.set), ic=args.ic,
        ic_kw=bench_mod.ic_kwargs(args))
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="planetmodel_sph_tpu_torch")
    # refused by name in main (see _UNPORTED)
    p.add_argument("--platform", default=None, help=argparse.SUPPRESS)
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
    pr.add_argument("--render", default=None, help="write the final "
                    "state as a PNG")
    pr.add_argument("--render-every", type=int, default=None,
                    help="write a PNG frame every N steps")
    pr.add_argument("--render-every-dir", default="frames")
    pr.add_argument("--render-color-by", default="rho",
                    help="field to colour particles by, 'id' for stable "
                         "per-particle random colours or 'material'")
    pr.add_argument("--render-quiver", action="store_true",
                    help="overlay velocity arrows on a particle subsample")
    pr.add_argument("--render-extent", type=float, default=None,
                    help="fixed half-width of the view (stable framing "
                         "across frames)")
    pr.add_argument("--render-blocks", action="store_true",
                    help="overlay the Morton-block boxes of the neighbour "
                         "structure (grid pipeline)")
    pr.add_argument("--animate", default=None, metavar="GIF",
                    help="assemble the --render-every frames into a GIF "
                         "after the run")
    pr.add_argument("--animate-fps", type=float, default=10.0)
    pr.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="live browser viewer of the evolving state at "
                         "http://localhost:PORT (0: a free port), a frame "
                         "every --render-every (or --diag-every) steps, "
                         "with pause/resume and steered knobs")
    pr.add_argument("--devices", type=int, default=None,
                    help="data parallelism over D ranks (the replicated "
                         "layout): one a card, clamped to the visible "
                         "cards; D ranks on the CPU with --device cpu")
    pr.add_argument("--debug-nans", action="store_true",
                    help="stop at the end of the first chunk after which "
                         "the state holds a NaN, with a FloatingPointError "
                         "naming the field, the step and the first op or "
                         "kernel that made one (the reference's "
                         "jax_debug_nans; infinities are not checked)")
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
    _refuse_unported_options(args)
    try:
        return args.fn(args)
    except NotImplementedError as e:
        # an option outside the ported paths: name it, exit non-zero
        _log(f"error: {e}")
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
