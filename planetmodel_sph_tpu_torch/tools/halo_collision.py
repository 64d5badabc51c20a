"""Two-cluster collision on 8 ranks, halo layout (PyTorch port of the root
``tools/halo_collision.py``).

A two-planet collision migrates particles across Morton bricks by
construction (the approach compresses two bricks into one), so it
exercises the failure mode the automatic re-sharding loop
(``halo.run_resharded``) exists for. Protocol:

0. settle one n/2 polytrope ball (damped, mild viscosity, a conservative
   cadence), in this process on one device, or load it from --ball-ck
   (``tools.settle_ball``); the two bodies are copies of it;
1. 64 steps from the primed two-body state in both layouts, replicated
   (``dp.make_run_info``) and halo (``halo.make_run``), in 8-step segments
   with their counters; then each replicated particle is paired with its
   nearest halo particle (the halo layout Morton-sorts and the state has
   no id field). The pairing is one-way, as the reference's: a halo
   particle may be chosen by several replicated ones, and
   ``pair_duplicates`` counts the halo particles chosen more than once;
2. --steps steps through approach and impact under ``halo.run_resharded``,
   a row of conservation diagnostics a segment appended to
   ``<out>/metrics.jsonl``; re-shards and accepted violations counted.

The ranks are processes started by ``parallel.mesh.spawn``: with
``--device cuda:0`` (the default) 8 gloo ranks share one card, with
``--device cuda`` 8 cards take one rank each over NCCL, with ``--device
cpu`` 8 gloo ranks run on the CPU. ``<out>/summary.json`` holds the
reference's summary plus the overflow counts, ``pair_duplicates``, the
legs' walls and the kernel launches of each leg summed over the ranks.
Exit 0 when leg 1 matches (|dpos| p99 <= 1e-3 scale and |dvel| p99 <=
1e-2), 2 when not, 3 on an overflowing settle, 4 on a ball of the wrong
size, 5 on a non-finite leg 1.

    python -m planetmodel_sph_tpu_torch.tools.halo_collision --n 32768 \\
        --ball-ck out/halo_ball.psph --out out/halo32k
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import config as config_mod
from ..models import ics, planet
from ..ops.cuda import launch
from ..state import from_numpy, resolve_device, to_numpy
from ..utils import checkpoint, diagnostics

RANKS = 8
LEG1_SEGMENTS, LEG1_STEPS = 8, 8     # leg 1: 8 segments of 8 steps


def build_cfg(n):
    """The production formulation (jupiter_100k's stack) at 32k scale on
    the halo layout, field for field the reference's: radius ~ n^(1/3)
    keeps spacing, h and window occupancy n-invariant (a small-n smoke
    validates the 32k sizing); refine without truncation
    (sph_refined_window=0); windows 768/512/512 in nbr_sub=16 units; ring
    radius 3 of 8 shards, the smallest that keeps the pre-collision state
    ring-coherent (each 4-shard ball's bricks meet at its core)."""
    return config_mod.default(
        n=n, radius=16.0 * (n / 32768) ** (1.0 / 3.0),
        particle_radius=3.2, block_n=128,
        neighbor_mode="grid", gravity_solver="tree",
        nbr_group_size=64, nbr_group_level=4,
        grad_p_mode="grad_h", h_mode="newton", h_track_margin=0.04,
        sph_refine_subblock=True, sph_refined_window=0,
        rebuild_every=8, sort_every=16, respa_every=4,
        multipole_order=2, theta=1.0, grav_com_correction=True,
        nbr_window=768, p2p_window=512, m2p_window=512,
        av_alpha=1.0, av_beta=2.0,
        dp_mode="halo", halo_ring_radius=3, halo_chunk=16)


def settle_cfg(cfg, nb, mult=3):
    """Leg-0 settle config for one n/2 ball (shared with settle_ball):
    damped, mild viscosity, RESPA off, a rebuild every 4 steps, and every
    window widened by `mult` for the raw IC's early transient."""
    bcfg = cfg.replace(n=nb, total_mass=cfg.total_mass / 2)
    return bcfg.replace(vel_damping=0.1, av_alpha=0.5, av_beta=1.0,
                        respa_every=1, rebuild_every=4,
                        nbr_window=bcfg.nbr_window * mult,
                        p2p_window=bcfg.p2p_window * mult,
                        m2p_window=bcfg.m2p_window * mult)


def finite(state) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in vars(state).values()
               if torch.is_tensor(v) and v.is_floating_point())


def two_body(ball, separation, approach_speed, offset_y=4.0):
    """Two copies of `ball` `separation` apart along x (offset `offset_y`
    in y), approaching at `approach_speed`."""
    dx = torch.tensor([separation / 2, offset_y, 0.0], dtype=ball.pos.dtype,
                      device=ball.pos.device)
    dv = torch.tensor([approach_speed / 2, 0.0, 0.0], dtype=ball.vel.dtype,
                      device=ball.vel.device)
    a = ball.replace(pos=ball.pos - dx, vel=ball.vel + dv)
    b = ball.replace(pos=ball.pos + dx, vel=ball.vel - dv)
    return type(ball)(**{k: torch.cat([getattr(a, k), getattr(b, k)])
                         for k in vars(ball)})


def settle_or_load(cfg, n, ball_ck, dev, log=print):
    """Leg 0: (ball, rc): the n/2 ball from `ball_ck`, or settled here
    (400 steps at the settle windows); rc is not 0 when it cannot serve."""
    nb = n // 2
    if ball_ck:
        ball, _, _ = checkpoint.load(ball_ck, device=dev)
        if ball.n != nb:
            log(f"ball checkpoint has n={ball.n}, need {nb}")
            return None, 4
        log(f"leg0 ball loaded from {ball_ck}")
        return ball, 0
    scfg = settle_cfg(cfg, nb)
    ball = planet.prime(ics.polytrope(scfg, device=dev), scfg)
    ball, sinfo = planet.run_info(ball, scfg, 400)
    sover = (int(sinfo["nbr_overflow"]), int(sinfo["tree_overflow"]))
    log(f"leg0 settled ball: over={sover}")
    if sum(sover):
        log("leg0 OVERFLOW: settle windows too small for this n — "
            "aborting rather than validating from a corrupted ball")
        return None, 3
    return ball, 0


class Launches:
    """Kernel launches of this process by leg: the counters' growth over
    each call made through :meth:`call`."""

    def __init__(self):
        self.by_leg = {}

    def call(self, leg, fn, *a, **kw):
        before = dict(launch.LAUNCHES)
        out = fn(*a, **kw)
        acc = self.by_leg.setdefault(leg, dict.fromkeys(before, 0))
        for k, v in launch.LAUNCHES.items():
            acc[k] += v - before[k]
        return out

    def summed(self, mesh, legs):
        """{leg: {kernel: launches summed over the ranks}} (collective)."""
        from ..parallel import mesh as mesh_mod
        names = list(launch.LAUNCHES)
        t = torch.tensor([[self.by_leg.get(leg, {}).get(k, 0) for k in names]
                          for leg in legs], dtype=torch.int64,
                         device=mesh.device)
        t = mesh_mod.psum(t, mesh).cpu()
        return {leg: dict(zip(names, map(int, t[i])))
                for i, leg in enumerate(legs)}


def record_first_calls(path):
    """Save, to `path`, the (args, kwargs) of the first call of each
    hand-written windowed kernel made while the returned context is
    entered (the kernels' inputs on the halo layout's first evaluation,
    to hold each against its plain version)."""
    import contextlib
    from ..ops.cuda import groups2 as gk2

    @contextlib.contextmanager
    def ctx():
        rec, orig = {}, {k: getattr(gk2, k) for k in gk2.KERNELS}

        def spy(name, fn):
            def call(*a, **kw):
                if name not in rec:
                    rec[name] = (a, kw)
                return fn(*a, **kw)
            return call
        for k, fn in orig.items():
            setattr(gk2, k, spy(k, fn))
        try:
            yield rec
        finally:
            for k, fn in orig.items():
                setattr(gk2, k, fn)
            torch.save(rec, path)
    return ctx()


def widened(cfg, widen: float):
    """`cfg` with its three windows times `widen` (capacities only: where
    nothing overflows the sums are the same), rounded up to 16."""
    if widen == 1.0:
        return cfg
    r16 = lambda v: -(-int(v * widen) // 16) * 16
    return cfg.replace(nbr_window=r16(cfg.nbr_window),
                       p2p_window=r16(cfg.p2p_window),
                       m2p_window=r16(cfg.m2p_window))


def halo_occupancy(state, cfg, mesh):
    """{window: (mean over the ranks of the mean, max)} of a halo-layout
    build of each rank's shard over its [local | ring] sources at
    effectively unbounded windows (refine off: the pre-refine adjacency),
    in the windows' units (collective)."""
    from ..ops import structure
    from ..parallel import halo, mesh as mesh_mod
    wcfg = cfg.replace(nbr_window=4096, p2p_window=4096, m2p_window=4096,
                       sph_refine_subblock=False)
    collect = lambda x: halo._ring_collect(x, mesh, wcfg.halo_ring_radius)
    st = structure.build(state.pos, state.h, state.mass, wcfg,
                         src=(collect(state.pos), collect(state.h),
                              collect(state.mass)), target_offset=0)
    out = {}
    for k in ("sph", "p2p", "m2p"):
        v = getattr(st, f"n_{k}")
        out[k] = (float(mesh_mod.psum(v.float().mean(), mesh)) / mesh.size,
                  int(mesh_mod.pmax(v.amax(), mesh)))
    return out


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def _rank(mesh, opts, arrays, cfg):
    """One rank of legs 1 and 2 (see the module docstring); rank 0 logs
    and writes the files."""
    import contextlib
    from ..parallel import dp, halo, mesh as mesh_mod
    entered = time.time() - opts["t_spawn"]      # before any CUDA work
    lead = mesh.rank == 0
    log = (lambda m: print(m, flush=True)) if lead else (lambda m: None)
    out_dir = opts["out"]
    jsonl = os.path.join(out_dir, "metrics.jsonl")
    counts = Launches()
    dev = mesh.device

    def sync():
        mesh_mod.psum(torch.zeros((), device=dev), mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def all_finite(s):
        bad = torch.tensor(0 if finite(s) else 1, device=dev)
        return int(mesh_mod.psum(bad, mesh)) == 0

    stages = ("imported", "entered", "device", "group")
    stamps = [mesh_mod.STARTUP.get(k, 0.0) - opts["t_spawn"] for k in stages]
    t = torch.tensor(stamps + [entered, time.time() - opts["t_spawn"]],
                     dtype=torch.float64, device=dev)
    up = dict(zip(stages + ("function", "collective"),
                  mesh_mod.pmax(t, mesh).tolist()))
    log(f"{mesh.size} ranks up ({mesh.backend} on {dev}), the last rank "
        "at each stage, s after the spawn: "
        + ", ".join(f"{k} {v:.1f}" for k, v in up.items()))

    # ---- leg 1: halo against replicated dp over a 64-step span ----
    state = from_numpy(arrays, device=dev)
    rep_cfg = cfg.replace(dp_mode="replicated")
    rep_out = mesh_mod.shard_state(state, mesh)
    del state
    hal = halo.morton_shard_state(rep_out, mesh)
    hal_out = hal
    rrun = dp.make_run_info(rep_cfg, mesh)
    hrun = halo.make_run(cfg, mesh)
    over = {"leg1_replicated": [0, 0], "leg1_halo": [0, 0]}
    hal_info = None
    sync()
    t0 = time.perf_counter()
    for seg in range(opts["leg1_segments"]):
        rep_out, rep_info = counts.call("leg1_replicated", rrun, rep_out,
                                        LEG1_STEPS)
        rec = contextlib.nullcontext()
        if seg == 0 and lead and opts.get("record_inputs"):
            rec = record_first_calls(opts["record_inputs"])
        with rec:
            hal_out, hal_info = counts.call("leg1_halo", hrun, hal_out,
                                            LEG1_STEPS)
        rf, hf = all_finite(rep_out), all_finite(hal_out)
        for leg, i in (("leg1_replicated", rep_info),
                       ("leg1_halo", hal_info)):
            over[leg][0] += int(i["nbr_overflow"])
            over[leg][1] += int(i["tree_overflow"])
        log(f"leg1 seg {seg}: rep finite={rf} "
            f"over=({int(rep_info['nbr_overflow'])},"
            f"{int(rep_info['tree_overflow'])})  halo finite={hf} "
            f"over=({int(hal_info['nbr_overflow'])},"
            f"{int(hal_info['tree_overflow'])}) "
            f"viol={int(hal_info['halo_violations'])}")
        if not (rf and hf):
            log("leg1 NON-FINITE — aborting before pairing")
            if lead:
                _write(os.path.join(out_dir, "status.json"), {"rc": 5})
            return
    sync()
    leg1_wall = time.perf_counter() - t0
    rep_full = mesh_mod.gather_state(rep_out, mesh)
    hal_full = mesh_mod.gather_state(hal_out, mesh)
    match = None
    pairing = {}
    if lead:
        # same particles, different order: pair each replicated particle
        # with its nearest halo particle (one-way, as the reference; the
        # duplicates are counted)
        from scipy.spatial import cKDTree
        rp, hp = rep_full.pos.cpu().numpy(), hal_full.pos.cpu().numpy()
        rv, hv = rep_full.vel.cpu().numpy(), hal_full.vel.cpu().numpy()
        dist, hi = cKDTree(hp).query(rp, k=1)
        scale = float(np.max(np.abs(rp)))
        # the error is localized by construction (Morton strays whose near
        # field the non-ring monopoles approximate): gate on the 99th
        # percentile, report the max and the affected fraction
        dpos_p99 = float(np.percentile(dist, 99))
        dpos_max = float(np.max(dist))
        dvel = np.abs(rv - hv[hi]).max(axis=1)
        dvel_p99, dvel_max = float(np.percentile(dvel, 99)), \
            float(dvel.max())
        frac_off = float(np.mean(dist > 1e-3 * scale))
        dup = int((np.bincount(hi, minlength=len(hp)) > 1).sum())
        match = dpos_p99 <= 1e-3 * scale and dvel_p99 <= 1e-2
        pairing = dict(dpos_p99=dpos_p99, dpos_max=dpos_max,
                       dvel_p99=dvel_p99, dvel_max=dvel_max,
                       frac_off=frac_off, scale=scale, pair_duplicates=dup)
        log(f"leg1 match-vs-replicated: |dpos| p99={dpos_p99:.3g} "
            f"max={dpos_max:.3g} (scale {scale:.3g}) "
            f"|dvel| p99={dvel_p99:.3g} max={dvel_max:.3g} "
            f"frac>1e-3scale={frac_off:.4f} "
            f"halo_viol={int(hal_info['halo_violations'])} "
            f"pair_duplicates={dup} [{'PASS' if match else 'FAIL'}]")
    del rep_full, hal_full, rep_out, hal_out

    # ---- leg 2: through the impact, re-sharding automatically ----
    sync()
    t0 = time.perf_counter()
    rows = []

    def on_segment(s, done, info):
        d = {k2: float(v) for k2, v in diagnostics.measure(
            mesh_mod.gather_state(s, mesh), cfg).items()}
        d.update(step=done, halo_violations=int(info["halo_violations"]),
                 nbr_overflow=int(info["nbr_overflow"]),
                 tree_overflow=int(info["tree_overflow"]),
                 wall_s=round(time.perf_counter() - t0, 1))
        rows.append(d)
        if lead:
            with open(jsonl, "a") as f:
                f.write(json.dumps(d) + "\n")
        log(f"step {done}: E={d['total_energy']:.6g} "
            f"|p|={d['momentum_mag']:.3g} viol={d['halo_violations']} "
            f"over=({d['nbr_overflow']},{d['tree_overflow']})")

    cfg2 = widened(cfg, opts["leg2_widen"])
    if cfg2 is not cfg:
        log(f"leg2 windows x{opts['leg2_widen']:g} (capacities): "
            f"{cfg2.nbr_window}/{cfg2.p2p_window}/{cfg2.m2p_window}")
    state, total, reshards = counts.call(
        "leg2", halo.run_resharded, hal, cfg2, mesh, opts["steps"],
        span=opts["segment"], log=lambda m: log(f"  {m}"),
        on_segment=on_segment)
    fin2 = all_finite(state)
    sync()
    leg2_wall = time.perf_counter() - t0
    occ = halo_occupancy(state, cfg, mesh)
    log("leg2 end occupancy (halo layout, unbounded windows): "
        + " ".join(f"{k} {a:.0f}/{m}" for k, (a, m) in occ.items())
        + f" against windows {cfg.nbr_window}/{cfg.p2p_window}/"
        f"{cfg.m2p_window}")
    launches = counts.summed(mesh, ("leg1_replicated", "leg1_halo",
                                    "leg2"))
    if not lead:
        return
    e0, e1 = rows[0]["total_energy"], rows[-1]["total_energy"]
    summary = dict(
        n=cfg.n, steps=opts["steps"], match_vs_replicated=match,
        **{k: pairing[k] for k in ("dpos_p99", "dpos_max", "dvel_p99",
                                   "dvel_max", "frac_off")},
        reshards=reshards, halo_violations=int(total["halo_violations"]),
        energy_rel_change=abs(e1 - e0) / abs(e0),
        momentum_max=max(r["momentum_mag"] for r in rows),
        wall_s=rows[-1]["wall_s"],
        # beyond the reference's summary
        scale=pairing["scale"], pair_duplicates=pairing["pair_duplicates"],
        leg1_overflow=over,
        leg2_overflow=[int(total["nbr_overflow"]),
                       int(total["tree_overflow"])],
        leg2_finite=fin2, ranks_up_s=up,
        leg2_widen=opts["leg2_widen"], leg2_end_occupancy=occ,
        leg1_wall_s=leg1_wall,
        leg2_wall_s=leg2_wall,
        leg2_steps_per_s=opts["steps"] / leg2_wall,
        ranks=mesh.size, backend=mesh.backend, device=str(dev),
        launches=launches)
    _write(os.path.join(out_dir, "summary.json"), summary)
    _write(os.path.join(out_dir, "status.json"),
           {"rc": 0 if match else 2})
    print(json.dumps(summary), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--segment", type=int, default=100)
    ap.add_argument("--out", default="out/halo32k")
    ap.add_argument("--separation", type=float, default=60.0)
    ap.add_argument("--approach-speed", type=float, default=0.6)
    ap.add_argument("--ball-ck", default=None,
                    help="pre-settled n/2 ball checkpoint from "
                         "tools.settle_ball (else leg 0 settles here)")
    ap.add_argument("--device", default="cuda:0",
                    help="'cuda:0' (default: 8 gloo ranks share card 0), "
                         "'cuda' (8 cards over NCCL) or 'cpu'")
    ap.add_argument("--leg2-widen", type=float, default=1.0,
                    help="leg 2's windows times this (capacities; the "
                         "merged state's per-rank groupings may need more "
                         "than build_cfg's)")
    ap.add_argument("--leg1-segments", type=int, default=LEG1_SEGMENTS,
                    help="8-step segments of leg 1 (a smoke run's cut)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override of build_cfg's config (repeatable; a "
                         "smoke run's narrower windows)")
    ap.add_argument("--record-inputs", default=None, metavar="PATH",
                    help="rank 0 saves the inputs of each windowed "
                         "kernel's first call in the first halo segment "
                         "(torch.save), to hold the kernels against their "
                         "plain versions")
    args = ap.parse_args(argv)
    from ..parallel import mesh as mesh_mod
    dev = resolve_device(args.device)
    mesh_mod.placement(RANKS, args.device)      # refuse before any work
    os.makedirs(args.out, exist_ok=True)
    for name in ("metrics.jsonl", "summary.json", "status.json"):
        if os.path.exists(os.path.join(args.out, name)):
            os.remove(os.path.join(args.out, name))

    cfg = build_cfg(args.n).replace(**config_mod.parse_overrides(args.set))
    t0 = time.perf_counter()
    ball, rc = settle_or_load(cfg, args.n, args.ball_ck, dev,
                              log=lambda m: print(m, flush=True))
    if rc:
        return rc
    st = planet.prime(two_body(ball, args.separation, args.approach_speed),
                      cfg)
    print(f"primed two-body state n={st.n} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    opts = dict(out=os.path.abspath(args.out), steps=args.steps,
                segment=args.segment, leg1_segments=args.leg1_segments,
                leg2_widen=args.leg2_widen,
                record_inputs=args.record_inputs and os.path.abspath(
                    args.record_inputs))
    arrays = to_numpy(st)
    del st, ball
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    opts["t_spawn"] = time.time()
    mesh_mod.spawn(_rank, RANKS, device=args.device,
                   args=(opts, arrays, cfg))
    status = os.path.join(args.out, "status.json")
    return json.load(open(status))["rc"] if os.path.exists(status) else 1


if __name__ == "__main__":
    sys.exit(main())
