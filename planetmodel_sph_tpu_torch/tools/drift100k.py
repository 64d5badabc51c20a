"""Energy-drift validation at n = 100,000 (PyTorch port of the root
``tools/drift100k.py``), in checkpointed chunks, with the ship gate.

Protocol (two phases, one JSONL trail, the phase recorded in each row):

1. SETTLE (steps [0, --settle)): damped relaxation (vel_damping) with mild
   viscosity from the analytic n=1 polytrope (``ics.polytrope``, the
   hydrostatic solution of P = K rho^2), windows x2, a rebuild every 8
   steps and no RESPA split.
2. DRIFT (steps [--settle, --target]): the ``jupiter_100k`` preset as
   shipped, damping and viscosity off.

Each chunk (500 steps) ends with ``diagnostics.measure``, a JSONL row and a
``.psph`` checkpoint; a second run resumes from ``state.psph``. A chunk that
overflows a window is discarded and retried from the state before it with
every window x1.25; in the drift phase the widen lasts that chunk only.
The ship gate then judges the drift rows: |dE|/|E| and the implied spin
|dL|/I per 10k steps, max |p| and the overflow. Exit code 0 pass, 1 too
few drift rows, 2 fail. Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.drift100k --out out/drift100k
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .. import config as config_mod
from ..models import ics, planet
from ..state import resolve_device
from ..utils import checkpoint, diagnostics


def build_cfg(args, settle: bool, widen: float = 1.0):
    """The phase's config: the preset's windows times `widen` (rounded up
    to 16), the settle phase's damping, viscosity and short chunks, then
    the ``--set`` overrides; checked by ``config.check_slice``."""
    kw = dict(grad_p_mode="grad_h", h_mode="newton") \
        if args.preset == "gradh" else {}
    if args.cfl:
        kw.update(dt_mode="cfl", cfl_number=0.25)
    if args.h_max:
        kw.update(h_max=args.h_max)
    preset = config_mod.jupiter_100k()
    nw, pw, mw = ((int(x) for x in args.windows.split(","))
                  if args.windows else
                  (preset.nbr_window, preset.p2p_window, preset.m2p_window))
    r16 = lambda v: -(-int(v * widen) // 16) * 16
    kw.update(nbr_window=r16(nw), p2p_window=r16(pw), m2p_window=r16(mw))
    if settle:
        # throwaway quasi-static relaxation on short full-rate chunks (the
        # raw IC's noisy accelerations outrun K=32 skins and RESPA kicks)
        kw.update(vel_damping=args.damp, av_alpha=args.av,
                  av_beta=2.0 * args.av, rebuild_every=8, respa_every=1)
    for item in (args.set or []):
        k, v = item.split("=", 1)
        kw[k] = config_mod.parse_override(k, v)
        if k in ("sph_exact_window", "blk_window") and widen > 1.0:
            kw[k] = r16(kw[k])      # r16 applies the widen factor itself
    cfg = config_mod.jupiter_100k(**kw)
    config_mod.check_slice(cfg)
    return cfg


def _under_results(path: str) -> bool:
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    return any(parts[i:i + 2] == ["docs", "results"]
               for i in range(len(parts) - 1))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", type=int, default=12000,
                    help="total steps INCLUDING the settle phase")
    ap.add_argument("--settle", type=int, default=2000,
                    help="damped settling steps before the measurement")
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--out", default="out/drift100k",
                    help="run directory (never under docs/results/)")
    ap.add_argument("--ic", default="polytrope", choices=["polytrope", "cold"])
    ap.add_argument("--preset", default="gradh", choices=["gradh", "default"],
                    help="gradh: grad-h + bounded Newton h; default: relax h")
    ap.add_argument("--cfl", action="store_true",
                    help="adaptive CFL timestep (needed to survive a cold "
                         "collapse, not from the polytrope)")
    ap.add_argument("--h-max", type=float, default=5.0,
                    help="halo smoothing-length cap (SimConfig.h_max)")
    ap.add_argument("--windows", type=str, default=None,
                    help="nbr,p2p,m2p window override, e.g. 224,256,160")
    ap.add_argument("--damp", type=float, default=0.1,
                    help="settle-phase velocity damping rate")
    ap.add_argument("--settle-widen", type=float, default=2.0,
                    help="window widen factor of the SETTLE phase only")
    ap.add_argument("--av", type=float, default=0.5,
                    help="settle-phase Monaghan AV alpha (beta=2*alpha)")
    ap.add_argument("--set", action="append", default=[],
                    help="extra jupiter_100k override k=v (repeatable); "
                         "sph_exact_window/blk_window also scale with the "
                         "overflow-retry widen factor")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if _under_results(args.out):
        raise SystemExit(f"--out {args.out}: the results under docs/results/ "
                         "are the reference's; write a run elsewhere")
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    ck = os.path.join(args.out, "state.psph")
    jsonl = os.path.join(args.out, "metrics.jsonl")

    if os.path.exists(ck):
        state, _, step0 = checkpoint.load(ck, device=dev)  # cfg from args
        print(f"resumed {ck} at step {step0}", flush=True)
    else:
        cfg0 = build_cfg(args, settle=args.settle > 0,
                         widen=args.settle_widen if args.settle else 1.0)
        ic = ics.polytrope if args.ic == "polytrope" else ics.jupiter
        state = planet.prime(ic(cfg0, device=dev), cfg0)
        step0 = 0

    cfgs = {}
    step = step0
    # the widen is kept per phase: a settle-phase widen never reaches the
    # drift phase, whose final checkpoint carries the preset's windows
    # unless the drift phase itself overflowed
    widens = {True: args.settle_widen, False: 1.0}
    # per phase: [steps kept, seconds stepping them, seconds of retries]
    timing = {"settle": [0, 0.0, 0.0], "drift": [0, 0.0, 0.0]}
    while step < args.target:
        settle = step < args.settle
        phase = "settle" if settle else "drift"
        widen = widens[settle]
        k = min(args.chunk, (args.settle if settle else args.target) - step)
        key = (settle, widen)
        if key not in cfgs:
            cfgs[key] = build_cfg(args, settle, widen)
        cfg = cfgs[key]
        _sync(dev)
        t0 = time.perf_counter()
        state2, info = planet.run_info(state, cfg, k)
        _sync(dev)
        secs = time.perf_counter() - t0
        over = (int(info["nbr_overflow"]), int(info["tree_overflow"]))
        if sum(over) > 0 and widen < 2.5:
            # dropped interactions break the force symmetry: discard the
            # chunk, widen every window 25 % and retry from the state
            # before it
            timing[phase][2] += secs
            widens[settle] = round(widen * 1.25, 4)
            print(f"step {step}: overflow {over} -> windows "
                  f"x{widens[settle]} ({phase} phase), chunk retried",
                  flush=True)
            continue
        state = state2
        timing[phase][0] += k
        timing[phase][1] += secs
        if not settle and widen > 1.0:
            # the drift-phase widen lasts one chunk: a one-off overflow
            # must not pin the rest of the run (and the final checkpoint's
            # config) at widened capacities
            widens[False] = 1.0
            print(f"step {step + k}: widened chunk clean -> windows back "
                  "to preset for the next chunk", flush=True)
        d = {k2: float(v) for k2, v in
             diagnostics.measure(state, cfg).items()}
        d["step"] = step = step + k
        d["phase"] = phase
        d["nbr_overflow"], d["tree_overflow"] = over
        d["window_widen"] = widen
        with open(jsonl, "a") as f:
            f.write(json.dumps(d) + "\n")
        checkpoint.save(ck, state, cfg, step)
        print(f"step {step} [{phase}]: E={d['total_energy']:.6g} "
              f"|p|={d['momentum_mag']:.3g} "
              f"vmax={d['vel_max']:.3f} nn={d['neighbors_avg']:.1f} "
              f"over={over} ({k / secs:.1f} steps/s)", flush=True)
    for phase, (n, secs, retried) in timing.items():
        if n:
            print(f"phase {phase}: {n} steps in {secs:.3f} s of stepping = "
                  f"{n / secs:.3f} steps/s; retried chunks "
                  f"{retried:.3f} s", flush=True)
    print("target reached", flush=True)
    return ship_gate(jsonl)


def gate_numbers(jsonl: str):
    """The ship gate's numbers over the drift-phase rows of `jsonl`, or None
    with fewer than two: rows, |dE|/|E| per 10k steps, max |p|, the summed
    overflow and the implied spin |dL|/I per 10k steps (None for rows
    without the angular-momentum columns)."""
    rows = [json.loads(ln) for ln in open(jsonl)]
    drift = [r for r in rows if r.get("phase") == "drift"]
    if len(drift) < 2:
        return None
    e0, e1 = drift[0]["total_energy"], drift[-1]["total_energy"]
    span = drift[-1]["step"] - drift[0]["step"]
    per10k = 10_000.0 / max(span, 1)
    out = dict(rows=len(drift), energy_per_10k=abs(e1 - e0) / abs(e0) * per10k,
               max_momentum=max(r["momentum_mag"] for r in drift),
               overflow=sum(r["nbr_overflow"] + r["tree_overflow"]
                            for r in drift), spin_per_10k=None)
    if "angular_momentum_x" in drift[0]:
        dl = sum((drift[-1][f"angular_momentum_{c}"]
                  - drift[0][f"angular_momentum_{c}"]) ** 2
                 for c in "xyz") ** 0.5
        out["spin_per_10k"] = dl / drift[-1]["inertia_com"] * per10k
    return out


def ship_gate(jsonl: str, drift_budget: float = 1e-3,
              mom_budget: float = 1e-3,
              spin_budget: float = 5e-5) -> int:
    """The ship gate over the drift-phase rows: energy drift per 10k steps,
    the largest momentum, the overflow, and the angular-momentum drift as
    the implied solid-body spin rate |dL| / I_com per 10k steps (a body
    whose true L is about 0 has no relative |dL|/|L|). Prints one line;
    returns the process exit code (0 pass, 1 too few rows, 2 fail)."""
    g = gate_numbers(jsonl)
    if g is None:
        print("ship gate: not enough drift rows", flush=True)
        return 1
    de, pmax, over = g["energy_per_10k"], g["max_momentum"], g["overflow"]
    if g["spin_per_10k"] is not None:
        spin_ok = g["spin_per_10k"] <= spin_budget
        spin_msg = (f", implied spin dL/I = {g['spin_per_10k']:.3g} per 10k "
                    f"steps (budget {spin_budget:g})")
    else:   # rows from before the L columns existed
        spin_ok, spin_msg = True, ", L columns absent (pre-r5 metrics)"
    ok = de <= drift_budget and pmax <= mom_budget and over == 0 \
        and spin_ok
    print(f"SHIP GATE [{'PASS' if ok else 'FAIL'}]: |dE|/|E| = {de:.3g} "
          f"per 10k steps (budget {drift_budget:g}), max |p| = {pmax:.3g} "
          f"(budget {mom_budget:g}), overflow = {over}{spin_msg}",
          flush=True)
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
