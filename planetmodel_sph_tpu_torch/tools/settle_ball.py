"""Settle the halo collision's n/2 polytrope ball (PyTorch port of
the root ``tools/settle_ball.py``): leg 0 of ``tools.halo_collision``.

One device, no ranks: 400 damped steps of ``ics.polytrope`` at the settle
windows (x3), then the settled ball's occupancy at effectively unbounded
windows (the maxima the leg windows must clear) and a 32-step probe at the
legs' own (x1) windows; the ball is saved (``.psph`` or npz) only when
nothing overflowed and every field is finite. ``halo_collision --ball-ck``
loads it. Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.settle_ball --n 32768 \\
        --out out/halo_ball.psph
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from .. import config as config_mod
from ..models import ics, planet
from ..ops import structure
from ..state import resolve_device
from ..utils import checkpoint
from .halo_collision import build_cfg, finite, settle_cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768,
                    help="COLLISION particle count; the ball is n/2")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", default="out/halo_ball.psph")
    ap.add_argument("--probe-steps", type=int, default=32,
                    help="steps of the probe at the legs' windows")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override of build_cfg's config (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = build_cfg(args.n).replace(**config_mod.parse_overrides(args.set))
    scfg = settle_cfg(cfg, args.n // 2)
    ball = planet.prime(ics.polytrope(scfg, device=dev), scfg)
    ball, sinfo = planet.run_info(ball, scfg, args.steps)
    sover = (int(sinfo["nbr_overflow"]), int(sinfo["tree_overflow"]))
    fin = finite(ball)
    print(f"settled ball n={scfg.n}: over={sover} finite={fin}", flush=True)
    if sum(sover) or not fin:
        print("settle FAILED — not saving", flush=True)
        return 3
    # the settled ball's true occupancy at effectively unbounded windows:
    # the maxima the leg windows must clear (refine off here: nbr_window
    # must hold the pre-refine adjacency)
    wcfg = settle_cfg(cfg, args.n // 2, mult=1).replace(
        nbr_window=2048, p2p_window=2048, m2p_window=2048,
        sph_refine_subblock=False)
    st = structure.build(ball.pos, ball.h, ball.mass, wcfg)
    occ = lambda v: f"{float(v.float().mean()):.0f}/{int(v.max())}"
    print(f"settled-ball occupancy (x1 cutoffs, unbounded windows): "
          f"sph {occ(st.n_sph)} p2p {occ(st.n_p2p)} m2p {occ(st.n_m2p)}",
          flush=True)
    del st

    # probe: the settled ball must fit the production legs' own windows
    # (the x3 settle windows only absorb the raw IC's transient)
    pcfg = settle_cfg(cfg, args.n // 2, mult=1)
    _, pinfo = planet.run_info(ball, pcfg, args.probe_steps)
    pover = (int(pinfo["nbr_overflow"]), int(pinfo["tree_overflow"]))
    print(f"leg-window probe ({args.probe_steps} steps @ x1): "
          f"over={pover}", flush=True)
    if sum(pover):
        print("probe FAILED: settled ball exceeds production windows — "
              "widen the leg windows in build_cfg, not just the settle",
              flush=True)
        return 3
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    checkpoint.save(args.out, ball, scfg, args.steps)
    print(f"ball -> {args.out}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
