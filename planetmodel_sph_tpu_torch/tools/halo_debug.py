"""The halo collision's leg 1 at smoke scale, segment by segment (PyTorch
port of the root ``tools/halo_debug.py``).

The same settle (or a ball from ``tools.settle_ball``) and two-body prime
as ``tools.halo_collision``, then on 8 ranks: the halo layout's structure
occupancy at unbounded windows (what the capacities must clear: the
per-rank grouping and the ``[local | ring]`` source set fragment blocks
differently from one device), and 8 segments of 8 steps of the replicated
and the halo layouts, each printing its finiteness, overflow and
violations, stopping at the first non-finite state. Ranks as in
``tools.halo_collision`` (``--device cuda:0`` by default, ``cpu``).

    python -m planetmodel_sph_tpu_torch.tools.halo_debug 2048 [BALL_CK]
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import config as config_mod
from ..models import planet
from ..state import from_numpy, resolve_device, to_numpy
from .halo_collision import (RANKS, build_cfg, finite, halo_occupancy,
                             settle_or_load, two_body)

SEGMENTS, SEGMENT_STEPS = 8, 8


def _rank(mesh, arrays, cfg, segments):
    from ..parallel import dp, halo, mesh as mesh_mod
    lead = mesh.rank == 0
    log = (lambda m: print(m, flush=True)) if lead else (lambda m: None)
    state = from_numpy(arrays, device=mesh.device)
    rep = mesh_mod.shard_state(state, mesh)
    del state
    hal = halo.morton_shard_state(rep, mesh)
    rrun = dp.make_run_info(cfg.replace(dp_mode="replicated"), mesh)
    hrun = halo.make_run(cfg, mesh)

    # the halo layout's occupancy at unbounded windows
    occ = halo_occupancy(hal, cfg, mesh)
    log("halo-layout occupancy (unbounded): "
        + " ".join(f"{k} {a:.0f}/{m}" for k, (a, m) in occ.items()))

    def all_finite(s):
        bad = torch.tensor(0 if finite(s) else 1, device=mesh.device)
        return int(mesh_mod.psum(bad, mesh)) == 0

    for seg in range(segments):
        rep, rinfo = rrun(rep, SEGMENT_STEPS)
        hal, hinfo = hrun(hal, SEGMENT_STEPS)
        rf, hf = all_finite(rep), all_finite(hal)
        log(f"seg {seg}: rep finite={rf} "
            f"over=({int(rinfo['nbr_overflow'])},"
            f"{int(rinfo['tree_overflow'])})  halo finite={hf} "
            f"over=({int(hinfo['nbr_overflow'])},"
            f"{int(hinfo['tree_overflow'])}) "
            f"viol={int(hinfo['halo_violations'])}")
        if not (rf and hf):
            break


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2048)
    ap.add_argument("ball_ck", nargs="?", default=None)
    ap.add_argument("--device", default="cuda:0",
                    help="'cuda:0' (default: 8 gloo ranks share card 0), "
                         "'cuda' (8 cards over NCCL) or 'cpu'")
    ap.add_argument("--segments", type=int, default=SEGMENTS)
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override of build_cfg's config (repeatable)")
    args = ap.parse_args(argv)
    from ..parallel import mesh as mesh_mod
    dev = resolve_device(args.device)
    mesh_mod.placement(RANKS, args.device)      # refuse before any work
    cfg = build_cfg(args.n).replace(**config_mod.parse_overrides(args.set))
    ball, rc = settle_or_load(cfg, args.n, args.ball_ck, dev,
                              log=lambda m: print(m, flush=True))
    if rc:
        return rc
    print(f"ball finite: {finite(ball)}", flush=True)
    # the reference's +-(30, 4, 0) offsets and +-0.3 velocities
    st = planet.prime(two_body(ball, 60.0, 0.6), cfg)
    print(f"primed finite: {finite(st)}", flush=True)
    mesh_mod.spawn(_rank, RANKS, device=args.device,
                   args=(to_numpy(st), cfg, args.segments))
    return 0


if __name__ == "__main__":
    sys.exit(main())
