"""Window and rebuild-period sweep at 100k: steps/s and window statistics
per configuration (PyTorch port of the root ``tools/ksweep.py``).

The ``jupiter_100k`` preset's primed initial conditions run 32 steps; then
for each sub-block size (16: windows 288/384/416; 32: 160/208/224) and
rebuild period K (8, 16, 32; sort every 8K steps) a run of --steps steps
from that state, timed with CUDA events after an untimed run of the same
length, and one skinned build's mean window occupancy in slots a target
(SPH and P2P in particles, the ring in sub-blocks) and its overflow
counts. A configuration that raises prints FAILED and the sweep goes on.
--sub and --k pick a part of the grid. Runs on the card unless ``--device
cpu``.

    python -m planetmodel_sph_tpu_torch.tools.ksweep [--sub 32 --k 16]
"""

from __future__ import annotations

import argparse
import sys

from .. import config as config_mod
from ..models import ics, planet
from ..ops import structure
from ..state import resolve_device
from ..utils.profiling import seconds_per_call

# (nbr_sub, nbr_window, p2p_window, m2p_window)
WINDOWS = ((16, 288, 384, 416), (32, 160, 208, 224))
KS = (8, 16, 32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sub", type=int, action="append", default=[],
                    choices=[w[0] for w in WINDOWS])
    ap.add_argument("--k", type=int, action="append", default=[])
    ap.add_argument("--n", type=int, default=None,
                    help="particles (default: the preset's 100,000)")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--warm", type=int, default=32,
                    help="steps run from the primed ICs before the sweep")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    nkw = {"n": args.n} if args.n else {}
    base = config_mod.jupiter_100k(**nkw)
    state0 = planet.prime(ics.jupiter(base, device=dev),
                          base.replace(rebuild_every=1))
    state0 = planet.run(state0, base, args.warm)

    for sub, nw, pw, mw in WINDOWS:
        if args.sub and sub not in args.sub:
            continue
        for k in args.k or KS:
            cfg = config_mod.jupiter_100k(nbr_sub=sub, nbr_window=nw,
                                          p2p_window=pw, m2p_window=mw,
                                          rebuild_every=k, sort_every=8 * k,
                                          **nkw)
            try:
                dt, _ = seconds_per_call(
                    lambda: planet.run(state0, cfg, args.steps), dev)
                dt /= args.steps
                skin = planet._skin(cfg, state0.vel, state0.accel)
                st = structure.build(state0.pos, state0.h, state0.mass, cfg,
                                     skin=skin)
                mean = lambda v: float(v.float().mean())
                print(f"sub={sub} K={k:2d}: {dt*1e3:5.1f} ms/step = "
                      f"{1/dt:5.1f} steps/s (sph {mean(st.n_sph)*sub:.0f} "
                      f"p2p {mean(st.n_p2p)*sub:.0f} "
                      f"ring {mean(st.n_m2p):.0f} slots/tgt, "
                      f"over=({int(st.sph_overflow)},{int(st.p2p_overflow)},"
                      f"{int(st.m2p_overflow)}))", flush=True)
            # a configuration the port refuses prints its refusal, as the
            # reference prints its failures
            except Exception as e:          # noqa: BLE001
                print(f"sub={sub} K={k}: FAILED {str(e)[:120]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
