"""Scaling sweep: steps/s against particle count for each pipeline
(PyTorch port of the root ``tools/scaling_bench.py``).

The dense path with direct gravity (the two all-pairs kernels) at
--dense-n and the grid + tree cached production step (``jupiter_100k``'s
stack, a rebuild every 32 steps) at --grid-n, each from its primed
``ics.jupiter`` initial conditions with the particle radius scaled as
5 (3000/n)^(1/3); a run of --steps steps (the grid path at least 24 or
--steps / 4) timed with CUDA events after an untimed run of the same
length. Prints a row a run and writes them with --json. Runs on the card
unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.scaling_bench [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import config as config_mod
from ..models import ics, planet
from ..state import resolve_device
from ..utils.profiling import seconds_per_call


def rate(cfg, steps, dev):
    """steps/s of planet.run from the primed ICs, after a warm-up run."""
    st = planet.prime(ics.jupiter(cfg, device=dev),
                      cfg.replace(rebuild_every=1))
    dt, _ = seconds_per_call(lambda: planet.run(st, cfg, steps), dev)
    return steps / dt


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dense-n", default="1000,3000,10000",
                    help="particle counts of the dense path")
    ap.add_argument("--grid-n", default="30000,100000",
                    help="particle counts of the grid + tree path")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rows = []
    scale = lambda n: 5.0 * (3000 / n) ** (1 / 3)

    for n in _ints(args.dense_n):
        cfg = config_mod.default(n=n, particle_radius=scale(n),
                                 gravity_solver="direct",
                                 neighbor_mode="dense")
        r = rate(cfg, args.steps, dev)
        rows.append({"n": n, "pipeline": "dense+direct (all-pairs kernels)",
                     "steps_per_sec": round(r, 2),
                     "particle_steps_per_sec": round(n * r, 1)})
        print(rows[-1], flush=True)

    for n in _ints(args.grid_n):
        cfg = config_mod.jupiter_100k(n=n, particle_radius=scale(n))
        r = rate(cfg, max(24, args.steps // 4), dev)
        rows.append({"n": n, "pipeline": "grid+tree (cached K="
                     f"{cfg.rebuild_every})",
                     "steps_per_sec": round(r, 2),
                     "particle_steps_per_sec": round(n * r, 1)})
        print(rows[-1], flush=True)

    if args.json:
        where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        with open(args.json, "w") as f:
            json.dump({"device": where, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
