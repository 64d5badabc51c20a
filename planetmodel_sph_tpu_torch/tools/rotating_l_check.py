"""Angular-momentum conservation of the production tree step on a rotating
100k body (PyTorch port of the root ``tools/rotating_l_check.py``).

The MAC's target-dependent acceptance exerts a small net torque; on a body
whose L is about 0 the ship gate reads it as an implied spin. This tool
measures the relative drift where L is large: it loads the settled 100k
state, adds a solid-body spin omega about z through the centre of mass, well
inside breakup (about 0.044 for the settled ball), primes it and runs the
state's own configuration for --steps steps in chunks of --chunk, with every
window (``nbr_window``, ``p2p_window``, ``m2p_window`` and
``sph_refined_window``) widened by --widen. It writes a summary JSON
(|dL|/|L| and the relative energy drift, each per 10k steps, the overflow,
the rows) to --out.

The default state is the in-repo ``docs/results/drift100k_r5ship/state.psph``
(the state the port's bench and tools load); the reference's default,
``drift100k_r4ship32/state.psph``, is an earlier ship point of the same
protocol and is in the repo too (``--ck``).

    python -m planetmodel_sph_tpu_torch.tools.rotating_l_check --widen 1.5
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch

from ..models import planet
from ..state import resolve_device
from ..utils import checkpoint, diagnostics


def spin_up(state, omega: float):
    """`state` with a solid-body rotation omega about the z axis through
    its centre of mass added to its velocities."""
    m = state.mass
    com = (m[:, None] * state.pos).sum(dim=0) / m.sum()
    r = state.pos - com
    spin = omega * torch.stack([-r[:, 1], r[:, 0], torch.zeros_like(r[:, 0])],
                               dim=1)
    return state.replace(vel=state.vel + spin)


def widened(cfg, widen: float):
    """`cfg` with its windows times `widen`, rounded up to 16."""
    if widen == 1.0:
        return cfg
    r16 = lambda v: -(-int(v * widen) // 16) * 16
    return cfg.replace(nbr_window=r16(cfg.nbr_window),
                       p2p_window=r16(cfg.p2p_window),
                       m2p_window=r16(cfg.m2p_window),
                       sph_refined_window=r16(cfg.sph_refined_window)
                       if cfg.sph_refined_window else 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ck", default="docs/results/drift100k_r5ship/state.psph")
    ap.add_argument("--omega", type=float, default=0.01,
                    help="solid-body spin about z (breakup for the settled "
                         "ball is ~sqrt(GM/R^3) ~ 0.044)")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--out", default="out/rotating_l_100k.json")
    ap.add_argument("--widen", type=float, default=1.0,
                    help="interaction-window widen factor: the spinning "
                         "body stretches occupancy beyond the non-rotating "
                         "preset's capacities")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    state, cfg, _ = checkpoint.load(args.ck, device=dev)
    cfg = widened(cfg, args.widen)
    state = planet.prime(spin_up(state, args.omega), cfg)

    rows = []
    done = 0
    while done < args.steps:
        state, info = planet.run_info(state, cfg, args.chunk)
        done += args.chunk
        d = {k: float(v) for k, v in diagnostics.measure(state, cfg).items()}
        d.update(step=done, nbr_overflow=int(info["nbr_overflow"]),
                 tree_overflow=int(info["tree_overflow"]))
        rows.append(d)
        print(f"step {done}: E={d['total_energy']:.6g} "
              f"Lz={d['angular_momentum_z']:.6g} "
              f"|L|={d['angular_momentum_mag']:.6g} "
              f"over=({d['nbr_overflow']},{d['tree_overflow']})",
              flush=True)

    l0, l1 = rows[0], rows[-1]
    span = l1["step"] - l0["step"]
    dl = math.sqrt(sum(
        (l1[f"angular_momentum_{c}"] - l0[f"angular_momentum_{c}"]) ** 2
        for c in "xyz"))
    rel = dl / abs(l0["angular_momentum_mag"]) * 10_000.0 / span
    de = abs(l1["total_energy"] - l0["total_energy"]) \
        / abs(l0["total_energy"]) * 10_000.0 / span
    over = sum(r_["nbr_overflow"] + r_["tree_overflow"] for r_ in rows)
    summary = dict(omega=args.omega, steps=args.steps,
                   l_mag_0=l0["angular_momentum_mag"],
                   l_rel_drift_per_10k=rel, energy_drift_per_10k=de,
                   overflow=over, rows=rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
