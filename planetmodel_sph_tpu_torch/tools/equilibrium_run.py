"""Hydrostatic-equilibrium validation run (PyTorch port of the root
``tools/equilibrium_run.py``): a preset from ``ics.jupiter`` (or a
checkpoint) for --steps steps, diagnostics every --every, and the energy
drift over the run. Writes into --out:

  equilibrium_diags.npz   the stacked diagnostics
  equilibrium_state.psph  the final checkpoint
  equilibrium.png         the final state's render
  profile.json            the radial density and pressure profile (16 bins)

Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.equilibrium_run \\
        --preset jupiter_3k --steps 10000 --out out
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
from ..state import resolve_device
from ..utils import checkpoint, diagnostics, render

PRESETS = ("jupiter_3k", "parity", "default", "gradh", "gradh_100k")


def radial_profile(state, nbins=16):
    """Mean density and pressure in `nbins` shells of equal particle count
    about the centre of mass."""
    pos = state.pos.cpu().numpy()
    m = state.mass.cpu().numpy()
    rho = state.rho.cpu().numpy()
    pressure = state.pressure.cpu().numpy()
    com = np.average(pos, axis=0, weights=m)
    r = np.linalg.norm(pos - com, axis=-1)
    edges = np.quantile(r, np.linspace(0, 1, nbins + 1))
    rows = []
    for i in range(nbins):
        sel = (r >= edges[i]) & (r <= edges[i + 1])
        if sel.sum() == 0:
            continue
        rows.append({
            "r_mid": float(0.5 * (edges[i] + edges[i + 1])),
            "rho_avg": float(rho[sel].mean()),
            "pressure_avg": float(pressure[sel].mean()),
            "count": int(sel.sum()),
        })
    return rows


def preset_config(name: str):
    """The preset's config: `gradh` is the dense 3k step with grad-h
    pressure and Newton h, `gradh_100k` the production 100k config with
    the same, `default` the default config at n = 3000."""
    if name == "gradh":
        return config_mod.default(n=3000, grad_p_mode="grad_h",
                                  h_mode="newton")
    if name == "gradh_100k":
        return config_mod.jupiter_100k(grad_p_mode="grad_h", h_mode="newton")
    if name == "default":
        return config_mod.default(n=3000)
    return getattr(config_mod, name)()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--every", type=int, default=250)
    ap.add_argument("--preset", default="jupiter_3k", choices=PRESETS)
    ap.add_argument("--restore", default=None,
                    help="continue from a checkpoint (e.g. to measure the "
                         "drift in equilibrium after the collapse)")
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    step0 = 0
    if args.restore:
        state, cfg, step0 = checkpoint.load(args.restore, device=dev)
        print(f"restored {args.restore} at step {step0}")
    else:
        cfg = preset_config(args.preset)
        config_mod.check_slice(cfg)
        state = planet.prime(ics.jupiter(cfg, device=dev), cfg)

    every = max(1, min(args.every, args.steps))
    n_chunks = max(1, args.steps // every)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, diags = planet.run_with_diagnostics(state, cfg, n_chunks, every)
    drift = diagnostics.energy_drift(diags).cpu().numpy()   # completes it
    wall = time.perf_counter() - t0
    total = n_chunks * every
    print(f"{total} steps in {wall:.1f}s = {total/wall:.1f} steps/s "
          f"({cfg.n*total/wall:.3g} particle-steps/s)")

    diags = {k: v.cpu().numpy() for k, v in diags.items()}
    print(f"energy drift over {total} steps: {drift[-1]:.3e} "
          f"(max {drift.max():.3e})")
    print(f"final neighbors_avg: {float(diags['neighbors_avg'][-1]):.1f}")
    print(f"radius_rms: {diags['radius_rms'][0]:.2f} -> "
          f"{diags['radius_rms'][-1]:.2f}")

    np.savez(os.path.join(args.out, "equilibrium_diags.npz"), **diags)
    checkpoint.save(os.path.join(args.out, "equilibrium_state.psph"),
                    state, cfg, step0 + total)
    render.render_png(state, os.path.join(args.out, "equilibrium.png"))
    with open(os.path.join(args.out, "profile.json"), "w") as f:
        json.dump({"preset": args.preset, "steps": step0 + total,
                   "energy_drift": float(drift[-1]),
                   "profile": radial_profile(state)}, f, indent=1)
    print(f"artifacts -> {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
