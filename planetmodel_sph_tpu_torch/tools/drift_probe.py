"""A/B energy-drift probes at 100k (PyTorch port of the root
``tools/drift_probe.py``): which operating-point knob pumps energy.

It settles once (the monopole theta = 0.7 base, damped, with viscosity, a
rebuild every 8 steps) from ``ics.polytrope``, or reuses --settled, then
runs each --probe for --steps steps from that same state in chunks of
--chunk, printing each chunk's energy change: exponential pumping shows
within 3000 steps. Each probe appends one JSON row to --out (drift over the
run and per 10k steps, the chunks' energy changes, vmax, seconds).
``--set K=V`` overrides every config (the settle's and the probes'), e.g.
``n`` for a small state. Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.drift_probe --probe ctrl \\
        --probe q10 --steps 3000
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

BASE = dict(grad_p_mode="grad_h", h_mode="newton",
            nbr_window=240, p2p_window=384, m2p_window=192)

# the ladder between the stable monopole baseline and the quadrupole
# theta = 1.0, K = 16 point that pumps
PROBES = {
    # monopole theta=0.7, K=8, full Newton h: the control, flat drift
    "ctrl": dict(multipole_order=1, theta=0.7, rebuild_every=8,
                 sort_every=64),
    # quadrupole theta=1.0, K=16, warm-started h: expect pumping
    "q10": dict(multipole_order=2, theta=1.0, rebuild_every=16,
                sort_every=64, gather_pad_rows=32),
    # q10 minus one ingredient at a time
    "q10k8": dict(multipole_order=2, theta=1.0, rebuild_every=8,
                  sort_every=64, gather_pad_rows=32),
    "q10hw": dict(multipole_order=2, theta=1.0, rebuild_every=16,
                  sort_every=64, gather_pad_rows=32, h_newton_iters=4),
    "q10t07": dict(multipole_order=2, theta=0.7, rebuild_every=16,
                   sort_every=64, gather_pad_rows=32),
    "mono_k16": dict(multipole_order=1, theta=0.7, rebuild_every=16,
                     sort_every=64, gather_pad_rows=32),
    # q10 with both suspects reverted (quadrupole kept)
    "q10k8hw": dict(multipole_order=2, theta=1.0, rebuild_every=8,
                    sort_every=64, gather_pad_rows=32, h_newton_iters=4),
    "q09k8": dict(multipole_order=2, theta=0.9, rebuild_every=8,
                  sort_every=64, gather_pad_rows=32),
}


def _cfg(extra, **kw):
    cfg = config_mod.jupiter_100k(**{**BASE, **kw, **extra})
    config_mod.check_slice(cfg)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--settle", type=int, default=2000)
    ap.add_argument("--settled", default="out/settled100k.psph",
                    help="settled-state cache (created if absent)")
    ap.add_argument("--out", default="out/drift_probe.jsonl")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="SimConfig override of every config (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    names = args.probe or ["ctrl", "q10"]
    extra = config_mod.parse_overrides(args.set)
    dev = resolve_device(args.device)

    if os.path.exists(args.settled):
        state0, _, _ = checkpoint.load(args.settled, device=dev)
        print(f"reusing settled state {args.settled}", flush=True)
    else:
        # settle at the stable monopole baseline whatever the preset's
        # defaults, so the shared state never comes from a suspect point
        cfg_s = _cfg(extra, vel_damping=0.1, av_alpha=0.5, av_beta=1.0,
                     rebuild_every=8, sort_every=64, multipole_order=1,
                     theta=0.7)
        state0 = planet.prime(ics.polytrope(cfg_s, device=dev), cfg_s)
        t0 = time.perf_counter()
        done = 0
        while done < args.settle:
            state0, info = planet.run_info(state0, cfg_s, args.chunk)
            done += args.chunk
            print(f"settle {done}/{args.settle} "
                  f"({time.perf_counter()-t0:.0f}s) over="
                  f"({int(info['nbr_overflow'])}, "
                  f"{int(info['tree_overflow'])})", flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.settled)),
                    exist_ok=True)
        checkpoint.save(args.settled, state0, _cfg(extra), args.settle)

    n_chunks = args.steps // args.chunk
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for name in names:
        cfg = _cfg(extra, **PROBES[name])
        state = state0
        e0, prev = None, None
        t0 = time.perf_counter()
        drifts = []
        for c in range(n_chunks):
            state, info = planet.run_info(state, cfg, args.chunk)
            d = diagnostics.measure(state, cfg)
            e = float(d["total_energy"])
            vmax = float(d["vel_max"])
            over = (int(info["nbr_overflow"]), int(info["tree_overflow"]))
            if e0 is None:
                e0, prev = e, e
            drifts.append(e - prev)
            prev = e
            print(f"{name:8s} step {(c+1)*args.chunk:5d}: E={e:.4f} "
                  f"dE={drifts[-1]:+.4f} vmax={vmax:.3f} over={over}",
                  flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        rel = abs(prev - e0) / abs(e0)
        row = dict(probe=name, drift_rel=rel,
                   per10k=rel * 10000.0 / max(args.steps - args.chunk, 1),
                   chunk_dE=[round(x, 5) for x in drifts],
                   vmax=vmax, secs=round(dt, 1))
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(f"{name:8s}: drift {rel:.2e} over {args.steps} steps "
              f"(~{row['per10k']:.1e}/10k) vmax={vmax:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
