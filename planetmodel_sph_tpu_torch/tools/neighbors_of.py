"""One particle's neighbour set, from the dense oracle and from the block
pipeline's candidate window, diffed (PyTorch port of the root
``tools/neighbors_of.py``).

The fused window sweeps recompute pairs in registers and keep no
neighbour list; this recovers the list offline. A true neighbour missing
from the window's candidates is a structure bug, or an overflowed window
(dropped and counted). Exit 0 when the window covers the oracle, 1 when a
neighbour is missing. Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.neighbors_of --n 2048 \\
        --particle 17
    python -m planetmodel_sph_tpu_torch.tools.neighbors_of \\
        --restore ck.psph --particle 12345 --max-print 20
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import config as config_mod
from ..models import ics, planet
from ..ops import kernels, structure
from ..state import resolve_device
from ..utils import checkpoint


def dense_oracle(pos, h, i, kappa):
    """Neighbour ids, r, W(r, h_i) and the symmetrized W of particle i by
    brute force (the oracle), nearest first."""
    d = pos - pos[i]
    r = np.sqrt(np.sum(d * d, axis=-1))
    support = kappa * np.maximum(h[i], h)
    ids = np.where((r < support) & (np.arange(len(h)) != i))[0]
    rt = torch.from_numpy(r[ids])
    w_i = kernels.w(rt, torch.full_like(rt, float(h[i]))).numpy()
    w_sym = 0.5 * (w_i + kernels.w(rt, torch.from_numpy(h[ids])).numpy())
    order = np.argsort(r[ids])
    return ids[order], r[ids][order], w_i[order], w_sym[order]


def window_candidates(pos, h, mass, cfg, i):
    """The particle ids in i's group's SPH candidate window (the superset
    the fused sweeps evaluate), the window's overflow, the group and the
    row length."""
    st = structure.build(pos, h, mass, cfg)
    grp = st.groups
    bsz, sub = cfg.nbr_group_size, cfg.nbr_sub
    slot = int(grp.unsort_idx[i])
    g = slot // bsz
    n_row = int(st.n_sph[g])
    row = st.sph_idx[g][:n_row].cpu().numpy()
    tgt = grp.tgt_idx.cpu().numpy()
    live = grp.live.reshape(-1).cpu().numpy()
    if cfg.sph_exact_window > 0:
        slots = row                   # exact lists: sorted-layout slots
    else:
        # sub-block ids: expand to their member slots
        slots = (row[:, None] * sub + np.arange(sub)[None, :]).reshape(-1)
    slots = slots[(slots >= 0) & (slots < len(tgt))]
    slots = slots[live[slots]]
    ids = np.unique(tgt[slots])
    return ids[ids != i], int(st.sph_overflow), g, n_row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particle", type=int, default=0)
    ap.add_argument("--preset", default="default")
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--restore", default=None,
                    help="checkpoint to load the state from")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VAL", help="config overrides")
    ap.add_argument("--max-print", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    kw = config_mod.parse_overrides(args.set)
    if args.n:
        kw["n"] = args.n
    if args.restore:
        state, cfg, step0 = checkpoint.load(args.restore, device=dev)
        if kw:
            cfg = cfg.replace(**kw)
        print(f"state from {args.restore} (step {step0})")
    else:
        cfg = getattr(config_mod, args.preset)(**kw)
        state = planet.prime(ics.jupiter(cfg, device=dev), cfg)
        print(f"fresh {args.preset} IC, n={cfg.n}")

    i = args.particle
    pos = state.pos.cpu().numpy()
    h = state.h.cpu().numpy()
    print(f"particle {i}: pos={pos[i].round(3)} h={h[i]:.4f} "
          f"support={cfg.kappa * h[i]:.4f}")

    ids, r, w_i, w_sym = dense_oracle(pos, h, i, cfg.kappa)
    print(f"\ndense oracle: {len(ids)} neighbors "
          f"(W(r,h_i), W_sym as in ParticleInteraction)")
    for j in range(min(len(ids), args.max_print)):
        print(f"  j={ids[j]:7d} r={r[j]:9.4f} W_i={w_i[j]:.5e} "
              f"W_sym={w_sym[j]:.5e}")
    if len(ids) > args.max_print:
        print(f"  ... {len(ids) - args.max_print} more")

    if cfg.neighbor_mode != "grid":
        print("\nneighbor_mode is dense — the sweeps evaluate all pairs; "
              "no window to diff. Pass --set neighbor_mode=grid to "
              "inspect the block pipeline.")
        return 0

    cand, over, g, n_row = window_candidates(state.pos, state.h,
                                             state.mass, cfg, i)
    print(f"\nwindow pipeline: group {g}, window row {n_row} "
          f"{'particles' if cfg.sph_exact_window else 'sub-blocks'}, "
          f"{len(cand)} candidate particles, sph_overflow={over}")
    missing = np.setdiff1d(ids, cand)
    extra = len(cand) - (len(ids) - len(missing))
    print(f"coverage: {len(ids) - len(missing)}/{len(ids)} true neighbors "
          f"in the candidate set; {extra} extra candidates (pre-filter "
          f"slack the sweeps mask out)")
    if len(missing):
        print(f"MISSING from window: {missing[:50]}")
        if over == 0:
            print("ERROR: true neighbors missing WITHOUT overflow — "
                  "structure bug")
            return 1
        print("note: window overflowed — widen nbr_window "
              "(dropped AND counted, never silent)")
        return 1
    print("OK: window candidates cover the oracle exactly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
