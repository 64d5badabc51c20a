"""Morton-span statistics of the interaction windows at a state file
(PyTorch port of the root ``tools/span_stats.py``).

If each group's SPH candidates and P2P sub-blocks sit inside a short
contiguous range of the Morton-sorted source layout, a window gather could
become one contiguous slab copy per group, at the cost of sweeping the
span's extra (masked) slots. This prints the count and the span (last id
- first id + 1) distributions of the three windows of one skinned build of
``jupiter_100k``'s grad-h Newton stack with particle-exact SPH lists of
--xw particles (the pass-2 fusion off: it rides sub-block rows, which
exact lists replace). Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.span_stats \\
        --ck docs/results/drift100k_r5ship/state.psph
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import config as config_mod
from ..models import planet
from ..ops import structure
from ..state import resolve_device
from ..utils import checkpoint


def pct(v, q):
    return float(np.percentile(v, q))


def spans(idx, n, unit):
    """Print and return the per-group span of the valid ids of `idx`."""
    idx = idx.cpu().numpy()
    n = n.cpu().numpy()
    valid = idx >= 0
    big = idx.max() + 1
    lo = np.where(valid, idx, big).min(axis=1)
    hi = np.where(valid, idx, -1).max(axis=1)
    sp = np.maximum(hi - lo + 1, 0)
    print(f"  {unit}: count avg={n.mean():.0f} max={n.max()}  "
          f"span avg={sp.mean():.0f} p50={pct(sp, 50):.0f} "
          f"p90={pct(sp, 90):.0f} p99={pct(sp, 99):.0f} max={sp.max()}",
          flush=True)
    return sp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ck", default="docs/results/drift100k_r5ship/"
                    "state.psph")
    ap.add_argument("--xw", type=int, default=512)
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="SimConfig override (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    state, _, _ = checkpoint.load(args.ck, device=dev)
    cfg = config_mod.jupiter_100k(
        grad_p_mode="grad_h", h_mode="newton", rebuild_every=16,
        sort_every=64, sph_exact_window=args.xw, fuse_p2p_sph=False,
        fuse_p2p_residual=False,
        **config_mod.parse_overrides(args.set))
    skin = planet._skin(cfg, state.vel, state.accel)
    st = structure.build(state.pos, state.h, state.mass, cfg, skin=skin)
    g = st.groups.live.shape[0]
    b = cfg.nbr_group_size
    print(f"groups={g} ({b} targets each); source units: "
          f"particles={g * b} sub-blocks={g * b // cfg.nbr_sub}")
    print("SPH exact window (particle ids):")
    spans(st.sph_idx, st.n_sph, "particles")
    print("P2P window (sub-block ids):")
    spans(st.p2p_idx, st.n_p2p, "sub-blocks")
    print("M2P ring window (sub-block ids):")
    spans(st.m2p_idx, st.n_m2p, "sub-blocks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
