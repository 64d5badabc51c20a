"""The rebuild's stages, one by one (PyTorch port of the root
``tools/profile_build.py``): ``structure.build`` whole, the Morton encode
and sort, ``grouping.cell_groups``, the block statistics with the [G, NB]
geometry pass on a frozen grouping, and ``_compact_rows`` of a [G, NB]
adjacency into windows.

Each stage runs `k` times in a chain (each call's input takes a term of
the previous output, so no call can be skipped), after a warm-up call,
timed with CUDA events on the card; a line per stage, the reference's
label, milliseconds a call and the chain's checksum. The state: the
``jupiter_100k`` preset's initial conditions, primed (as the reference),
or a state file with --ck. Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.profile_build \\
        [--ck docs/results/drift100k_r5ship/state.psph] [--k 4]
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import config as config_mod
from ..models import ics, planet
from ..ops import grouping, morton, structure
from ..state import resolve_device
from ..utils import checkpoint
from ..utils.profiling import seconds_per_call


def timed(label, fn, k, dev):
    """ms a call of fn(carry) -> carry over a chain of k calls."""
    box = [torch.zeros((), device=dev)]

    def chain():
        c = box[0]
        for _ in range(k):
            c = fn(c)
        box[0] = c
        return c
    dt, c = seconds_per_call(chain, dev)
    dt /= k
    print(f"{label:40s} {dt*1e3:9.2f} ms   ({float(c):.3e})", flush=True)
    return dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ck", default=None,
                    help="a state file (default: the preset's primed ICs)")
    ap.add_argument("--n", type=int, default=None,
                    help="particles of the preset's ICs (default 100,000)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ck:
        state, cfg, _ = checkpoint.load(args.ck, device=dev)
    else:
        cfg = config_mod.jupiter_100k(**({"n": args.n} if args.n else {}))
        state = planet.prime(ics.jupiter(cfg, device=dev),
                             cfg.replace(rebuild_every=1))
    pos, h, mass = state.pos, state.h, state.mass
    bsz, lg = cfg.nbr_group_size, cfg.nbr_group_level
    k = args.k
    print(f"n={state.n} on {dev}", flush=True)

    def full(c):
        st = structure.build(pos + c, h, mass, cfg)
        return c + 1e-12 * st.n_sph.sum()
    timed("build (full)", full, k, dev)

    def sort_only(c):
        p = pos + c
        lo, hi = p.amin(0), p.amax(0)
        order = torch.sort(morton.encode(p, lo, hi), stable=True).indices
        return c + 1e-12 * order[0]
    timed("morton encode+argsort", sort_only, k, dev)

    def groups_only(c):
        p = pos + c
        grp = grouping.cell_groups(p, p.amin(0), p.amax(0), bsz, lg)
        return c + 1e-12 * grp.tgt_idx[0]
    timed("cell_groups (incl sort)", groups_only, k, dev)

    # the geometry pass and the compaction on a frozen grouping
    grp = grouping.cell_groups(pos, pos.amin(0), pos.amax(0), bsz, lg)
    g = grp.live.shape[0]
    tix = grp.tgt_idx.long()

    def geom_pass(c):
        pos_t = (pos + c)[tix].reshape(g, bsz, 3)
        h_t = h[tix].reshape(g, bsz)
        m_t = mass[tix].reshape(g, bsz)
        tlo, thi = pos_t.amin(1), pos_t.amax(1)
        t_hmax = torch.where(grp.live, h_t, 0.0).amax(1)
        _, _, s_amin, s_amax, _, s_hmax = structure._block_stats(
            pos_t, h_t, m_t, grp.live)
        gap = torch.clamp(torch.maximum(tlo[:, None, :] - s_amax[None],
                                        s_amin[None] - thi[:, None, :]),
                          min=0.0)
        gap2 = (gap * gap).sum(-1)
        cut = cfg.kappa * torch.maximum(t_hmax[:, None], s_hmax[None, :])
        return c + 1e-12 * (gap2 < cut * cut).sum()
    timed("block stats + [G,NB] geometry", geom_pass, k, dev)

    pt = pos[tix].reshape(g, bsz, 3)
    lo, hi = pt.amin(1), pt.amax(1)
    gap = torch.clamp(torch.maximum(lo[:, None, :] - hi[None],
                                    lo[None] - hi[:, None, :]), min=0.0)
    adj = (gap * gap).sum(-1) < 4.0

    def compact(c):
        idx, _, _ = structure._compact_rows(adj ^ (c > 0.5),
                                            cfg.nbr_window)
        return (idx[0, 0] > 100).to(c.dtype) * c
    timed(f"_compact_rows [G,NB]->[G,{cfg.nbr_window}]", compact, k, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
