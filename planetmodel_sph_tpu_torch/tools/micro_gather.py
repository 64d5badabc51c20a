"""Micro-benchmark: packed row gathers against in-row gathers (PyTorch port
of the root ``tools/micro_gather.py``).

Decides the exact-SPH-candidate-list design: a [G, Wx] particle-id gather
of a packed [N, c] field table per step, against c in-row gathers
(``take_along_axis``) from [G, Wc] window rows; and the row-size curve of
the moment-entry gather (a [NSUB, padw] table through [G, W] ids) at pad
widths 4-160. Each variant runs `k` data-dependent calls (each index set
shifted by a term of the previous result), after a warm-up call, timed
with CUDA events on the card; all plain PyTorch indexing (the reference's
are XLA gathers, no kernel of its own). Inputs from a ``torch.Generator``
seeded with 0. Runs on the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.micro_gather
        [--g 2067 --wx 512 --wc 5120 --n 132288 --c 6]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..state import resolve_device
from ..utils.profiling import seconds_per_call


def timed(label, fn, args, k, dev):
    """ms a call of fn(*args, carry) -> carry over a chain of k calls."""
    def chain():
        c = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(k):
            c = fn(*args, c)
        return c
    dt, _ = seconds_per_call(chain, dev)
    dt /= k
    print(f"{label:44s} {dt*1e3:7.2f} ms", flush=True)
    return dt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--g", type=int, default=2067)
    ap.add_argument("--wx", type=int, default=512)
    ap.add_argument("--wc", type=int, default=5120)
    ap.add_argument("--n", type=int, default=132288)
    ap.add_argument("--c", type=int, default=6)
    ap.add_argument("--nsub", type=int, default=4134,
                    help="rows of the moment-entry table")
    ap.add_argument("--w", type=int, default=128,
                    help="entries a group of the moment-entry gather")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g, wx, wc, n, c, k = args.g, args.wx, args.wc, args.n, args.c, args.k
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    ints = lambda lo, hi, *shape: torch.randint(
        lo, hi, shape, generator=gen).to(dev)
    cols = [rnd(n) for _ in range(c)]
    idx = ints(0, n, g, wx)
    # Morton-local variant: ids clustered near the group's own range
    base = (torch.arange(g, device=dev) * (n // g))[:, None]
    idx_loc = torch.clamp(base + ints(-4096, 4096, g, wx), 0, n - 1)
    rowidx = ints(0, wc, g, wx)
    rows = [rnd(g, wc) for _ in range(c)]
    packed = torch.stack(cols, dim=-1)

    def packed_gather(idx_, carry):
        gat = packed[torch.clamp(idx_ + carry, 0, n - 1)]      # [G, Wx, c]
        return carry + (gat[0, 0, 0] * 1e-30).long()

    def per_take(rows_, ridx_, carry):
        ri = torch.clamp(ridx_ + carry, 0, wc - 1)
        acc = sum(torch.take_along_dim(r, ri, dim=1)[0, 0] for r in rows_)
        return carry + (acc * 1e-30).long()

    timed(f"packed [{n},{c}] row-gather -> [{g},{wx}]", packed_gather,
          (idx,), k, dev)
    timed("  same, Morton-local ids", packed_gather, (idx_loc,), k, dev)
    timed(f"take_along_axis [{g},{wc}]->[,{wx}] x{c}", per_take,
          (rows, rowidx), k, dev)

    # row-size curve of the moment-entry gather (ring/blk tiers): a
    # [NSUB, padw] table gathered through [G, W] ids
    nsub, w = args.nsub, args.w
    eidx = ints(0, nsub, g, w)

    def entry_gather(table_, idx_, carry):
        gat = table_[torch.clamp(idx_ + carry, 0, nsub - 1)]
        s = sum(gat[:, :, kk].sum() for kk in range(4))
        return carry + (s * 1e-30).long()

    for padw in (4, 8, 32, 64, 160):
        table = rnd(nsub, padw)
        timed(f"entry-gather [{nsub},{padw}] ({padw*4}B rows) -> "
              f"[{g},{w}]", entry_gather, (table, eidx), k, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
