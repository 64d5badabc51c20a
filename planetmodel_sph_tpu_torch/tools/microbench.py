"""Micro-benchmarks of the block pipeline: window-row gathers and pass-1
tile widths (PyTorch port of ``tools/microbench.py``).

    python -m planetmodel_sph_tpu_torch.tools.microbench [--k 8]
        [--only gather,tiles] [--device cuda|cpu] [--g G --w W --navg N]

Runs on the card unless ``--device cpu`` is given. Every variant runs `k`
data-dependent calls (each one's input takes a term of the previous one's
output) after a warm-up of the same shape, timed from a synchronize to a
synchronize. The gathers: four variants in plain PyTorch (the reference's
XLA forms) and the hand-written ``probe_gather`` kernel; the tiles: the
``probe_pass1_tile`` kernel at SG = 1, 4 and 8 target groups per thread
block. Inputs come from a ``torch.Generator`` seeded with `seed` (another
random stream than the reference's).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops.cuda import probes
from ..state import resolve_device


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(label, fn, k, dev):
    """Seconds per call of fn(cc) over k data-dependent calls (fn returns
    the next carry), after one warm-up call; prints the reference's
    line."""
    cc = fn(torch.zeros((), device=dev))
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(k):
        cc = fn(cc)
    s = float(cc)
    dt = (time.perf_counter() - t0) / k
    print(f"{label:44s} {dt*1e3:9.2f} ms   ({s:.3e})", flush=True)
    return dt


def _normal(gen, shape, dev):
    return torch.randn(shape, generator=gen).to(dev)


def bench_gathers(nb=2067, bsz=64, g=2067, w=96, c=7, k=8, seed=0,
                  device="cuda"):
    """[NB, B] source fields + [G, W] window ids -> [G, W*B] rows, five
    ways. Returns {variant: seconds per call}."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    cols = [_normal(gen, (nb * bsz,), dev) for _ in range(c)]
    idx = torch.randint(0, nb, (g, w), generator=gen,
                        dtype=torch.int32).to(dev)
    total_mb = g * w * bsz * c * 4 / 1e6
    print(f"[gather] nb={nb} bsz={bsz} g={g} w={w} c={c} -> {total_mb:.0f} MB "
          f"out", flush=True)
    li = idx.long()

    def fields(cc):
        return [cols[0] + cc] + cols[1:]

    def v_packed(cc):
        """Interleaved stack + one row gather + per-field slices."""
        packed = torch.stack(fields(cc), dim=-1).reshape(nb, bsz * c)
        gat = packed[li].reshape(g, w, bsz, c)
        outs = [gat[..., j].reshape(g, w * bsz) for j in range(c)]
        return cc + 1e-12 * outs[0][0, 0]

    def v_perfield(cc):
        """Per-field row gather from the [NB, B] view."""
        outs = [x.reshape(nb, bsz)[li].reshape(g, w * bsz)
                for x in fields(cc)]
        return cc + 1e-12 * outs[0][0, 0]

    def v_take(cc):
        """Per-field index_select row gather."""
        fl = li.reshape(-1)
        outs = [torch.index_select(x.reshape(nb, bsz), 0, fl).reshape(
            g, w * bsz) for x in fields(cc)]
        return cc + 1e-12 * outs[0][0, 0]

    def blockpacked(cc):
        return torch.cat([x.reshape(nb, bsz) for x in fields(cc)], dim=1)

    def v_blockpacked(cc):
        """Block-major packing [NB, c*B], one row gather, per-field
        slices."""
        gat = blockpacked(cc)[li]
        outs = [gat[:, :, j * bsz:(j + 1) * bsz].reshape(g, w * bsz)
                for j in range(c)]
        return cc + 1e-12 * outs[0][0, 0]

    def v_kernel(cc):
        """The hand-written gather: one warp per (g, w) row."""
        gat = probes.probe_gather(blockpacked(cc), idx)
        return cc + 1e-12 * gat[0, 0, 0]

    return {
        "packed": timed("gather packed-interleaved (current)", v_packed, k,
                        dev),
        "perfield": timed("gather per-field rows", v_perfield, k, dev),
        "take": timed("gather per-field take", v_take, k, dev),
        "blockpacked": timed("gather block-packed concat", v_blockpacked, k,
                             dev),
        "kernel": timed("gather probe_gather kernel", v_kernel, k, dev)}


def tile_inputs(g=2067, bsz=64, w=96, navg=35, sg=1, seed=0,
                device="cuda"):
    """One SG's inputs: (nv [gb], 4 target columns [gb*tb, 1], 5 rows
    [gb, s]) of random normals, nv = navg * bsz slots everywhere."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed * 1000 + sg)
    gb, tb, s = g // sg, sg * bsz, w * bsz
    nvec = torch.full((gb,), navg * bsz, dtype=torch.int32, device=dev)
    tgt = [_normal(gen, (gb * tb, 1), dev) for _ in range(4)]
    rows = [_normal(gen, (gb, s), dev) for _ in range(5)]
    return nvec, tgt, rows


def bench_kernel_tiles(g=2067, bsz=64, w=96, chunk=512, navg=35, k=8,
                       seed=0, supers=(1, 4, 8), device="cuda"):
    """The pass-1 sweep with SG consecutive groups fused into one thread
    block (target tile SG*B), window rows shared per block. Returns
    {SG: (seconds per call, Gpair/s)}."""
    dev = resolve_device(device)
    out = {}
    for sg in supers:
        nvec, tgt, rows = tile_inputs(g, bsz, w, navg, sg, seed, dev)
        gb, tb = g // sg, sg * bsz
        pairs = gb * tb * navg * bsz / 1e9

        def run(cc):
            tg = [tgt[0] + cc] + tgt[1:]
            rho = probes.probe_pass1_tile(nvec, tg, rows, tb=tb, chunk=chunk)
            return cc + 1e-12 * rho[0, 0]

        dt = timed(f"pass1-style SG={sg} tile=[{tb},{chunk}]", run, k, dev)
        print(f"    -> {pairs / dt:.1f} Gpair/s", flush=True)
        out[sg] = (dt, pairs / dt)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="microbench")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument("--g", type=int, default=2067,
                    help="target groups (and gather source blocks)")
    ap.add_argument("--w", type=int, default=96, help="window blocks")
    ap.add_argument("--navg", type=int, default=35,
                    help="valid window blocks of the tile sweep")
    args = ap.parse_args(argv)
    want = set(args.only.split(",")) if args.only else None
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    if want is None or "gather" in want:
        bench_gathers(nb=args.g, g=args.g, w=args.w, k=args.k, device=dev)
    if want is None or "tiles" in want:
        bench_kernel_tiles(g=args.g, w=args.w, navg=args.navg, k=args.k,
                           device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
