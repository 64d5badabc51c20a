"""100k configuration sweep from a settled state file: steps/s and window
statistics a variant (PyTorch port of the root ``tools/ksweep2.py``).

Window sizing measured on the early cold ball does not transfer to the
equilibrium state (the polytrope core is about 8x denser), so the sweep
loads a settled checkpoint. Each --var names overrides of ``jupiter_100k``
(grad-h, Newton h, base windows --windows) from VARIANTS, the reference's
table unchanged; a run of --steps steps is timed with CUDA events after an
untimed run of the same length, then one skinned build's window
occupancy (mean/max) and the run's overflow are printed. An overflowing
variant is invalid-fast, not fast: every window is widened by 25 % and the
variant measured again, up to 2x. ``kernel_gb`` and
``grav_pair_dtype="bfloat16"`` run (the ``r5gb*`` rows; the bf16 rows
``xwk16bf`` and ``xwq09bf`` take exact lists, which the production
flags' fusion refuses, in the reference too). A variant refused prints
FAILED with the refusal, as the reference prints its failures. Runs on
the card unless ``--device cpu``.

    python -m planetmodel_sph_tpu_torch.tools.ksweep2 \
        --ck docs/results/drift100k_r3ship/state.psph --var base --var k16
"""

from __future__ import annotations

import argparse
import sys

from .. import config as config_mod
from ..models import planet
from ..ops import structure
from ..state import resolve_device
from ..utils import checkpoint
from ..utils.profiling import seconds_per_call

VARIANTS = {
    # name -> overrides on top of jupiter_100k
    "base":  dict(),
    "sg4":   dict(sg_blocks=4, blk_window=256),
    "sg8":   dict(sg_blocks=8, blk_window=256),
    "sg16":  dict(sg_blocks=16, blk_window=320),
    "k16":   dict(rebuild_every=16, sort_every=64),
    "k4":    dict(rebuild_every=4, sort_every=64),
    "sg8k16": dict(sg_blocks=8, blk_window=256, rebuild_every=16,
                   sort_every=64),
    "k32":   dict(rebuild_every=32, sort_every=64),
    "k16t":  dict(rebuild_every=16, sort_every=64, nbr_window=208,
                  p2p_window=288, m2p_window=144),
    "sub16": dict(nbr_sub=16, rebuild_every=16, sort_every=64,
                  nbr_window=352, p2p_window=480, m2p_window=288),
    "b32":   dict(nbr_group_size=32, nbr_sub=16, rebuild_every=16,
                  sort_every=64, nbr_window=288, p2p_window=416,
                  m2p_window=256),
    "b128":  dict(nbr_group_size=128, nbr_sub=32, rebuild_every=16,
                  sort_every=64, nbr_window=256, p2p_window=352,
                  m2p_window=384),
    "sub16b": dict(nbr_sub=16, rebuild_every=16, sort_every=64,
                   nbr_window=352, p2p_window=480, m2p_window=480),
    "b128s16": dict(nbr_group_size=128, nbr_sub=16, rebuild_every=16,
                    sort_every=64, nbr_window=448, p2p_window=640,
                    m2p_window=640),
    # particle-granularity SPH candidate lists (sub window = pre-filter)
    "xw512":  dict(rebuild_every=16, sort_every=64, sph_exact_window=512),
    "xw640":  dict(rebuild_every=16, sort_every=64, sph_exact_window=640),
    "xw768":  dict(rebuild_every=16, sort_every=64, sph_exact_window=768),
    # sorted-chunks ablation (per-step sort/unsort, the round-1 behavior)
    "xw768ns": dict(rebuild_every=16, sort_every=64, sph_exact_window=768,
                    sorted_chunks=False),
    "k16ns":  dict(rebuild_every=16, sort_every=64, sorted_chunks=False),
    # overflow-FREE window sizing for the finer-sub / longer-K variants
    # (the first sweep dropped interactions: sub16 tree_overflow=25.7k)
    "sub16w": dict(nbr_sub=16, rebuild_every=16, sort_every=64,
                   nbr_window=352, p2p_window=448, m2p_window=480),
    "k32w":   dict(rebuild_every=32, sort_every=64, nbr_window=240,
                   p2p_window=352, m2p_window=192),
    "b128s16w": dict(nbr_group_size=128, nbr_sub=16, rebuild_every=16,
                     sort_every=64, nbr_window=416, p2p_window=512,
                     m2p_window=896),
    # supergroup far tier with the TIGHT member-reach bmax (post-a4896f3)
    "k16sg8":  dict(rebuild_every=16, sort_every=64, sg_blocks=8,
                    blk_window=256),
    "k16sg16": dict(rebuild_every=16, sort_every=64, sg_blocks=16,
                    blk_window=320),
    "bsg8": dict(nbr_group_size=128, nbr_sub=16, rebuild_every=16,
                 sort_every=64, nbr_window=416, p2p_window=512,
                 m2p_window=896, sg_blocks=8, blk_window=256),
    "bsg4": dict(nbr_group_size=128, nbr_sub=16, rebuild_every=16,
                 sort_every=64, nbr_window=416, p2p_window=512,
                 m2p_window=896, sg_blocks=4, blk_window=192),
    # post-exact-h-solve candidates: exact SPH lists (single-trip pass1/2
    # + 2x faster Newton solve) at longer rebuild periods
    "xwk16":  dict(rebuild_every=16, sort_every=64, sph_exact_window=512),
    "xwk32":  dict(rebuild_every=32, sort_every=64, sph_exact_window=512,
                   nbr_window=240, p2p_window=352, m2p_window=192),
    "bxwk16": dict(nbr_group_size=128, nbr_sub=16, rebuild_every=16,
                   sort_every=64, nbr_window=416, p2p_window=512,
                   m2p_window=896, sph_exact_window=1024),
    "xwk16i2": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                    h_newton_iters=2),
    # accuracy-for-speed trades (drift budget 2.8e-4 vs 1e-3 target):
    # wider MAC acceptance shrinks the near-field P2P tier; bf16 pair math
    # halves the per-slot cost of the gravity sweeps
    "xwk16t08": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                     theta=0.8, p2p_window=176, m2p_window=160),
    "xwk16bf": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                    grav_pair_dtype="bfloat16"),
    # fused-gravity-era combos (one launch for all tiers): exact lists x
    # supergroup far tier (blk windows sized up — the first bsg sweep
    # overflowed the blk tier by 300k-3.6M entries, invalid numbers) x
    # theta x chunk width (chunk=256 halves the ceil-to-chunk padding of
    # the settled ~80-sub windows)
    "xwk16sg4": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                     sg_blocks=4, blk_window=768),
    "xwk16sg8": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                     sg_blocks=8, blk_window=1280),
    "xwk16c256": dict(rebuild_every=16, sort_every=64,
                      sph_exact_window=512, block_chunk=256),
    "xwk16t08sg4": dict(rebuild_every=16, sort_every=64,
                        sph_exact_window=512, theta=0.8, p2p_window=176,
                        m2p_window=160, sg_blocks=4, blk_window=768),
    # pad tiny gather-table rows to 128 B (ROUND2.md gotcha 6)
    "xwk16gp": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                    gather_pad_rows=32),
    "xw640gp": dict(rebuild_every=16, sort_every=64, sph_exact_window=640,
                    gather_pad_rows=32),
    # quadrupole far field buys theta headroom -> smaller P2P tier
    "xwq09": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                  multipole_order=2, theta=0.9, p2p_window=144,
                  m2p_window=144, gather_pad_rows=32),
    "xwq10": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                  multipole_order=2, theta=1.0, p2p_window=128,
                  m2p_window=128, gather_pad_rows=32),
    # winner-stage combos on top of the quad operating point: supergroup
    # far tier (fewer ring slots), wider chunk (less ceil-to-chunk pad),
    # longer rebuild period (build amortization; windows widened for the
    # 2x skin), and bf16 pair math (re-test at the smaller windows — the
    # net-negative verdict was measured at ~5k slots/target)
    "xwq09sg4": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                     multipole_order=2, theta=0.9, p2p_window=144,
                     m2p_window=144, gather_pad_rows=32, sg_blocks=4,
                     blk_window=768),
    "xwq09c256": dict(rebuild_every=16, sort_every=64,
                      sph_exact_window=512, multipole_order=2, theta=0.9,
                      p2p_window=144, m2p_window=144, gather_pad_rows=32,
                      block_chunk=256),
    "xwq09k32": dict(rebuild_every=32, sort_every=64, sph_exact_window=640,
                     multipole_order=2, theta=0.9, p2p_window=192,
                     m2p_window=192, gather_pad_rows=32, nbr_window=240),
    "xwq09bf": dict(rebuild_every=16, sort_every=64, sph_exact_window=512,
                    multipole_order=2, theta=0.9, p2p_window=144,
                    m2p_window=144, gather_pad_rows=32,
                    grav_pair_dtype="bfloat16"),
    # mono + K16 + padded entry gathers (the r3 drift-probe STABLE point;
    # the quad tiers pump energy at 100k — see docs/results/drift100k_v2)
    "mono_k16": dict(multipole_order=1, theta=0.7, rebuild_every=16,
                     sort_every=64, gather_pad_rows=32),
    "mono_k16x": dict(multipole_order=1, theta=0.7, rebuild_every=16,
                      sort_every=64, gather_pad_rows=32,
                      sph_exact_window=896),
    # quad + wide theta on the PLAIN group-window SPH path: the recovery
    # sweep measured every sph_exact_window variant neutral-to-worse at
    # the settled point (the exact rows overflow at 512 and the widen
    # retry penalizes all windows), while quad theta alone cut the p2p/m2p
    # maxima 254->150/141->78 — the two effects compose only here.
    # p2p/m2p sized from the measured settled maxima + margin.
    "q09": dict(rebuild_every=16, sort_every=64, multipole_order=2,
                theta=0.9, p2p_window=192, m2p_window=112,
                gather_pad_rows=32),
    "q10": dict(rebuild_every=16, sort_every=64, multipole_order=2,
                theta=1.0, p2p_window=160, m2p_window=96,
                gather_pad_rows=32),
    "q10c256": dict(rebuild_every=16, sort_every=64, multipole_order=2,
                    theta=1.0, p2p_window=160, m2p_window=96,
                    gather_pad_rows=32, block_chunk=256),
    "q10k32": dict(rebuild_every=32, sort_every=64, multipole_order=2,
                   theta=1.0, nbr_window=240, p2p_window=192,
                   m2p_window=112, gather_pad_rows=32),
    "q10sg4": dict(rebuild_every=16, sort_every=64, multipole_order=2,
                   theta=1.0, p2p_window=160, m2p_window=96,
                   gather_pad_rows=32, sg_blocks=4, blk_window=768),
    # exact SPH lists ON TOP of the q10 winner, sized ABOVE the measured
    # ~770-candidate refined maximum (the earlier xw512 rows overflowed
    # and the auto-widen retry penalized every window — 'neutral-to-
    # worse' was a measurement artifact, not a verdict; ROUND2.md).
    "q10x896": dict(rebuild_every=16, sort_every=64, multipole_order=2,
                    theta=1.0, p2p_window=160, m2p_window=96,
                    gather_pad_rows=32, sph_exact_window=896),
    "q10x1024": dict(rebuild_every=16, sort_every=64, multipole_order=2,
                     theta=1.0, p2p_window=160, m2p_window=96,
                     gather_pad_rows=32, sph_exact_window=1024),
    # finer sub-AABBs shrink the exact candidate set (the refine filter
    # starts from the sub-block window); windows in sub16 units
    "q10x768s16": dict(rebuild_every=16, sort_every=64, multipole_order=2,
                       theta=1.0, nbr_sub=16, nbr_window=384,
                       p2p_window=320, m2p_window=192,
                       gather_pad_rows=32, sph_exact_window=768),
    # round-3: sub-block-granularity true-pair refinement (keeps the
    # tuned tile gathers, drops dead rows) on the tracked-h preset,
    # mono and quad far field
    "r3base": dict(),
    "r3sbr":  dict(sph_refine_subblock=True),
    "r3q10":  dict(multipole_order=2, theta=1.0),
    "r3q10sbr": dict(multipole_order=2, theta=1.0,
                     sph_refine_subblock=True),
    # + post-refine window truncation (per-step gathers are capacity-
    # shaped; refined max measured 64 of the 240 AABB capacity)
    "r3sbr96":  dict(sph_refine_subblock=True, sph_refined_window=96),
    "r3sbr80":  dict(sph_refine_subblock=True, sph_refined_window=80),
    "r3sbr96k32": dict(sph_refine_subblock=True, sph_refined_window=96,
                       rebuild_every=32),
    # + impulse-RESPA multirate far field (respa_every)
    "r3sbr96r4": dict(sph_refine_subblock=True, sph_refined_window=96,
                      respa_every=4),
    "r3sbr96k32r4": dict(sph_refine_subblock=True, sph_refined_window=96,
                         rebuild_every=32, respa_every=4),
    "r3sbr96k32r8": dict(sph_refine_subblock=True, sph_refined_window=96,
                         rebuild_every=32, respa_every=8),
    # quad far field under RESPA: the 10-field dense far scan that made
    # q10 lose at full rate is divided by respa_every, while its ~2x
    # smaller P2P tier pays off every inner step
    "r3q10sbr96k32r8": dict(multipole_order=2, theta=1.0,
                            sph_refine_subblock=True,
                            sph_refined_window=96,
                            rebuild_every=32, respa_every=8),
    # + capacity-tightened gravity windows (gathers are capacity-shaped;
    # q10 K=32 maxima measured p2p ~166, m2p ~100)
    "r3q10sbrk32r8w": dict(multipole_order=2, theta=1.0,
                           sph_refine_subblock=True,
                           sph_refined_window=96,
                           rebuild_every=32, respa_every=8,
                           p2p_window=192, m2p_window=128),
    # mono with a wider MAC (smaller P2P tier, monopole-only error)
    "r3t08sbrk32r8": dict(theta=0.8, sph_refine_subblock=True,
                          sph_refined_window=96,
                          rebuild_every=32, respa_every=8),
    # round-3 finisher: the preset IS the ship point now, so these are
    # small deltas on top of it (run with --windows 240,192,128 to match
    # the preset capacities).
    "r3ship": dict(),
    # wider quad MAC: moves P2P pairs into the RESPA'd (amortized) ring/
    # far tiers. CAUTION (ADVICE r3): the Salmon-Warren bmax MAC only
    # guarantees multipole convergence for theta < 1 — at theta >= 1 an
    # accepted node can have r < bmax where the expansion DIVERGES, so a
    # timing win here is not adoptable without a full drift validation
    # (tools/drift100k.py --set theta=...), not just 64-step timing.
    "r3t12": dict(theta=1.2, p2p_window=160, m2p_window=160),
    "r3t14": dict(theta=1.4, p2p_window=144, m2p_window=192),
    # tighter post-refine truncation (settled refined max measured 64)
    "r3w80": dict(sph_refined_window=80),
    "r3t12w80": dict(theta=1.2, p2p_window=160, m2p_window=160,
                     sph_refined_window=80),
    "r3r16": dict(respa_every=16),
    "r3t12w80r16": dict(theta=1.2, p2p_window=160, m2p_window=160,
                        sph_refined_window=80, respa_every=16),
    # round-4 levers (VERDICT r3 next-round #1), all on the shipped
    # stack (preset defaults incl. grav_com_correction):
    # (a') finer SOURCE sub-blocks: tighter sub-AABBs move P2P pairs
    # into the sub-MAC ring tier, which RESPA amortizes 8-fold — the
    # round-3 'sub=32 beats sub=16' verdict predates RESPA, when the
    # ring paid full rate every step. Windows in sub-16 units.
    "r4s16": dict(nbr_sub=16, nbr_window=480, sph_refined_window=192,
                  p2p_window=384, m2p_window=256),
    # (c) tile-height halving: [B,CHUNK] masked-slot waste shrinks for
    # ~52-neighbor rows, and the tighter target AABB sharpens the MAC
    "r4b32": dict(nbr_group_size=32, nbr_sub=16, nbr_window=288,
                  sph_refined_window=112, p2p_window=320, m2p_window=192),
    "r4b32s32": dict(nbr_group_size=32, nbr_sub=32, nbr_window=144,
                     sph_refined_window=64, p2p_window=160, m2p_window=96),
    # (b) particle-exact SPH lists re-measured WITH padded gather rows
    # (the 'net slower' verdict predates the tiny-row-gather fix) on top
    # of the full r3 stack; capacity above the measured ~770 candidate
    # max. fuse_p2p_sph off: the fusion rides sub-granular SPH window
    # rows, which exact lists replace (structure.fuse_active raises).
    "r4x896": dict(sph_exact_window=896, fuse_p2p_sph=False),
    "r4x1024": dict(sph_exact_window=1024, fuse_p2p_sph=False),
    # longer far-field period at the ship point (r3 finisher, unmeasured)
    "r4r16": dict(respa_every=16),
    "r4w80": dict(sph_refined_window=80),
    "r4w80r16": dict(sph_refined_window=80, respa_every=16),
    # (a) pass-2 P2P fusion (VERDICT r3 next-round #1a): the SPH-window
    # sub-blocks get their near gravity inside the pass-2 sweep over the
    # ALREADY-gathered geometry rows, leaving the p2p tier only the
    # non-SPH near sub-blocks — so its window capacity (gathers are
    # capacity-shaped) can shrink to the measured residual maxima.
    "r4fuse": dict(fuse_p2p_sph=True),
    "r4fusep96": dict(fuse_p2p_sph=True, p2p_window=96),
    "r4fusep64": dict(fuse_p2p_sph=True, p2p_window=64),
    # measured (first r4 sweep): fusion drops the residual p2p max
    # 168 -> 108, so 112 is the exact clean capacity; p96 overflowed and
    # the auto-widen retry (120) cost ~1.7 steps/s of gather width
    "r4fusep112": dict(fuse_p2p_sph=True, p2p_window=112),
    "r4fusew80": dict(fuse_p2p_sph=True, sph_refined_window=80,
                      p2p_window=112),
    "r4fuser16": dict(fuse_p2p_sph=True, p2p_window=112, respa_every=16),
    "r4fusew80r16": dict(fuse_p2p_sph=True, sph_refined_window=80,
                         p2p_window=112, respa_every=16),
    # round-5 headroom probes on the shipped r4 point (preset defaults
    # = fused ship; adoption needs a fresh 12k drift validation):
    # tighter truncation (settled refined max 65) and far field once
    # per rebuild period
    "r5w72": dict(p2p_window=112, sph_refined_window=72),
    "r5r32": dict(p2p_window=112, respa_every=32),
    "r5w72r32": dict(p2p_window=112, sph_refined_window=72,
                     respa_every=32),
    # capacity-hugging m2p (settled ring max 96) and narrower chunk (less
    # ceil-to-chunk padding at the shrunken per-step windows)
    "r5m112": dict(p2p_window=112, m2p_window=112),
    "r5c256": dict(p2p_window=112, block_chunk=256),
    # round-5 fixed-cost probes: the r5 stage profile (profile_block at
    # the settled point) shows a 2-trip p2p sweep costing ~as much as a
    # 3-trip pass1 — per-GROUP fixed costs ~2us dominate at the shrunken
    # windows, and the sweeps run at 40-45G slot-evals/s vs the ~100G
    # VPU pair-math ceiling. kernel_gb amortizes the fixed cost (gb=8
    # was rejected at the ROUND-2 operating point with 3x wider windows;
    # the trade moved), chunk 256 cuts ceil-to-chunk slot quantization
    # (1536 -> 1280 evaluated at avg nv 1184), b128/s16 re-test group
    # height and sub granularity under the round-4 cost structure.
    "r5gb2": dict(p2p_window=112, kernel_gb=2),
    "r5gb4": dict(p2p_window=112, kernel_gb=4),
    "r5gb4c256": dict(p2p_window=112, kernel_gb=4, block_chunk=256),
    "r5b128": dict(p2p_window=160, nbr_group_size=128, nbr_window=320,
                   m2p_window=192, sph_refined_window=112),
    "r5s16": dict(p2p_window=224, nbr_sub=16, nbr_window=480,
                  m2p_window=256, sph_refined_window=160),
    # residual-P2P merge (cfg.fuse_p2p_residual): the separate near-tier
    # launch folds into pass 2 — one launch fewer per step
    "r5mg": dict(p2p_window=112, fuse_p2p_residual=True),
    "r5mgm112": dict(p2p_window=112, m2p_window=112,
                     fuse_p2p_residual=True),
    # merge x chunk 256: with the p2p rows inside pass 2, the sph
    # window's ceil-to-chunk quantization (1536 evaluated slots for avg
    # nv 1184 at chunk 512) is the remaining slot waste
    "r5mgc256": dict(p2p_window=112, fuse_p2p_residual=True,
                     block_chunk=256),
    "r5mgw72": dict(p2p_window=112, fuse_p2p_residual=True,
                    sph_refined_window=72),
    # gb under the MERGE: the bigger two-launch step changes the
    # batching trade the unmerged gb=2 row rejected
    "r5mggb2": dict(p2p_window=112, fuse_p2p_residual=True, kernel_gb=2),
}


WINDOW_KEYS = ("nbr_window", "p2p_window", "m2p_window", "blk_window",
               "sph_exact_window", "sph_refined_window")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ck",
                    default="docs/results/drift100k_r3ship/state.psph")
    ap.add_argument("--var", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--windows", default="240,192,128",
                    help="base nbr,p2p,m2p windows (default = the "
                         "jupiter_100k preset capacities, so 'r3ship' "
                         "with no flags measures the actual ship point)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="SimConfig override of every variant (repeatable)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = args.var or ["base", "sg8", "k16", "sg8k16"]
    extra = config_mod.parse_overrides(args.set)

    state, _, step0 = checkpoint.load(args.ck, device=dev)
    print(f"checkpoint at step {step0}", flush=True)
    nw, pw, mw = (int(x) for x in args.windows.split(","))

    for name in names:
        widen = 1.0
        while True:
            r16 = lambda v: -(-int(v * widen) // 16) * 16
            kw = dict(grad_p_mode="grad_h", h_mode="newton",
                      nbr_window=r16(nw), p2p_window=r16(pw),
                      m2p_window=r16(mw))
            for k, v in VARIANTS[name].items():
                kw[k] = r16(v) if k in WINDOW_KEYS else v
            label = name if widen == 1.0 else f"{name}*{widen:g}"
            try:
                cfg = config_mod.jupiter_100k(**{**kw, **extra})
                dt, (_, info) = seconds_per_call(
                    lambda: planet.run_info(state, cfg, args.steps), dev)
                dt /= args.steps
                skin = planet._skin(cfg, state.vel, state.accel)
                st = structure.build(state.pos, state.h, state.mass, cfg,
                                     skin=skin)
                over = (int(info["nbr_overflow"]),
                        int(info["tree_overflow"]))
                am = lambda v: f"{float(v.float().mean()):.0f}/{int(v.max())}"
                print(f"{label:12s}: {dt*1e3:6.1f} ms/step = "
                      f"{1/dt:5.1f} steps/s  windows avg/max: "
                      f"sph {am(st.n_sph)} p2p {am(st.n_p2p)} "
                      f"m2p {am(st.n_m2p)} blk {am(st.n_blk)} "
                      f"over={over}", flush=True)
                if sum(over) == 0 or widen >= 2.0:
                    break
                widen = round(widen * 1.25, 4)
            # a variant the port refuses prints its refusal, as the
            # reference prints its failures
            except Exception as e:          # noqa: BLE001
                print(f"{label}: FAILED {str(e)[:160]}", flush=True)
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
