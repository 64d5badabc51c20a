#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``planetmodel_sph_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--parent DIR]

It never imports JAX or the JAX package. Phases, any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the twelve CUDA kernels from ``planetmodel_sph_tpu_torch/csrc``;
3. load: the settled 100k state ``docs/results/drift100k_r5ship/state.psph``
   with the config in its header, onto the card;
4. kernels: each windowed kernel's inputs are recorded at the first rebuild
   of that state (one chunk set-up, one RESPA inner force evaluation, one
   far evaluation), then each kernel runs on them and is held against its
   plain PyTorch version (in slices of groups), and both are timed. The
   same is done on the inputs of each leg of the general grid + tree step
   below, recorded on the leg's own first evaluation, for every kernel the
   leg launches: `sym100k` (``filter_sph``, ``pass1_sym``, ``pass2``
   symmetric without gravity, ``p2p``, the far-only ``gravity_fused`` at
   its windows, and ``gravity_fused`` with its near tier for the every-tier
   steps), `settle100k` (``filter_sph``, ``pass1_gradh`` and the far-only
   ``gravity_fused`` at its doubled windows, the merged grad-h ``pass2``
   with viscosity, and again with the Balsara sums) and `parity3k`
   (``gravity_fused`` with monopoles, the near tier and receiver softening
   at n = 3000, and the two all-pairs kernels in its modes); and on extras
   no leg runs: ``p2p`` and ``gravity_fused`` under receiver softening at
   the 100k shapes, ``pass2`` asymmetric with the sign bug, symmetric
   with fused gravity under receiver softening, and `settle100k`'s
   Balsara inputs with the energy column; and on group sizes no leg runs,
   recorded on the settled state's first chunk set-up under each (windows
   widened until overflow is 0): b = 512, two blocks a group, in the
   production form (``filter_sph``, ``pass1_gradh``, the merged grad-h
   ``pass2``, the far-only ``gravity_fused``) and under `sym100k`'s step
   (``pass1_sym``, ``pass2``, ``p2p``, ``gravity_fused`` with its near
   tier), b = 1024 for ``filter_sph``'s second word of boxes, b = 33
   for ``p2p``'s one-target tail, and b = 9,821 and 16,384 for
   ``filter_sph``'s tiled path (a group past one block's shared memory
   cut into tiles, one block a group and tile in one grid, their masks
   ORed); and the bf16 instances
   (``grav_pair_dtype="bfloat16"``), each a twin of an f32 case on the
   same inputs with ``bf16=True`` against its plain bf16 version:
   ``p2p`` min-h and ``receiver_h`` at `sym100k` and at b = 33, and
   ``gravity_fused`` far only at the production shapes and at
   `sym100k`'s, with its near tier at `sym100k`'s every-tier inputs, with
   the blk tier at `sg100k`'s and with monopoles under receiver softening
   at `parity3k`'s; each as its f32 twin (two launches the same bits,
   planted NaNs, registers and spills), plus its difference from the f32
   twin (at least 1e-4 of max|g|) and both instances timed in turns (f32,
   bf16, bf16, f32: wrapper ms and device ms). The two all-pairs kernels
   are held against theirs on primed ``ics.jupiter`` particles at n = 3000
   and n = 32768, every case at both sizes: pass 1 with both softenings
   and without gravity, pass 2 symmetric, asymmetric with the sign bug,
   and symmetric with viscosity and the Balsara limiter on a rotating,
   contracting velocity field, each also with a non-finite value planted
   in one field of one particle at a time, at two particles (a NaN and a
   +inf x, a NaN h and m; for pass 2 the pressure and the velocity), the
   outputs NaN exactly where the plain version's are, and a second launch
   held to the same bits; each case prints the share of pairs inside
   either support and the share the q^2 test skips, and its instance's
   registers and spills. From the plan's size on (``pairwise.PLAN_MIN_N``)
   each case runs with a plan built from its positions, as the main path
   does, on the cold ball and on the ball past its first collapse
   (COLLAPSE_STEPS on); it prints the plan's near share, the values are
   planted after the plan was built (the planted particle's sub-tile far
   from most warps: the share of boxes far from it is printed), and its
   bound counts the planned sweep's work. Then the plan's cost and gain
   (``plan n=`` lines, PLAN_SIZES): both sweeps with a plan (its build
   included) and without, in turns, wrapper and device ms, and the plan
   alone. For every case of the six redesigned kernels it
   also prints what
   the kernel visits (the three compacted sweeps ``pass1_gradh``,
   ``pass1_sym`` and ``pass2``: the share of slots below nv that are live
   and of live pairs inside the support, and the share ``pass1_sym``'s
   skip leaves out; ``p2p``: the live share, every live pair evaluated;
   ``gravity_fused``: the far entries accepted and live, the ring, blk
   and near-tier slots live; ``filter_sph``: the live slots kept and
   pre-rejected whole by the bounding boxes, the boxes whose targets a
   live slot tests and
   its exact tests beside the tests the bound charges), the instance's
   registers, shared memory and spills from the build's ``-Xptxas -v``
   log (phase 2 prints every instance), and holds a second launch on the
   same inputs to the same bits. In every case of ``pass1_gradh``,
   ``pass1_sym``, ``pass2``, ``p2p``, ``gravity_fused`` and ``filter_sph``
   it plants NaNs, one field at a time (m, cc, a velocity row, ih; for
   ``pass1_sym`` and ``p2p`` also a dead slot, m = 0, with a NaN x or ih,
   and for ``gravity_fused`` with a near tier such a slot of its P2P
   window; for the filter x, sc, ssk and m of a slot it keeps, tc and tsk
   of its group's targets), where a kernel leaves out work: each output must be
   NaN exactly where the plain version's is (the filter's mask equal to
   it). Every case
   prints its wrapper time ``ms`` (CUDA events
   from before the wrapper's host work to after its kernel) beside
   ``device_ms`` (the kernel's own duration, torch.profiler), and the
   production ``pass1_gradh`` and ``pass2`` their host time a wrapper call
   (``host_us``). ``probe_launch`` and the production ``pass1_gradh`` are
   launched on a side stream and inside a CUDA graph capture and held
   against their plain versions (a stale stream handle would show); the
   launch probe prints an eager wrapper call and a launch replayed from a
   CUDA graph, beside ``torch.mul``;
5. main paths, each with the launch counts reset just before and read just
   after: ``planet.run_info`` for 64 steps of the 100k state (two K=32
   chunks, one sort_every=64 period), then the dense ``jupiter_3k`` path
   from its initial conditions (``ics.jupiter`` -> ``planet.prime`` -> a
   warm-up run -> the timed ``planet.run_info``) at n = 3000 for 200 steps
   and at n = 32768 for 20; overflow counters, finiteness, neighbour
   counts, momentum and energy. Then the general grid + tree step in three
   configurations: `sym100k` (the settled 100k state under the unfused
   symmetric step with relax-mode h: 64 RESPA steps, then 8 with every tier
   in one launch per step), `settle100k` (the drift protocol's settle
   phase from a raw n = 100,000 polytrope: grad-h with viscosity and
   velocity damping, 16 steps, then 8 with the Balsara limiter) and
   `parity3k` (the ``parity`` preset at n = 3000, 100 steps). Then the
   bf16 gravity pair path, each leg primed again under its own
   configuration and beside its f32 twin, run from the same state just
   before it: `prod100k_bf16` (the settled state under the production
   flags with ``grav_pair_dtype="bfloat16"``, 64 steps: every far-only
   ``gravity_fused`` launch of the bf16 instance, pass 2's merged near
   window f32 as in the reference) and `sym100k_bf16` (`sym100k`'s state,
   64 RESPA steps, every ``p2p`` and far-only launch bf16, then 8
   every-tier steps): the bf16 instances' launch counts
   (``launch.BF16_LAUNCHES``), overflow 0, finite fields, steps/s and the
   energy change beside the twin's, and each leg's first evaluation
   against f32 inside the reference's band (phi rtol 5e-3, grad phi 1e-2
   of max; ``tests/test_structure.py``). Then the
   energy equation and the supergroup far tier: `adia100k` (the settled
   100k state under the adiabatic EOS with viscosity, its internal energy
   evolved: 64 steps of the cached production chunk through the merged
   grad-h ``pass2`` with the energy column, then 8 steps without viscosity:
   the three-velocity layout), `basalt4k` (the ``basalt_impact`` preset at
   its own n = 4096: a basalt body into an ice body under the Tillotson
   EOS, dense, CFL timestep, 100 steps; the energy columns of
   ``ops/dense.py`` run on the card and no hand kernel is launched, as in
   the reference, whose all-pairs kernels have no energy column either),
   `basalt100k` (the same impact at n = 100,000 on grid neighbours with
   tree gravity, 16 uncached steps: cgs magnitudes through ``pass1_sym``,
   the symmetric ``pass2`` with viscosity and the energy column, and
   ``gravity_fused`` with monopoles) and `sg100k` (`sym100k` with the
   supergroup far tier, sg_blocks=4: 64 RESPA steps, then 8 with every tier
   in one launch). Phase 4 holds every kernel these legs launch against its
   plain version on the leg's own first inputs, and the four probes of the
   tools (``probe_fma``, ``probe_launch``, ``probe_gather``,
   ``probe_pass1_tile`` at SG 1, 4 and 8, two launches the same bits, and
   at SG 1 and 8 a NaN, an +inf and a finite 1e13 planted one at a time
   at a dead slot below nv, a slot in [nv, span) and one past the span
   (their x), a target's ih and x, a live and a dead m: NaN and
   infinities where the plain version has them, the rest within
   TILE_TOL) against theirs at the reference tools' shapes. Then (5e)
   the port's ``tools.roofline`` and ``tools.microbench``, the probes'
   main path: the card's dispatch
   latency, memory stream, f32 FMA rate and launch cost beside the
   published peaks, ``count_work`` at the settled state and the modeled
   floor against the main path's measured step, the five gather variants
   and the three tile widths; and (5f) `exact100k` (the settled state
   under particle-exact SPH lists, ``sph_exact_window=896``, unfused: 64
   steps of the cached grad-h Newton chunk, the h-solve's own exact lists
   included), `unsorted100k` (the production step with
   ``sorted_chunks=False``, 64 steps, held against the sorted main path's
   state at rtol 2e-5, atol 1e-6, counts equal) and `dense3k_k4`
   (``jupiter_3k`` at n = 3000 with rebuild_every=4, 200 steps); and
   (5g) ``cli run --debug-nans``: the settled state's 64-step run without
   the flag, with, with, without, the same bits, launches and overflow 0
   with both walls printed, then the state with one NaN mass, which must
   stop with a ``FloatingPointError`` naming a field, a step and the first
   op or kernel, and write no checkpoint;
6. small input: the 2048 innermost particles run 8 steps of the cached
   pipeline and 8 of the unfused symmetric one, and 512 particles from
   ``ics.jupiter`` 8 steps of the dense one, on the card and on the CPU
   (plain versions, which the CPU tests hold against the JAX package), and
   the two results must agree; 8 adiabatic steps with viscosity of the
   same 2048 particles, where the evolved u must agree too; and the 2048
   particles through ``planet.init_carry`` and 8 ``planet.step_carry``
   calls;
7. only with ``--parent DIR``, DIR a checkout of another commit (unpacked
   with ``git archive`` into a git-ignored directory): phase 2 also builds
   DIR's six redesigned kernels (``pass1_gradh``, ``pass1_sym``,
   ``pass2``, ``gravity_fused``, ``filter_sph``, ``p2p``) and its two
   all-pairs kernels and its ``probe_pass1_tile`` into DIR's own build
   directory (``filter_sph``'s one-block instances must have DIR's SASS,
   instruction for instruction, ``cuobjdump``), phase 4 times them and this checkout's in turns (parent,
   this, this, parent) on each case's inputs (a bf16 case its bf16
   instances; ``gravity_fused``'s and ``p2p``'s cases each turn's device
   ms too; the all-pairs kernels through the other checkout's own
   wrappers, loaded from its source (``parent_pairwise``), wrapper and
   device ms of each turn, and with the plan's sizes; the tile probe
   also with the parent's device time), and this phase times the two probes
   (``probe_launch`` in a chain beside ``torch.mul``, ``probe_gather``
   beside ``packed[idx]``) and runs the production step, `sym100k`,
   `sg100k` and `dense32k` (README's commands) from both checkouts, each
   in its own processes, in the same turns (``bench --repeat 3``), and
   each checkout's sorted and unsorted chunks against each other;
8. long horizon (this checkout only, after phase 7), each run a process of
   its own started as a user starts it (``python -m ...``), its launch
   counts reset before and read after, every kernel its path runs
   required to have launched: (a) ``tools.drift100k`` at its defaults (a
   2,000-step settle from ``ics.polytrope``, then a 10,000-step drift of
   the ``jupiter_100k`` preset in 500-step chunks) into a fresh directory
   under ``chiprun_out/long_horizon``, whose ship gate must pass (the four
   gate numbers, each phase's steps/s and any retried chunk printed);
   (b) ``tools.rotating_l_check`` from the settled state, omega 0.01, 3,000
   steps, windows x1.5: overflow 0, energy finite, |dL|/|L| and the energy
   drift per 10k steps printed; (c) ``tools.equilibrium_run --preset
   jupiter_3k --steps 10000``: its four artifacts, the PNG mostly lit;
   (d) ``tools.drift_probe --probe ctrl --steps 1000`` from (a)'s final
   checkpoint; (e) ``bench --lines``: two JSON lines with a value above 0
   and no error; (f) ``cli run --preset jupiter_3k --steps 40`` with frames
   every 10 steps, a GIF, a final PNG, ``--render-blocks`` (skipped on the
   dense step, as the reference does) and ``--serve 0``, paused from the
   viewer once its first frame is up while ``/diag.json`` and
   ``/points.bin`` are read, then resumed; and ``cli run --restore`` of the
   settled state for 8 steps with ``--render-blocks``, whose overlay adds
   one ``filter_sph`` launch to the chunk's two. The reference's published
   results are printed beside these, never in their place;
9. the replicated data-parallel path (``parallel/dp.py``), each leg's ranks
   processes of their own started by ``parallel.mesh.spawn`` (the kernels
   are built in phase 2, so no rank runs ``nvcc``): ``dp.make_run_info``
   for 64 steps of the settled state at the production flags, (a) at world
   size 1 over NCCL, held against phase 5's ``planet.run_info`` of the
   same state (pos rtol 2e-3 atol 2e-3, rho rtol 2e-3: dp against one
   device in ``tests/test_parallel.py``; overflow 0 in both), and (b) at 2
   and 4 ranks sharing the one card over gloo (NCCL refuses two ranks on
   one card), 50,000 and 25,000 targets a rank from the state's rows in
   Morton order, each held against (a) by the same bounds; rank 0 of (b)
   records the four kernels' inputs on its first evaluation, where its G
   target groups differ from the NB source blocks, and each is held
   against its plain version as in phase 4. Every rank's launch counts
   must be the single path's for its steps; the legs print their steps/s,
   G and NB and the launches summed over the ranks beside the single
   path's. (c) ``cli run --preset jupiter_3k --devices 2 --steps 64
   --diag-every 32`` must exit 0 with the clamp to the one card, its
   steps/s and drift lines, and ``--n 511 --devices 2`` on the CPU exit 2.
   This is no scaling measurement: one card holds every rank;
10. the halo layout (``parallel/halo.py``), each run a process of its own
   started as a user starts it: (a) ``tools.settle_ball --n 32768`` (leg
   0: the n/2 ball settled on the card, its occupancy line and the probe
   at the legs' windows, overflow 0, saved under ``chiprun_out/halo``);
   (b) ``tools.halo_collision --n 32768 --ball-ck <a's ball> --device
   cuda:0``: 8 gloo ranks sharing the card, R = 3, leg 1 (8 segments of 8
   steps in both layouts: finite, overflow 0 in both, |dpos| p99 <= 1e-3
   of the scale; |dvel| p99, the share off by more than 1e-3 of the scale,
   the violations a segment and ``pair_duplicates`` printed beside the
   reference's 32k run; the tool's exit 2 accepted only when its own
   |dvel| bar is what it missed) and leg 2 (2,000 steps through the impact
   under ``halo.run_resharded``: finite, overflow 0, re-shards, violations,
   energy, momentum and steps/s printed), every halo kernel launched on
   each leg (the ranks' counts, summed), and rank 0's inputs of each
   windowed kernel's first call held against its plain version as in
   phase 4; (c) ``tools.halo_debug 2048``: the unbounded-occupancy line
   and 8 finite segments; (d) ``cli run --set dp_mode=halo --devices 8``,
   clamped to the one card, must exit non-zero refusing 2R >= D by name;
11. the developer tools, each a process of its own at one setting:
   ``profile_build`` on the settled state, ``scaling_bench`` (the dense
   path at n = 3000 and 10,000, the grid path at 30,000 and 100,000),
   ``neighbors_of`` (no true neighbour missing), ``span_stats``, one
   ``ksweep`` and one ``ksweep2`` variant, ``micro_gather``: exit 0 and
   their table lines; then ``profile_block --ck <state> --k 4`` (every
   stage label of the reference's, with a finite checksum),
   ``trace_run --steps 16`` (its trace under ``chiprun_out/tools/trace``)
   and ``trace_summary --by-category`` on it (eight categories that sum
   to its total, hand kernels among them, and the idle share of the
   traced window and of the untraced run).

``--halo-only`` runs phases 1, 2, 10 and 11 alone (a trial: no kernel
line, no final line). ``--only gravity_fused,p2p`` (any windowed kernels)
runs phases 1-4 on those kernels' cases alone, in turns with ``--parent``'s
where it is given (a trial: no kernel line, no final line; the report in
``chiprun_out/chip_smoke_only.json``); ``--only
pairwise_pass1,pairwise_pass2`` builds those two alone and runs their
phase 4 and the plan's sizes, in turns with ``--parent``'s where given.

The second-to-last line of standard output is a JSON object with one entry
per kernel; the last line is ``{"ok": true, "device": {...}}``. A full
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
STATE = os.path.join(ROOT, "docs", "results", "drift100k_r5ship",
                     "state.psph")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
STEPS = 64
SLICE_GROUPS = 256        # plain versions run in slices of this many groups
KERNEL_REPS = 21          # CUDA-event timings per kernel (median)
PLAIN_REPS = 5            # timings of the sliced plain version (median)
DEVICE_REPS = 10          # profiled calls per kernel (device time, mean)
HOST_REPS = 200           # host timings of a wrapper call (median)
SIDE_SLEEP_CYCLES = 20_000_000   # the side stream's sleep: some 10 ms
CHAIN_TURNS = 11          # chains of probe_launch and torch.mul, in turns
SMALL_N = 2048            # particles of the card-against-CPU agreement run
SMALL_STEPS = 8           # its steps: two chunks, RESPA, one sort reuse

DENSE_RUNS = ((3000, 200), (32768, 20))   # (n, steps) of the dense main path
DENSE_SMALL_N = 512       # particles of the dense card-against-CPU run

# the general grid + tree step: what each leg changes in jupiter_100k
SYM_KW = dict(grad_p_mode="symmetric", h_mode="relax", fuse_p2p_sph=False,
              fuse_p2p_residual=False, p2p_window=256, m2p_window=256)
SYM_STEPS = 64            # two K=32 RESPA chunks
SYM_TIER_STEPS = 8        # one K=8 chunk with respa_every=1
SETTLE_KW = dict(vel_damping=0.1, av_alpha=0.5, av_beta=1.0,
                 rebuild_every=8, respa_every=1, nbr_window=480,
                 p2p_window=224, m2p_window=256, h_max=5.0)
SETTLE_STEPS = 16         # two K=8 chunks
SETTLE_BALSARA_STEPS = 8
PARITY_STEPS = 100
# the energy equation: the settled state under the adiabatic EOS
ADIA_KW = dict(eos_mode="adiabatic", av_alpha=1.0, av_beta=2.0)
ADIA_STEPS = 64           # two K=32 chunks of the production step
ADIA_NOAV_STEPS = 8       # one K=8 chunk, RESPA period 8, no viscosity
# the Tillotson impact: basalt into ice at 3 km/s, centres 200 km apart
IMPACT_KW = dict(separation=2e7, approach_speed=3e5,
                 materials=("basalt", "ice"))
BASALT_STEPS = 100
BASALT_N = 100_000
# the same impact on grid neighbours with tree gravity at n = 100,000:
# symmetric grad P, viscosity, unfused, monopoles (the quadrupole term
# d.Q.d overflows f32 at cgs scale, in the reference too), a structure per
# step. particle_radius keeps the preset's neighbour count at this n; the
# windows hold the occupancies this leg prints.
BASALT100K_KW = dict(
    n=BASALT_N, neighbor_mode="grid", gravity_solver="tree",
    multipole_order=1, particle_radius=5.0e6 * (100.0 / BASALT_N) ** (1 / 3),
    nbr_sub=32, nbr_window=448, p2p_window=640, m2p_window=512)
BASALT100K_STEPS = 16
# the supergroup far tier on sym100k
SG_KW = dict(sg_blocks=4, blk_window=768)
# group sizes past the windowed kernels' old limits of 256 targets (and
# 512 boxed targets and one block's shared memory for filter_sph) and an
# odd one for p2p: (b, nbr_sub,
# the leg's settings, the windows' first growth, (kernel, case) checked)
GROUP_SIZE_LEGS = (
    (512, 32, {}, 2, (("filter_sph", "filter"), ("pass1_gradh", "grad_h"),
                      ("pass2", "grad_h+merged"),
                      ("gravity_fused", "far_only"))),
    (512, 32, SYM_KW, 2, (("pass1_sym", "symmetric"),
                          ("pass2", "symmetric"), ("p2p", "min_h"),
                          ("gravity_fused", "near+min_h"))),
    (1024, 32, {}, 3, (("filter_sph", "filter"),)),
    (33, 11, SYM_KW, 1, (("p2p", "min_h"),)),
    # past one block's shared memory (groups2.FILTER_MAX_GROUP = 9,820):
    # the tiled path (groups2.filter_tiles: 14 tiles of 704 and 32 of 512
    # on 132 multiprocessors; 9,821 = 7 * 23 * 61)
    (9821, 61, {}, 3, (("filter_sph", "filter"),)),
    (16384, 32, {}, 4, (("filter_sph", "filter"),)),
)
GROW_WINDOWS = ("nbr_window", "sph_refined_window", "p2p_window",
                "m2p_window")
# the cases group_size_cases yields, as check_modes names them
GROUP_SIZE_CASES = {
    (name, f"{case}@b{b}" + ("@sym100k" if kw else ""))
    for b, _, kw, _, kernels in GROUP_SIZE_LEGS for name, case in kernels}
# particle-exact SPH lists on the settled state: tools/ksweep2.py's r4x896
# with the fusion's companion flag off and sym100k's unfused windows
EXACT_KW = dict(sph_exact_window=896, fuse_p2p_sph=False,
                fuse_p2p_residual=False, p2p_window=256, m2p_window=256)
EXACT_STEPS = 64          # two K=32 RESPA chunks
UNSORTED_STEPS = STEPS    # the production step with sorted_chunks=False
DENSE_K4 = (3000, 200, 4)  # (n, steps, rebuild_every) of the cached dense leg
# the tools' probes at the reference tools' shapes
FMA_SHAPE, FMA_REPS = (256, 512), 512
LAUNCH_SHAPE, LAUNCH_CHAIN = (8, 128), 256
GATHER_NB, GATHER_W, GATHER_C = 2067, 96, 7
TILE_SUPERS = (1, 4, 8)
# the tile widths whose phase-4 case plants non-finite and far-out values
TILE_NAN_SUPERS = (1, 8)
TOOL_K = 8                # data-dependent calls of each microbench variant
VPU_K, HBM_K, HBM_MB = 16, 32, 512
# probe_fma: the kernel rounds once per FMA, the plain acc * v + v twice;
# acc grows to about 4 reps, the differences add up along the chain
FMA_RTOL = 1e-4
# probe_pass1_tile: the random-normal terms cancel, so the difference of
# two summation orders is held against the sum of |m W| of each target
TILE_TOL = 1e-5
# elements of one [groups, B, S] intermediate of a sliced plain version
SLICE_ELEMS = SLICE_GROUPS * 64 * 2560
# and of the filter's models (bound, shares): the production filter's
# 256 groups of 64 targets by 7,680 slots
FILTER_MODEL_ELEMS = SLICE_GROUPS * 64 * 7680

# published peaks of one H100 SXM (dense, no sparsity): f32 outside the
# tensor cores and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# f32 operations the function needs, by the branch this run's data takes,
# counted from the kernels' source: each add, multiply, compare, min/max,
# sqrt and rsqrt is one, and an operation whose result the branch does not
# use is not counted. Every window slot below nv costs its m > 0 test once
# per group; only live slots (m > 0) are evaluated for each of the B
# targets (every target column, replica padding included, is an output).
OPS_SLOT_TEST = 1
OPS_P1 = dict(inner=28,   # dx(3) r2(5) sqrt q; q<2 q<1 count; q2 q3
              #             inner(4) dW(5) two sums(4)
              outer=24,   # dx(3) r2(5) sqrt q; q<2 q<1 count; t t^2 W(2)
              #             dW(3) two sums(4)
              none=11)    # dx(3) r2(5) sqrt q; q<2
OPS_GEOM = 11             # dx(3) r2(5) fmax rsqrt r
OPS_COUNT = 1             # n_direct add
OPS_DYER_IP = dict(near=30,  # fmin x x<1; x2 x3 a^-3(2) mag(6) phi(10)
                   #           sums(7)
                   far=14)   # fmin x x<1; m/r mag(2) -phi sums(7)
OPS_GW = dict(inner=6,    # q<1 (-3+2.25q)(2) /h prefactor(2)
              outer=8,    # q<1 q<2 t t^2(2) /r prefactor(2)
              none=2)     # q<1 q<2
OPS_GW_PAIR = 2           # q_i, q_j
OPS_GW_JH4 = 2            # h_j^-4, where gw_j is not 0
OPS_GP_SUM = 10           # coef(4) three sums(6), where gw_i or gw_j != 0
OPS_MONO = 23             # dx(3) r2(5) fmax rsqrt mag(3) phi(2) g(3)
#                           sums(4) count
OPS_QUAD = 41             # Q.d(15) d.Q.d(5) r^-2 r^-5(2) r^-7 term(3)
# the bf16 instances (grav_pair_dtype="bfloat16"): of each live Dyer-Ip
# pair's operations above these run in bf16 instead (near: x2 x3 a^-3(2)
# mag(6) phi(10); far: m/r mag(2) -phi), and the casts to bf16 are added
# (dx(3) x m 1/a 1/r); of each moment entry's, the monopole's mag(3), with
# its casts (dx(3) m 1/r). The geometry, the x < 1 test, the exact last
# products, the sums and the quadrupole stay f32.
OPS_DYER_IP_IN_BF16 = dict(near=20, far=4)
OPS_CAST_PAIR = 7
OPS_MONO_IN_BF16 = 3
OPS_CAST_MONO = 5
# non-tensor bf16 of one H100 SXM5: packed bf16x2 operations at twice the
# f32 rate (NVIDIA H100 Tensor Core GPU Architecture whitepaper: 133.8
# TFLOP/s against 66.9 in f32)
PEAK_BF16 = 133.8e12
#                           phi(3) g(12)
OPS_FILTER = 13           # dx(3) r2(5) fmax cut(2) cut^2 compare
# pass1_sym, per live pair inside either support: the geometry and the
# count, then each side's spline by the branch of its q; per live pair
# outside both supports only the geometry and the skip test
OPS_P1S_GEOM = 16         # dx(3) r2(5) sqrt q_i q_j h_j^-3(2); q_i<2 m>0
#                           count
OPS_P1S_SKIP = 12         # dx(3) r2(5) min(ih_i, ih_j) (r2 ihm) ihm; >
OPS_P1S_W = dict(inner=7,  # q<1; q2 (1.5 q2) (0.75 q2) *q - +
                 outer=6,  # q<1 q<2; t t^2 t^3 *0.25
                 none=2)   # q<1 q<2
OPS_P1S_SUM_I = 2         # m W_i, +=
OPS_P1S_SUM_J = 3         # m W_j h_j^-3, +=
# pass 2's other forms, on pairs inside either support
OPS_GP_MODE = dict(grad_h=0,                # in OPS_GP_SUM
                   reference_asymmetric=0,  # gsym(2) m cc g (2)
                   symmetric=1)             # gsym(2) tc+cc m g (3)
OPS_AV_VDOTR = 9          # dv(3) v.d(5) v.d<0
OPS_AV_GSYM = 2           # (gw_i + gw_j)/2: approaching pairs, or all with
#                           the Balsara sums
OPS_AV_PI = 17            # hbar(2) mu(5) cbar(2) rhobar(2) Pi(6)
OPS_AV_SUM = 8            # m Pi g (2), three sums (6)
OPS_AV_BAL = 3            # (f_i + f_j)/2 * Pi
OPS_AV_DC = 18            # m g (1); div (2); curl 3 x (2 mul, sub, mul, add)
# the energy column, on pairs where its term is not 0
OPS_EN_VDOTR = 8          # dv(3) v.d(5), unless the viscosity has them
OPS_EN = dict(grad_h=4,   # m gw_i, tc *, * v.d, +=  (where gw_i != 0)
              symmetric=3)  # coef / 2, * v.d, +=  (inside either support)
OPS_EN_AV = 3             # cav / 2, * v.d, +  (approaching pairs)

# The all-pairs kernels, per pair j != i of the n particles: every pair
# its q^2 test, a pair the test keeps (r2 ihm^2 <= PSPH_Q2_SKIP) the rest
# of its geometry, and a pair inside either support its spline or
# gradient terms. Under a plan only the pairs of near (warp, sub-tile)
# pairs take the test; the far ones OPS_PW_FAR (pass 1 with gravity) or
# nothing. Per-source and per-target factors (1/h^3, P/rho^2, the
# sound speed) and the self test of the diagonal tiles are O(n) and not
# counted.
OPS_PW_SKIP = 12          # dx(3) r2(5) min(ih_i, ih_j) (r2 ihm) ihm; >
OPS_PW_NEAR = 5           # sqrt q_i q_j; q_i<2 q_j<2
OPS_PW_W = dict(inner=8,  # q<1; q2 q3 poly(4) *c
                outer=7,  # q<1 q<2; t t^2 t^3 *0.25 *c
                none=2)   # q<1 q<2
OPS_PW_RHO = 9            # c_j(3); m/2 W_i+W_j * +=; q_i<2 count
OPS_PW_GRAV_FAR = 11      # a pair the test skips: the outer Dyer-Ip branch,
#                           rsqrt m/r mag(2) sums(7)
OPS_PW_FAR = 19           # a pair of a far (warp, sub-tile) pair under a
#                           plan, with gravity: dx(3) r2(5) rsqrt m/r mag(2)
#                           sums(7); without gravity it is not swept
OPS_PW_GRAV = 2           # a pair the test keeps: fmax rsqrt (then
#                           OPS_DYER_IP, less its fmin under receiver
#                           softening)
OPS_PW_GW = dict(inner=5,  # q<1; lin+2.25q(2) *c *ih
                 outer=7,  # q<1 q<2; t t^2 *-0.75 *c /r
                 none=2)   # q<1 q<2
OPS_PW_GW_CJ = 4          # the source's h^-4/pi, where its gw is not 0
OPS_PW_GW_SYM = 2         # (gw_i + gw_j) / 2
OPS_PW_COEF = dict(asymmetric=2,  # m * (P_j/rho_j) * g
                   symmetric=4)   # (P_i/rho_i^2 + P_j/rho_j^2) m rho_i g
OPS_PW_GP_SUM = 6         # three multiply-adds
OPS_PW_VDOTR = 9          # dv(3) v.x(5) v.x<0
OPS_PW_PI = 21            # hbar(2) mu(5) cbar(2) rhobar(2) Pi(6)
#                           coef += m Pi g rho_i (4), on approaching pairs
OPS_PW_PI_BAL = 3         # (f_i + f_j)/2 * Pi
OPS_PW_DC = 18            # m g (1); div (2); curl 3 x (2 mul, sub, mul, add)

# The probes. probe_fma: two operations per FMA, four FMAs per rep, per
# element; probe_launch: one multiply per element; probe_gather: none.
# probe_pass1_tile, per live (target, slot) pair: the geometry, the branch
# of the signed q, and the sum; per slot below the extent its live test
# (once per instance); per target the prefactor ih^3/pi.
OPS_FMA_REP = 8
OPS_TILE_GEOM = 10        # dx(3) r2(5) sqrt q
OPS_TILE_W = dict(inner=7,  # q<1; q2 1.5q2 1-. 0.75q2 *q +
                  outer=6,  # q<1 q<2; t 0.25t *t *t
                  none=2)   # q<1 q<2
OPS_TILE_SUM = 3          # w c, m (w c), +=
OPS_TILE_SLOT = 1         # live > 0.5
OPS_TILE_TARGET = 3       # (1/pi ih) ih ih

KERNELS = {
    "filter_sph": ("planetmodel_sph_tpu_torch/csrc/filter_sph.cu",
                   "planetmodel_sph_tpu/ops/pallas/groups2.py:382"),
    "pass1_gradh": ("planetmodel_sph_tpu_torch/csrc/pass1_gradh.cu",
                    "planetmodel_sph_tpu/ops/pallas/groups2.py:250"),
    "pass1_sym": ("planetmodel_sph_tpu_torch/csrc/pass1_sym.cu",
                  "planetmodel_sph_tpu/ops/pallas/groups2.py:324"),
    "p2p": ("planetmodel_sph_tpu_torch/csrc/p2p.cu",
            "planetmodel_sph_tpu/ops/pallas/groups2.py:797"),
    "pass2": ("planetmodel_sph_tpu_torch/csrc/pass2.cu",
              "planetmodel_sph_tpu/ops/pallas/groups2.py:649"),
    "gravity_fused": ("planetmodel_sph_tpu_torch/csrc/gravity_fused.cu",
                      "planetmodel_sph_tpu/ops/pallas/groups2.py:969"),
    "pairwise_pass1": ("planetmodel_sph_tpu_torch/csrc/pairwise_pass1.cu",
                       "planetmodel_sph_tpu/ops/pallas/pairwise.py:255"),
    "pairwise_pass2": ("planetmodel_sph_tpu_torch/csrc/pairwise_pass2.cu",
                       "planetmodel_sph_tpu/ops/pallas/pairwise.py:284"),
    "probe_fma": ("planetmodel_sph_tpu_torch/csrc/probe_fma.cu",
                  "tools/roofline.py:97"),
    "probe_launch": ("planetmodel_sph_tpu_torch/csrc/probe_launch.cu",
                     "tools/roofline.py:118"),
    "probe_gather": ("planetmodel_sph_tpu_torch/csrc/probe_gather.cu",
                     "tools/microbench.py:113"),
    "probe_pass1_tile": ("planetmodel_sph_tpu_torch/csrc/"
                         "probe_pass1_tile.cu", "tools/microbench.py:206"),
}
PROBES = ("probe_fma", "probe_launch", "probe_gather", "probe_pass1_tile")
# the sweeps that visit only the live slots of their windows: phase 4
# prints the share of slots they visit and of pairs inside the support,
# and holds two launches on the same inputs to the same bits
COMPACTED = ("pass1_gradh", "pass1_sym", "pass2")
# the kernels redesigned for this card: phase 4 prints what each case
# visits, each instance's registers and spills and holds two launches to
# the same bits; with --parent it times the other checkout's in turns
REDESIGNED = COMPACTED + ("gravity_fused", "filter_sph", "p2p")
# the all-pairs kernels, whose non-finite inputs reach the outputs as in
# their plain versions: with --parent phase 4 times the other checkout's
# in turns too
ALL_PAIRS = ("pairwise_pass1", "pairwise_pass2")

# Tolerances, kernel against plain version, both f32 on the card. The two
# sum the same terms in different orders (the kernel sequentially per
# target, PyTorch's reduction as a tree), so sums differ by rounding:
# - counts (nn, n_direct, n_approx) and the filter mask: exact. The filter
#   and pass 1 decide on r2 and are built with -fmad=false, so r2 and
#   cut*cut round as PyTorch's separate ops do; pass 2 and gravity_fused
#   count only m > 0 and accept, which no rounding moves;
# - rho and phi: sums of same-sign terms, rtol 1e-4;
# - xi, grad P, grad phi: sums whose terms cancel (the settled state is
#   near hydrostatic balance), so the error scales with the sum of |terms|,
#   not with the result: rtol 1e-4 plus an atol of 1e-4 of the field's
#   largest magnitude. The all-pairs kernels follow the same rule: counts
#   exact (pairwise_pass1 forms its count's r2 and q with __fmul_rn and
#   __fadd_rn), rho and phi rtol 1e-4, grad phi, grad P and the div/curl
#   sums rtol 1e-4 plus the atol.
_GRAV_TOL = [(1e-4, 0.0)] + [(1e-4, 1e-4)] * 3 + [None]
TOL = {
    "filter_sph": [None],
    "pass1_gradh": [(1e-4, 0.0), None, (1e-4, 1e-4)],
    "pass1_sym": [(1e-4, 0.0), None],
    "p2p": _GRAV_TOL,
    # pass 2: see pass2_tol, its outputs follow its flags
    "gravity_fused": _GRAV_TOL + [None],
    # rho, n_neighbors, phi, grad_phi, n_direct
    "pairwise_pass1": [(1e-4, 0.0), None, (1e-4, 0.0), (1e-4, 1e-4), None],
    # grad_p[, dc]
    "pairwise_pass2": [(1e-4, 1e-4), (1e-4, 1e-4)],
}


def pass2_tol(kw):
    """Pass 2's tolerances under its flags: grad P, the viscosity term, the
    div/curl sums and the energy rate cancel (rtol + atol); phi does not;
    n_direct exact."""
    n = 3 + (3 if kw.get("av") else 0) + (4 if kw.get("balsara") else 0) \
        + (1 if kw.get("energy") else 0)
    return [(1e-4, 1e-4)] * n + (_GRAV_TOL if kw.get("grav") else [])


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


# ---------------------------------------------------------------------------
# kernel inputs, slicing, comparison and timing
# ---------------------------------------------------------------------------

class Spy:
    """Records the last call of each windowed kernel wrapper while active."""

    def __enter__(self):
        from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
        self.gk2, self.seen = gk2, {}
        self.orig = {k: getattr(gk2, k) for k in gk2.KERNELS}

        def spy(name):
            def call(*a, **kw):
                self.seen[name] = (a, kw)
                return self.orig[name](*a, **kw)
            return call

        for k in self.orig:
            setattr(gk2, k, spy(k))
        return self.seen

    def __exit__(self, *exc):
        for k, f in self.orig.items():
            setattr(self.gk2, k, f)


def _eval(run_state, cfg, st, tiers):
    from planetmodel_sph_tpu_torch.models import planet
    kw = planet._forces_kw(cfg, run_state.u, run_state.matid,
                           run_state.balsara)
    kw.setdefault("fbal", run_state.balsara)
    planet._forces_block(run_state.pos, run_state.h, run_state.mass, cfg, st,
                         vel=run_state.vel, solve_h=False, sorted_io=True,
                         grav_tiers=tiers, **kw)


def capture_inputs(state, cfg):
    """Record the last call of each kernel wrapper over one chunk set-up
    (Newton h-solve + build), one RESPA inner force evaluation and one far
    evaluation: the shapes every step of the main path gives the kernels."""
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure
    with Spy() as seen:
        run_state, st = planet.chunk_setup(state, cfg)
        _eval(run_state, cfg, st, "near")
        structure.gravity_far(run_state.pos, run_state.h, run_state.mass,
                              cfg, st, sorted_io=True)
    return seen


def parity_start():
    """`parity3k`'s configuration and primed start state."""
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    pcfg = config_mod.parity()
    return pcfg, planet.prime(ics.jupiter(pcfg), pcfg)


def mode_cases(state, cfg, sym_state, settle_state, settle_cfg):
    """The inputs of every case the production path does not give, one
    (kernel, case, legs, args, kw) at a time. `legs` names the main-path
    legs that launch this kernel in this mode at these shapes: their
    inputs are recorded on the leg's own first evaluation (its chunk
    set-up from the state the leg starts from, then one force evaluation
    as its steps make it; for `parity3k` the uncached evaluation of the
    primed state under ``config.parity()``). A case with no leg is an
    extra only this phase drives: a variant of `sym100k`'s configuration
    that differs in pass 2's form or the softening."""
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure

    # sym100k: 64 RESPA steps (near tier per step, far tiers per period),
    # then its every-tier leg (one gravity launch per step)
    both = ("sym100k", "sym100k_every_tier")
    # the supergroup tier changes the gravity partition only: `sg100k`'s
    # SPH sweeps get these same inputs
    sph = both + ("sg100k", "sg100k_every_tier")
    sym = cfg.replace(**SYM_KW)
    with Spy() as seen:
        run_state, st = planet.chunk_setup(sym_state, sym)
        _eval(run_state, sym, st, "near")
        structure.gravity_far(run_state.pos, run_state.h, run_state.mass,
                              sym, st, sorted_io=True)
    occupancy("sym100k", st)
    yield "filter_sph", "sym100k", sph, *seen["filter_sph"]
    yield "pass1_sym", "symmetric", sph, *seen["pass1_sym"]
    yield "pass2", "symmetric", sph, *seen["pass2"]
    yield "p2p", "min_h", ("sym100k",), *seen["p2p"]
    yield "gravity_fused", "far_only@sym100k", ("sym100k",), \
        *seen["gravity_fused"]
    with Spy() as seen:
        _eval(run_state, sym, st, "all")
    yield "gravity_fused", "near+min_h", ("sym100k_every_tier",), \
        *seen["gravity_fused"]
    recv = sym.replace(softening_mode="receiver_h")
    with Spy() as seen:
        _eval(run_state, recv, st, "near")
    yield "p2p", "receiver_h", (), *seen["p2p"]
    with Spy() as seen:
        _eval(run_state, recv, st, "all")
    yield "gravity_fused", "near+receiver_h", (), *seen["gravity_fused"]
    asym = sym.replace(grad_p_mode="reference_asymmetric",
                       kernel_deriv_sign_bug=True)
    with Spy() as seen:
        _eval(run_state, asym, st, "near")
    yield "pass2", "asymmetric+sign_bug", (), *seen["pass2"]
    del st, seen
    fused = recv.replace(fuse_p2p_sph=True)
    run_state, st = planet.chunk_setup(state, fused)
    with Spy() as seen:
        _eval(run_state, fused, st, "near")
    yield "pass2", "symmetric+fused+receiver_h", (), *seen["pass2"]
    del st, seen, run_state

    # settle100k: every tier every step, viscosity; then its Balsara leg
    # (the structure does not depend on the limiter: same build)
    both = ("settle100k", "settle100k_balsara")
    with Spy() as seen:
        run_state, st = planet.chunk_setup(settle_state, settle_cfg)
        _eval(run_state, settle_cfg, st, "all")
    occupancy("settle100k", st)
    yield "filter_sph", "settle100k", both, *seen["filter_sph"]
    yield "pass1_gradh", "settle100k", both, *seen["pass1_gradh"]
    yield "pass2", "grad_h+av+merged", ("settle100k",), *seen["pass2"]
    yield "gravity_fused", "far_only@settle100k", both, \
        *seen["gravity_fused"]
    bal = settle_cfg.replace(av_balsara=True)
    with Spy() as seen:
        _eval(run_state, bal, st, "all")
    yield "pass2", "grad_h+av+balsara+merged", ("settle100k_balsara",), \
        *seen["pass2"]
    # an extra: the same inputs with the energy column, one of the forms
    # whose build spills a few bytes (the viscosity's columns carry the
    # velocities the energy equation reads)
    a, kw = seen["pass2"]
    yield "pass2", "grad_h+av+balsara+energy+merged", (), a, \
        dict(kw, energy=True)
    del st, seen, run_state

    # parity3k: a fresh structure and every gravity tier in one launch
    # (monopoles, receiver softening) each step
    pcfg, pst = parity_start()
    with Spy() as seen:
        planet.compute_forces(pst.pos, pst.h, pst.mass, pcfg, vel=pst.vel)
    yield "gravity_fused", "near+receiver_h@parity3k", ("parity3k",), \
        *seen["gravity_fused"]


def occupancy(label, st, sph_unit="sub-blocks"):
    """Print a structure's largest window occupancies (and the blk tier's
    when it is on); `sph_unit` names what the SPH window holds."""
    blk = ""
    if st.blk_idx.shape[1] > 1:
        blk = (f", max n_blk {int(st.n_blk.max())} of "
               f"{st.blk_idx.shape[1]} blocks")
    print(f"{label} first rebuild: max n_sph {int(st.n_sph.max())} of "
          f"{st.sph_idx.shape[1]} {sph_unit}, max n_p2p "
          f"{int(st.n_p2p.max())} of {st.p2p_idx.shape[1]}, max n_m2p "
          f"{int(st.n_m2p.max())} of {st.m2p_idx.shape[1]} sub-blocks{blk}",
          flush=True)


def basalt_start(grid=False):
    """The Tillotson impact's configuration and primed start state: the
    ``basalt_impact`` preset at its own n, or (`grid`) `basalt100k`'s
    grid + tree variant."""
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    bcfg = config_mod.basalt_impact(**(BASALT100K_KW if grid else {}))
    return bcfg, planet.prime(ics.two_planet_collision(bcfg, **IMPACT_KW),
                              bcfg)


def energy_cases(cfg, adia_state, sg_state, basalt_cfg, basalt_state):
    """The inputs of the cases the energy equation and the supergroup far
    tier add, as :func:`mode_cases` yields them, each recorded on its own
    leg's first evaluation."""
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure

    # adia100k: the production chunk with the evolved internal energy
    adia = cfg.replace(**ADIA_KW)
    with Spy() as seen:
        run_state, st = planet.chunk_setup(adia_state, adia)
        _eval(run_state, adia, st, "near")
        structure.gravity_far(run_state.pos, run_state.h, run_state.mass,
                              adia, st, sorted_io=True)
    occupancy("adia100k", st)
    both = ("adia100k", "adia100k_no_av")
    yield "filter_sph", "adia100k", both, *seen["filter_sph"]
    yield "pass1_gradh", "adia100k", both, *seen["pass1_gradh"]
    yield "pass2", "grad_h+av+energy+merged", ("adia100k",), *seen["pass2"]
    yield "gravity_fused", "far_only@adia100k", both, *seen["gravity_fused"]
    noav = adia.replace(av_alpha=0.0, av_beta=0.0)
    with Spy() as seen:
        _eval(run_state, noav, st, "near")
    yield "pass2", "grad_h+energy+merged", ("adia100k_no_av",), \
        *seen["pass2"]
    del st, seen, run_state

    # sg100k: the supergroup far tier, far-only under RESPA and with the
    # near tier in the every-tier steps
    sg = cfg.replace(**SYM_KW, **SG_KW)
    with Spy() as seen:
        run_state, st = planet.chunk_setup(sg_state, sg)
        _eval(run_state, sg, st, "near")
        structure.gravity_far(run_state.pos, run_state.h, run_state.mass,
                              sg, st, sorted_io=True)
    occupancy("sg100k", st)
    yield "p2p", "min_h@sg100k", ("sg100k",), *seen["p2p"]
    yield "gravity_fused", "far_only+blk", ("sg100k",), \
        *seen["gravity_fused"]
    with Spy() as seen:
        _eval(run_state, sg, st, "all")
    yield "gravity_fused", "near+min_h+blk", ("sg100k_every_tier",), \
        *seen["gravity_fused"]
    del st, seen, run_state

    # basalt100k: cgs magnitudes; a fresh structure and every gravity tier
    # in one launch each step
    bst = basalt_state
    occupancy("basalt100k", structure.build(bst.pos, bst.h, bst.mass,
                                            basalt_cfg))
    with Spy() as seen:
        planet.compute_forces(bst.pos, bst.h, bst.mass, basalt_cfg,
                              vel=bst.vel, u=bst.u, matid=bst.matid)
    leg = ("basalt100k",)
    yield "pass1_sym", "symmetric@basalt100k", leg, *seen["pass1_sym"]
    yield "pass2", "symmetric+av+energy@basalt100k", leg, *seen["pass2"]
    yield "gravity_fused", "near+min_h+monopole@basalt100k", leg, \
        *seen["gravity_fused"]


def exact_cases(cfg, exact_state):
    """The inputs of the cases the particle-exact SPH lists add, as
    :func:`mode_cases` yields them, recorded on `exact100k`'s own first
    chunk set-up: the h-solve's own exact lists (its filter at the widened
    windows, its density sweep at the scaled exact window), then the
    chunk's build and one force evaluation at the exact window's S."""
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure
    ecfg = cfg.replace(**EXACT_KW)
    leg = ("exact100k",)
    st0 = exact_state
    with Spy() as seen:
        structure.solve_h_newton(st0.pos, st0.h, st0.mass, ecfg,
                                 planet.h_eta(ecfg), rho0=st0.rho)
    yield "filter_sph", "exact_h_solve", leg, *seen["filter_sph"]
    yield "pass1_gradh", "exact_h_solve", leg, *seen["pass1_gradh"]
    with Spy() as seen:
        run_state, st = planet.chunk_setup(exact_state, ecfg)
        _eval(run_state, ecfg, st, "near")
    occupancy("exact100k", st, "particles")
    yield "filter_sph", "exact100k", leg, *seen["filter_sph"]
    yield "pass1_gradh", "exact100k", leg, *seen["pass1_gradh"]
    yield "pass2", "grad_h@exact100k", leg, *seen["pass2"]


def overflowing(st):
    """The window fields of the config to grow for a structure that drops
    entries: the SPH window with its refined one, the P2P window, the M2P
    window."""
    return [k for over, keys in (
        (st.sph_overflow, ("nbr_window", "sph_refined_window")),
        (st.p2p_overflow, ("p2p_window",)),
        (st.m2p_overflow, ("m2p_window",))) if int(over) for k in keys]


def group_size_cases(cfg, state):
    """The inputs of the group sizes past the windowed kernels' old limits,
    as :func:`mode_cases` yields them, each recorded on the settled
    state's first chunk set-up under that size (windows widened until
    overflow is 0): b = 512 in the production form (``filter_sph``,
    ``pass1_gradh``, the merged grad-h ``pass2``, the far-only
    ``gravity_fused``: two blocks a group) and under `sym100k`'s unfused
    symmetric step (``pass1_sym``, ``pass2``, ``p2p``, and
    ``gravity_fused`` with its near tier), b = 1024 for ``filter_sph``'s
    second word of boxes, b = 33 (sub-blocks of 11) under `sym100k` for
    ``p2p``'s odd tail, and b = 9,821 (sub-blocks of 61) and 16,384 for
    ``filter_sph``'s tiled path. No leg launches them."""
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure
    for b, sub, kw, grow, kernels in GROUP_SIZE_LEGS:
        base = cfg.replace(nbr_group_size=b, nbr_sub=sub, **kw)
        gcfg = base.replace(**{k: getattr(base, k) * grow
                               for k in GROW_WINDOWS})
        label = f"b{b}" + ("@sym100k" if kw else "")
        names = [name for name, _ in kernels]
        with Spy() as seen:
            # the chunk's set-up (h-solve and build), its windows grown by
            # half where they drop entries, until none does
            for _ in range(8):
                run_state, st = planet.chunk_setup(state, gcfg)
                wider = overflowing(st)
                if not wider:
                    break
                gcfg = gcfg.replace(**{k: getattr(gcfg, k) * 3 // 2
                                       for k in wider})
            _eval(run_state, gcfg, st, "near")
            if "gravity_fused" in names:
                if kw:
                    _eval(run_state, gcfg, st, "all")
                else:
                    structure.gravity_far(run_state.pos, run_state.h,
                                          run_state.mass, gcfg, st,
                                          sorted_io=True)
        occupancy(label, st)
        over = {k: int(v) for k, v in structure.overflow_info(st).items()}
        if any(over.values()):
            raise RuntimeError(f"{label}: overflow {over}")
        for name, case in kernels:
            a, kwn = seen[name]
            if kwn["b"] != b:
                raise RuntimeError(f"{name} at {label}: b = {kwn['b']}")
            yield name, f"{case}@{label}", (), a, kwn
        del st, seen, run_state


def n_groups(a):
    """Target groups of a kernel call: the length of its nv argument."""
    return a[0].shape[0]


def slice_args(a, kw, g0, g1):
    """The arguments of one kernel call restricted to groups [g0, g1):
    tensors with one row per group ([G, S] rows, nv, accept) and target
    columns ([G*B, 1]) are cut, the shared far rows ([1, NBpad]), numbers
    and flags pass as they are. `b` goes: the plain versions infer it."""
    import torch
    g, b = n_groups(a), kw["b"]

    def cut(v):
        if isinstance(v, (list, tuple)):
            return [cut(x) for x in v]
        if not isinstance(v, torch.Tensor):
            return v
        if v.shape[0] == g * b and v.ndim == 2 and v.shape[1] == 1:
            return v[g0 * b:g1 * b].contiguous()
        if v.shape[0] == g:
            return v[g0:g1].contiguous()
        return v

    return (tuple(cut(v) for v in a),
            {k: cut(v) for k, v in kw.items() if k != "b"})


def slice_groups(a, kw):
    """Groups per slice of the plain version: its [groups, B, S]
    intermediates stay at SLICE_ELEMS elements whatever the window."""
    import torch
    widest = max(t.shape[1] for v in [*a, *kw.values()]
                 if isinstance(v, (list, tuple))
                 for t in v if isinstance(t, torch.Tensor) and t.ndim == 2)
    return max(1, min(SLICE_GROUPS, SLICE_ELEMS // (kw["b"] * widest)))


def _slot_slices(groups, b, s, elems):
    """[s0, s1) slices of a window's S slots such that [groups, b, slots]
    stays at `elems` elements (one slice when it does whole)."""
    step = max(1, elems // (groups * b))
    return [(s0, min(s, s0 + step)) for s0 in range(0, s, step)]


def _slot_cut(nv, rows, s0, s1):
    """nv and window rows restricted to the slots [s0, s1)."""
    import torch
    return (torch.clamp(nv - s0, 0, s1 - s0).to(nv.dtype),
            type(rows)(r[:, s0:s1].contiguous() for r in rows))


def filter_plain(nv, tgt, src):
    """``filter_sph_plain``, a slice of slots at a time where a group's
    [B, S] intermediates would not fit (b = 16,384 takes some 150,000
    candidate slots: 10 GB an intermediate whole); the mask of a slot
    depends on its own column alone."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    g, s = src[0].shape
    parts = []
    for s0, s1 in _slot_slices(g, tgt[0].shape[0] // g, s, SLICE_ELEMS):
        nv_c, rows = _slot_cut(nv, src, s0, s1)
        parts.append(gk2.filter_sph_plain(nv_c, tgt, rows))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def plain_fn(name):
    """A windowed kernel's plain version (the filter's slot-sliced)."""
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    return filter_plain if name == "filter_sph" else getattr(
        gk2, name + "_plain")


def plain_sliced(name, a, kw):
    """The plain version over every group, a slice of groups at a time
    (its [G, B, S] intermediates would not fit whole)."""
    import torch
    fn = plain_fn(name)
    g = n_groups(a)
    step = slice_groups(a, kw)
    parts = []
    for g0 in range(0, g, step):
        sa, skw = slice_args(a, kw, g0, min(g, g0 + step))
        out = fn(*sa, **skw)
        parts.append(out if isinstance(out, tuple) else (out,))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


def compare(name, out, ref, kw=None):
    """Hold kernel outputs against the plain version's. Returns
    (ok, max_abs_err, messages)."""
    out = out if isinstance(out, tuple) else (out,)
    tols = pass2_tol(kw) if name == "pass2" else TOL[name]
    if not len(out) == len(ref) <= len(tols):
        return False, math.inf, [f"{len(out)} outputs against {len(ref)} "
                                 f"and {len(tols)} tolerances"]
    worst, msgs, ok = 0.0, [], True
    for k, (o, r, tol) in enumerate(zip(out, ref, tols)):
        if o.shape != r.shape or o.dtype != r.dtype:
            return False, math.inf, [f"output {k}: {o.shape}/{o.dtype} "
                                     f"against {r.shape}/{r.dtype}"]
        err = (o.double() - r.double()).abs()
        if not bool(torch_isfinite(o).all()):
            ok = False
            msgs.append(f"output {k}: not finite")
        worst = max(worst, float(err.max()))
        if tol is None:
            bad = int((err > 0).sum())
            if bad:
                ok = False
                msgs.append(f"output {k}: {bad} entries differ (exact)")
            continue
        rtol, atol_rel = tol
        lim = rtol * r.double().abs() + atol_rel * float(r.abs().max())
        bad = int((err > lim).sum())
        if bad:
            ok = False
            msgs.append(f"output {k}: {bad} entries outside rtol={rtol} "
                        f"atol={atol_rel}*max|ref|, max err {float(err.max())}")
    return ok, worst, msgs


def torch_isfinite(t):
    import torch
    return torch.isfinite(t) if t.is_floating_point() else \
        torch.ones_like(t, dtype=torch.bool)


def cuda_ms(fn, reps):
    """Median CUDA-event time of fn() in ms (one warm-up call first)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, reps=DEVICE_REPS, tries=3):
    """Device time of one fn() call in ms: the durations of the CUDA
    kernels it launched, from torch.profiler over `reps` calls (one
    warm-up call first), divided by `reps`. Beside cuda_ms, which runs
    from before the wrapper's host work to after the kernel, it tells the
    kernel's own time from the host's. A trace whose averages hold no
    device time is taken again, up to `tries` times; then the last one's
    Chrome trace is read (:func:`trace_device_ms`). Never 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / reps / 1e3
    return trace_device_ms(prof, reps)


def trace_device_ms(prof, reps):
    """The device ms a call of a profile whose ``key_averages`` held no
    device time, summed over the device ops of its exported Chrome trace
    (``tools.trace_summary``), or None (not measured) when the trace holds
    none either; prints which, and what the trace holds."""
    import tempfile
    from planetmodel_sph_tpu_torch.tools import trace_summary
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = trace_summary.load(path)
    ops, total, _, _ = trace_summary.summarise(events)
    if total > 0:
        names = ", ".join(sorted(n.removeprefix("void ").split("(")[0]
                                 for n in ops))
        print(f"  device_ms from the Chrome trace: its averages held no "
              f"device time, the trace {len(ops)} device ops ({names}), "
              f"{total / reps / 1e3:.4f} ms a call", flush=True)
        return total / reps / 1e3
    cats = sorted({str(e.get("cat")) for e in events})
    print(f"  device_ms not measured: neither the averages nor the Chrome "
          f"trace hold a device op ({len(events)} events, categories "
          f"{cats})", flush=True)
    return None


def fmt_ms(v, digits=4):
    """A time for the report: its digits, or "not measured" for None."""
    return "not measured" if v is None else f"{v:.{digits}f}"


def host_us(fn, reps=HOST_REPS):
    """Median host microseconds of one fn() call, from before the call to
    its return (the card runs behind; one synchronize every 50 calls keeps
    the launch queue short)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for k in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        times.append((time.perf_counter_ns() - t0) / 1e3)
        if k % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def _group_slices(g, step=SLICE_GROUPS):
    for g0 in range(0, g, step):
        yield g0, min(g, g0 + step)


def _step(b, s):
    """Groups per slice of a [groups, b, s] intermediate: SLICE_GROUPS, or
    fewer where b * s exceeds the production filter's 64 x 7,680."""
    return max(1, min(SLICE_GROUPS, SLICE_GROUPS * 64 * 7680 // (b * s)))


def _n(mask) -> int:
    return int(mask.sum())


def _slots_below_nv(nv, s) -> int:
    import torch
    return int(torch.clamp(nv, max=s).sum())


def _live(nv, m):
    """[g, 1, S] mask of window slots below nv with m > 0 (m: [g, 1, S])."""
    import torch
    slot = torch.arange(m.shape[-1], device=nv.device)[None, None, :]
    return (slot < nv[:, None, None]) & (m > 0.0)


def _io_bytes(cols, windows, whole, outs) -> int:
    """Bytes the function must move: target columns, whole inputs and
    outputs once each, window rows only in their slots below nv."""
    n = sum(t.numel() * t.element_size() for t in [*cols, *whole, *outs])
    for nv, rows in windows:
        n += nv.numel() * nv.element_size() + _slots_below_nv(
            nv, rows[0].shape[1]) * sum(r.element_size() for r in rows)
    return n


def _filter_ops(a):
    """Target tests the filter makes on this data: every live slot stops at
    its first interacting target (or tests all B)."""
    import torch
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    tests = 0
    for g0, g1, nv_c, rows in _filter_slices(nv, b, src):
        tx, ty, tz, tc, tsk = (c[g0 * b:g1 * b].reshape(g1 - g0, b, 1)
                               for c in tgt)
        sx, sy, sz, sc, ssk, sm = (r[:, None, :] for r in rows)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        cut = torch.maximum(tc, sc) + tsk + ssk
        hit = r2 < cut * cut
        first = torch.where(hit.any(dim=1),
                            hit.int().argmax(dim=1) + 1, b)
        live = _live(nv_c, sm)[:, 0, :]
        tests += int(torch.where(live, first, 0).sum())
    return OPS_FILTER * tests + OPS_SLOT_TEST * _slots_below_nv(nv, s)


def _filter_slices(nv, b, src):
    """(g0, g1, nv, rows) of the filter's models: slices of groups
    (``_step``), each in slices of its slots where one group's [B, S]
    intermediates would not fit (``_slot_slices``); nv and the rows cut to
    them."""
    g, s = src[0].shape
    for g0, g1 in _group_slices(g, _step(b, s)):
        rows = [r[g0:g1] for r in src]
        for s0, s1 in _slot_slices(g1 - g0, b, s, FILTER_MODEL_ELEMS):
            yield (g0, g1, *_slot_cut(nv[g0:g1], rows, s0, s1))


def _pass1_ops(a):
    """Pass 1's operations, each live (target, slot) pair charged by the
    branch of q = sqrt(r2)/h_i it takes, as the plain version masks it."""
    import torch
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    ops = OPS_SLOT_TEST * _slots_below_nv(nv, s)
    for g0, g1 in _group_slices(g, _step(b, s)):
        tx, ty, tz, tih = (c[g0 * b:g1 * b].reshape(g1 - g0, b, 1)
                           for c in tgt)
        sx, sy, sz, sm = (r[g0:g1, None, :] for r in src)
        live = _live(nv[g0:g1], sm)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        q = torch.sqrt(dxx * dxx + dxy * dxy + dxz * dxz) * tih
        ops += _by_branch(OPS_P1, live, q)
    return ops


def _dyer_ip_ops(live, x):
    return (OPS_DYER_IP["near"] * _n(live & (x < 1.0))
            + OPS_DYER_IP["far"] * _n(live & (x >= 1.0)))


def _by_branch(table, live, q):
    """Operations of a spline term charged by the branch of q each live
    pair takes."""
    return (table["inner"] * _n(live & (q < 1.0))
            + table["outer"] * _n(live & (q >= 1.0) & (q < 2.0))
            + table["none"] * _n(live & (q >= 2.0)))


def _pass1_sym_ops(a):
    """pass1_sym's operations: on each live pair outside both supports
    (r min(ih_i, ih_j) >= 2, where neither spline adds anything) the
    geometry and the skip test; on each other live pair the geometry and
    the count, and each side's spline and sum by the branch of its q."""
    import torch
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    ops = OPS_SLOT_TEST * _slots_below_nv(nv, s)
    for g0, g1 in _group_slices(g, _step(b, s)):
        tx, ty, tz, tih = (c[g0 * b:g1 * b].reshape(g1 - g0, b, 1)
                           for c in tgt)
        sx, sy, sz, sih, sm = (r[g0:g1, None, :] for r in src)
        live = _live(nv[g0:g1], sm)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        r = torch.sqrt(dxx * dxx + dxy * dxy + dxz * dxz)
        qi, qj = r * tih, r * sih
        inside = live & ~((qi >= 2.0) & (qj >= 2.0))
        ops += (OPS_P1S_SKIP * _n(live & ~inside)
                + (OPS_P1S_GEOM + OPS_P1S_SUM_I + OPS_P1S_SUM_J)
                * _n(inside) + _by_branch(OPS_P1S_W, inside, qi)
                + _by_branch(OPS_P1S_W, inside, qj))
    return ops


def _p2p_branches(nv, rows, tgt, receiver, g0, g1, b):
    """The live pairs of one P2P window for groups [g0, g1) and their
    Dyer-Ip x = r/a."""
    import torch
    tx, ty, tz, tih = (c[g0 * b:g1 * b].reshape(g1 - g0, b, 1)
                       for c in tgt[:4])
    r3 = [r_[g0:g1, None, :] for r_ in rows]
    px, py, pz, pm = r3[0], r3[1], r3[2], r3[-1]
    live = _live(nv[g0:g1], pm)
    dxx, dxy, dxz = tx - px, ty - py, tz - pz
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))
    inv_a = tih if receiver else torch.minimum(tih, r3[3])
    return live, r * inv_a


def _p2p_window_ops(nv, rows, tgt, receiver, g0, g1, b):
    """One P2P window's operations for groups [g0, g1): the geometry, the
    count and the Dyer-Ip branch on each live pair (no fmin under receiver
    softening)."""
    live, x = _p2p_branches(nv, rows, tgt, receiver, g0, g1, b)
    return ((OPS_GEOM + OPS_COUNT - (1 if receiver else 0)) * b * _n(live)
            + _dyer_ip_ops(live, x))


def _p2p_ops(a, kw):
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    ops = OPS_SLOT_TEST * _slots_below_nv(nv, s)
    for g0, g1 in _group_slices(g, _step(b, s)):
        ops += _p2p_window_ops(nv, src, tgt, kw["receiver_soft"], g0, g1, b)
    return ops


def _pass2_ops(a, kw):
    """Pass 2's operations under its flags (`energy`: see OPS_EN): on each
    live SPH pair the
    geometry and the gw branch of q_i and q_j (the pressure sums only where
    a gw is not 0); with grav the count and the Dyer-Ip branch of x = r/a;
    with av v.d on the pairs inside either support, Pi_ij and the viscosity
    sums on the approaching ones (the correct-derivative gw again under the
    sign bug), the div/curl sums on all of them with balsara; on each live
    pair of a merged P2P window the geometry, the count and the Dyer-Ip
    branch."""
    import torch
    nv, tgt, src = a
    mode = kw.get("mode", "grad_h")
    av, balsara = kw.get("av", False), kw.get("balsara", False)
    energy = kw.get("energy", False)
    grav, receiver = kw.get("grav", False), kw.get("receiver_soft", False)
    p2p = kw.get("p2p_rows")
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    ops = OPS_SLOT_TEST * _slots_below_nv(nv, s)
    if p2p is not None:
        ops += OPS_SLOT_TEST * _slots_below_nv(kw["nv_p2p"],
                                               p2p[0].shape[1])
    n_t = 4 if mode == "reference_asymmetric" else 5
    for g0, g1 in _group_slices(g, slice_groups(a, kw)):
        cols = [c[g0 * b:g1 * b].reshape(g1 - g0, b, 1) for c in tgt]
        rows = [r[g0:g1, None, :] for r in src]
        tx, ty, tz, tih = cols[:4]
        sx, sy, sz, sih, sm = rows[:5]
        live = _live(nv[g0:g1], sm)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))
        qi, qj = r * tih, r * sih
        sup = live & ((qi < 2.0) | (qj < 2.0))
        gw = _by_branch(OPS_GW, live, qi) + _by_branch(OPS_GW, live, qj) \
            + OPS_GW_JH4 * _n(live & (qj < 2.0))
        ops += ((OPS_GEOM + OPS_GW_PAIR) * b * _n(live) + gw
                + (OPS_GP_SUM + OPS_GP_MODE[mode]) * _n(sup))
        if grav:
            inv_a = tih if receiver else torch.minimum(tih, sih)
            ops += ((OPS_COUNT - (1 if receiver else 0)) * b * _n(live)
                    + _dyer_ip_ops(live, r * inv_a))
        if av or energy:
            vdotr = ((cols[n_t] - rows[6]) * dxx + (cols[n_t + 1] - rows[7])
                     * dxy + (cols[n_t + 2] - rows[8]) * dxz)
            near = sup & (vdotr < 0.0)
        if energy:
            # the pressure work where its gw is not 0, half the viscous
            # dissipation on the approaching pairs, v.d unless the
            # viscosity has it
            en = live & (qi < 2.0) if mode == "grad_h" else sup
            ops += (OPS_EN[mode] * _n(en)
                    + (OPS_EN_AV * _n(near) if av
                       else OPS_EN_VDOTR * _n(sup)))
        if av:
            ops += (OPS_AV_VDOTR * _n(sup)
                    + (OPS_AV_PI + OPS_AV_SUM
                       + (OPS_AV_BAL if balsara else 0)) * _n(near)
                    + OPS_AV_GSYM * _n(sup if balsara else near))
            if kw.get("sign_bug"):
                ops += gw
            if balsara:
                ops += OPS_AV_DC * _n(sup)
        del live, sup, dxx, dxy, dxz, r2, r, qi, qj, cols, rows
        if p2p is not None:
            ops += _p2p_window_ops(kw["nv_p2p"], p2p, tgt, receiver, g0, g1,
                                   b)
    return ops


def _gravity_entries(a, kw=None):
    """gravity_fused's (live entries evaluated for every target, entry
    tests): ring and blk slots below their nv with m > 0 and far entries
    with accept and m > 0; the m test per slot below nv, the accept test
    per (group, entry) and the m test where accepted."""
    import torch
    nv, tgt, ring, far, acc = a
    sr = ring[0].shape[1]
    slot = torch.arange(sr, device=nv.device)[None, :] < nv[:, None]
    took = acc > 0.5
    n_eval = _n(slot & (ring[0] > 0.0)) + _n(took & (far[0] > 0.0))
    n_test = _n(slot) + acc.numel() + _n(took)
    blk = (kw or {}).get("blk_rows")
    if blk is not None:
        # the supergroup partition's windowed block tier: the ring's work
        # per live entry, and its m test per slot below nv_blk
        bslot = (torch.arange(blk[0].shape[1], device=nv.device)[None, :]
                 < kw["nv_blk"][:, None])
        n_eval += _n(bslot & (blk[0] > 0.0))
        n_test += _n(bslot)
    return n_eval, n_test


def _bf16_ops(name, a, kw):
    """(the f32 operations of the f32 instance that the bf16 instance runs
    in bf16, the bf16 operations) of one bf16 call of p2p or
    gravity_fused, by the branch this data takes."""
    nv, tgt = a[0], a[1]
    g = n_groups(a)
    b = tgt[0].shape[0] // g
    if name == "p2p":
        windows, n_mono = [(nv, a[2], kw["receiver_soft"])], 0
    else:
        windows = ([(kw["nv_p2p"], kw["p2p_rows"],
                     kw.get("receiver_soft", False))]
                   if kw.get("p2p_rows") is not None else [])
        n_mono = _gravity_entries(a, kw)[0]
    moved = b * OPS_MONO_IN_BF16 * n_mono
    ops = b * (OPS_MONO_IN_BF16 + OPS_CAST_MONO) * n_mono
    for nvw, rows, receiver in windows:
        for g0, g1 in _group_slices(g, _step(b, rows[0].shape[1])):
            live, x = _p2p_branches(nvw, rows, tgt, receiver, g0, g1, b)
            for branch, n in (("near", _n(live & (x < 1.0))),
                              ("far", _n(live & (x >= 1.0)))):
                moved += OPS_DYER_IP_IN_BF16[branch] * n
                ops += (OPS_DYER_IP_IN_BF16[branch] + OPS_CAST_PAIR) * n
    return moved, ops


def _gravity_ops(a, kw=None):
    """gravity_fused's operations: one multipole evaluation per target and
    live entry (ring and blk slots below their nv with m > 0, far entries
    with accept and m > 0), the windows' m test per (group, slot) and the
    far scan's accept
    test per (group, entry) plus its m test where accepted; with the near
    tier its window's pairs as p2p counts them."""
    nv, tgt, ring, far, acc = a
    g = ring[0].shape[0]
    b = tgt[0].shape[0] // g
    n_eval, n_test = _gravity_entries(a, kw)
    per = OPS_MONO + (OPS_QUAD if len(ring) == 10 else 0)
    ops = b * per * n_eval + n_test
    p2p = (kw or {}).get("p2p_rows")
    if p2p is not None:
        nvp = kw["nv_p2p"]
        ops += OPS_SLOT_TEST * _slots_below_nv(nvp, p2p[0].shape[1])
        for g0, g1 in _group_slices(g, _step(b, p2p[0].shape[1])):
            ops += _p2p_window_ops(nvp, p2p, tgt,
                                   kw.get("receiver_soft", False), g0, g1,
                                   b)
    return ops


def _row_blocks(n, block=512):
    return [(i0, min(n, i0 + block)) for i0 in range(0, n, block)]


def plan_cells(pos, h, perm):
    """The boxes of a plan as the kernels form them (``common.cuh``
    psph_box_far, here in float64 on the card: a model for the counts,
    not the kernels' bits): each particle's box (its position's rank in
    the plan over the box size) and the [boxes, boxes] mask of far box
    pairs."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    n = pos.shape[0]
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(n, device=perm.device)
    cell = rank // pw.SUB
    nb = -(-n // pw.SUB)
    inv_h = (1.0 / torch.where(h > 0, h, 1.0)).double()
    p = pos.double()
    lo = torch.full((nb, 3), math.inf, dtype=torch.float64,
                    device=pos.device).index_reduce_(0, cell, p, "amin")
    hi = torch.full((nb, 3), -math.inf, dtype=torch.float64,
                    device=pos.device).index_reduce_(0, cell, p, "amax")
    ihm = torch.full((nb,), math.inf, dtype=torch.float64,
                     device=pos.device).index_reduce_(0, cell, inv_h,
                                                      "amin")
    gap = torch.clamp(torch.maximum(lo[:, None] - hi[None, :],
                                    lo[None, :] - hi[:, None]), min=0.0)
    d2 = (gap * gap).sum(dim=-1)
    m = torch.minimum(ihm[:, None], ihm[None, :])
    far = (d2 * m) * m > _cu_define("pairwise_pass1", "PSPH_FAR_Q2",
                                    "common.cuh")
    return cell, far & (d2 >= _cu_define("pairwise_pass1", "PSPH_R2_FLOOR",
                                         "common.cuh"))


def _pw_branches(pos, inv_h, i0, i1, cells=None):
    """[block, n] masks and q of the pairs of target rows [i0, i1): not the
    self pair, the pairs the q^2 test keeps (r2 ihm^2 <= PSPH_Q2_SKIP, ihm
    the smaller 1/h), and q_i and q_j as the all-pairs kernels form them;
    with `cells` (:func:`plan_cells`), the pairs of near box pairs last
    (all pairs without)."""
    import torch
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dxx = x[i0:i1, None] - x[None, :]
    dxy = y[i0:i1, None] - y[None, :]
    dxz = z[i0:i1, None] - z[None, :]
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    idx = torch.arange(pos.shape[0], device=pos.device)
    pair = idx[i0:i1, None] != idx[None, :]
    ihm = torch.minimum(inv_h[i0:i1, None], inv_h[None, :])
    kept = pair & ~((r2 * ihm) * ihm > _q2_skip())
    r = torch.sqrt(r2)
    near = torch.ones_like(pair)
    if cells is not None:
        cell, far = cells
        near = ~far[cell[i0:i1, None], cell[None, :]]
    return pair, kept, r2, r * inv_h[i0:i1, None], r * inv_h[None, :], \
        (dxx, dxy, dxz), near


@functools.lru_cache(maxsize=None)
def _q2_skip():
    return _cu_define("pairwise_pass1", "PSPH_Q2_SKIP", "common.cuh")


def _pairwise_pass1_ops(pos, h, mass, cfg, cells=None):
    """Pass 1's operations on this data: every pair's q^2 test, the rest of
    the geometry on the pairs it keeps, the spline branches of q_i and q_j
    on pairs inside either support, and, with direct gravity, the outer
    Dyer-Ip branch on the pairs the test skips and the branch of x = r / a
    on those it keeps. Under a plan (`cells`, :func:`plan_cells`) only the
    pairs of near box pairs take the test; with gravity the others
    OPS_PW_FAR."""
    import torch
    n = pos.shape[0]
    inv_h = 1.0 / torch.where(h > 0, h, 1.0)
    gravity = cfg.gravity_solver == "direct"
    receiver = cfg.softening_mode == "receiver_h"
    ops = 0
    for i0, i1 in _row_blocks(n):
        pair, kept, r2, qi, qj, _, near = _pw_branches(pos, inv_h, i0, i1,
                                                       cells)
        sph = pair & ((qi < 2.0) | (qj < 2.0))
        ops += (OPS_PW_SKIP * _n(pair & near) + OPS_PW_NEAR * _n(kept)
                + OPS_PW_RHO * _n(sph) + _by_branch(OPS_PW_W, sph, qi)
                + _by_branch(OPS_PW_W, sph, qj))
        if gravity:
            inv_a = inv_h[i0:i1, None].expand_as(r2) if receiver \
                else torch.minimum(inv_h[i0:i1, None], inv_h[None, :])
            x = (r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))) * inv_a
            ops += (OPS_PW_GRAV_FAR * _n(pair & ~kept & near)
                    + OPS_PW_FAR * _n(pair & ~near)
                    + (OPS_PW_GRAV - (1 if receiver else 0)) * _n(kept)
                    + _dyer_ip_ops(kept, x))
    return ops


def _pairwise_pass2_ops(pos, h, mass, cfg, vel, cells=None):
    """Pass 2's operations on this data: every pair's q^2 test, the rest of
    the geometry on the pairs it keeps; on pairs inside either support the
    gradient branches, the pressure coefficient and the sums; with
    viscosity v.x on those pairs, Pi_ij on the approaching ones, the
    correct-derivative gradient again under the sign bug and the div/curl
    sums under Balsara. Under a plan (`cells`) only the pairs of near box
    pairs take the test."""
    import torch
    n = pos.shape[0]
    inv_h = 1.0 / torch.where(h > 0, h, 1.0)
    av = cfg.av_alpha > 0.0 and vel is not None
    balsara = cfg.av_balsara and av
    mode = ("asymmetric" if cfg.grad_p_mode == "reference_asymmetric"
            else "symmetric")
    ops = 0
    for i0, i1 in _row_blocks(n):
        pair, kept, r2, qi, qj, (dxx, dxy, dxz), near = _pw_branches(
            pos, inv_h, i0, i1, cells)
        ops += OPS_PW_SKIP * _n(pair & near)
        sup = pair & ((qi < 2.0) | (qj < 2.0))
        grad = (_by_branch(OPS_PW_GW, sup, qi) + _by_branch(OPS_PW_GW, sup, qj)
                + OPS_PW_GW_CJ * _n(sup & (qj < 2.0))
                + OPS_PW_GW_SYM * _n(sup))
        ops += OPS_PW_NEAR * _n(kept) + grad \
            + (OPS_PW_COEF[mode] + OPS_PW_GP_SUM) * _n(sup)
        if av:
            vdotr = ((vel[i0:i1, 0, None] - vel[None, :, 0]) * dxx
                     + (vel[i0:i1, 1, None] - vel[None, :, 1]) * dxy
                     + (vel[i0:i1, 2, None] - vel[None, :, 2]) * dxz)
            ops += (OPS_PW_VDOTR * _n(sup)
                    + (OPS_PW_PI + (OPS_PW_PI_BAL if balsara else 0))
                    * _n(sup & (vdotr < 0.0)))
            if cfg.kernel_deriv_sign_bug:
                ops += grad
            if balsara:
                ops += OPS_PW_DC * _n(sup)
    return ops


def pairwise_shares(pos, h):
    """What the all-pairs kernels visit on this data: of the n (n - 1)
    pairs j != i, the share inside either support (r ih_i < 2 or r ih_j <
    2) and the share the q^2 test skips (r2 ihm^2 > PSPH_Q2_SKIP)."""
    import torch
    n = pos.shape[0]
    inv_h = 1.0 / torch.where(h > 0, h, 1.0)
    inside = skipped = 0
    for i0, i1 in _row_blocks(n):
        pair, kept, _, qi, qj, _, _ = _pw_branches(pos, inv_h, i0, i1)
        inside += _n(pair & ((qi < 2.0) | (qj < 2.0)))
        skipped += _n(pair & ~kept)
    pairs = n * (n - 1)
    return dict(pairs=pairs, inside_share=inside / pairs,
                skipped_share=skipped / pairs)


def pairwise_bound(name, args, kw, cfg, out, cells=None):
    """(bound_ms, bound_by, bytes, ops) of one all-pairs call: every input
    array read once and every output written once over the HBM rate,
    against the f32 operations this data needs over the f32 peak (under a
    plan's `cells`, those of its sweep)."""
    out = list(out) if isinstance(out, tuple) else [out]
    tensors = [*args, *(v for v in kw.values() if v is not None), *out]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if name == "pairwise_pass1":
        ops = _pairwise_pass1_ops(*args, cfg, cells)
    else:
        pos, h, mass = args[:3]
        ops = _pairwise_pass2_ops(pos, h, mass, cfg, kw.get("vel"), cells)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def bound(name, a, kw, out):
    """(bound_ms, bound_by, bytes, ops) for this call: the bytes the
    function must move over the HBM rate, against the f32 operations this
    data needs over the f32 peak (a bf16 call: plus its bf16 operations
    over the packed bf16 peak; `ops` counts both)."""
    out = list(out) if isinstance(out, tuple) else [out]
    if name in PROBES:
        nbytes, ops = _probe_work(name, a, kw, out)
    elif name == "filter_sph":
        nv, tgt, src = a
        nbytes = _io_bytes(tgt, [(nv, src)], [], out)
        ops = _filter_ops(a)
    elif name == "pass1_gradh":
        nv, tgt, src = a
        nbytes = _io_bytes(tgt, [(nv, src)], [], out)
        ops = _pass1_ops(a)
    elif name == "pass1_sym":
        nv, tgt, src = a
        nbytes = _io_bytes(tgt, [(nv, src)], [], out)
        ops = _pass1_sym_ops(a)
    elif name == "p2p":
        nv, tgt, src = a
        nbytes = _io_bytes(tgt, [(nv, src)], [], out)
        ops = _p2p_ops(a, kw)
    elif name == "pass2":
        nv, tgt, src = a
        windows = [(nv, src)]
        if kw.get("p2p_rows") is not None:
            windows.append((kw["nv_p2p"], kw["p2p_rows"]))
        nbytes = _io_bytes(tgt, windows, [], out)
        ops = _pass2_ops(a, kw)
    else:
        nv, tgt, ring, far, acc = a
        windows = [(nv, ring)]
        cols = tgt[:3]      # the softening column is read by the near tier
        if kw.get("p2p_rows") is not None:
            windows.append((kw["nv_p2p"], kw["p2p_rows"]))
            cols = tgt
        if kw.get("blk_rows") is not None:
            windows.append((kw["nv_blk"], kw["blk_rows"]))
        nbytes = _io_bytes(cols, windows, [*far, acc], out)
        ops = _gravity_ops(a, kw)
    ops_bf16 = 0
    if kw.get("bf16"):
        moved, ops_bf16 = _bf16_ops(name, a, kw)
        ops -= moved
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (ops / PEAK_F32 + ops_bf16 / PEAK_BF16) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops + ops_bf16)


def _tile_ops(a, kw):
    """probe_pass1_tile's operations on this data: each live (target,
    slot) pair below the extent charged by the branch of its signed q,
    each such slot's live test once per instance, each target's
    prefactor."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    nv, tgt, rows = a
    gb, s = rows[0].shape
    tb = kw["tb"]
    ext = probes.tile_extent(nv, s, kw.get("chunk", 512))
    ops = OPS_TILE_SLOT * int(ext.sum()) + OPS_TILE_TARGET * gb * tb
    width = int(ext.max())
    slot = torch.arange(width, device=nv.device)
    step = max(1, SLICE_ELEMS // (tb * max(width, 1)))
    for g0, g1 in _group_slices(gb, step):
        tx, ty, tz, tih = (c[g0 * tb:g1 * tb].reshape(g1 - g0, tb, 1)
                           for c in tgt)
        sx, sy, sz, _, slv = (r[g0:g1, None, :width] for r in rows)
        live = (slot[None, None, :] < ext[g0:g1, None, None]) & (slv > 0.5)
        live = live.expand(g1 - g0, tb, width)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        q = torch.sqrt(dxx * dxx + dxy * dxy + dxz * dxz) * tih
        ops += ((OPS_TILE_GEOM + OPS_TILE_SUM) * _n(live)
                + _by_branch(OPS_TILE_W, live, q))
    return ops


def _probe_work(name, a, kw, out):
    """(bytes, operations) of one probe call: inputs read once, outputs
    written once (a tile's m and live rows only below each instance's
    extent, its x, y and z over its span, where a far-out position still
    reaches the sum)."""
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    if name == "probe_pass1_tile":
        nv, tgt, rows = a
        s, chunk = rows[0].shape[1], kw.get("chunk", 512)
        ext = int(probes.tile_extent(nv, s, chunk).sum())
        span = int(probes.tile_span(nv, s, chunk).sum())
        nbytes = (_io_bytes(tgt, [], [nv], out)
                  + span * sum(r.element_size() for r in rows[:3])
                  + ext * sum(r.element_size() for r in rows[3:]))
        return nbytes, _tile_ops(a, kw)
    nbytes = _io_bytes([], [], list(a), out)
    if name == "probe_fma":
        return nbytes, OPS_FMA_REP * kw["reps"] * a[0].numel()
    if name == "probe_launch":
        return nbytes, a[0].numel()
    return nbytes, 0


def ptxas_instances(log):
    """Each entry point of one source's `-Xptxas -v` log: its template
    arguments (a tuple of ints, empty for a plain function), registers,
    shared memory, stack frame and spills in bytes."""
    import re
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(entry=m.group(1), args=tuple(
                int(v) for v in re.findall(r"L[ib](\d+)E", m.group(1))),
                regs=0, smem=0, stack=0, spill_stores=0, spill_loads=0)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def one_block_sass(lib):
    """{WIDE: [instruction, ...]} of filter_sph.cu's one-block instances
    (no TILED argument, or 0) in a library's SASS (``cuobjdump -sass``):
    each instruction's text, without its address and encoding."""
    import re
    from planetmodel_sph_tpu_torch.ops.cuda import build
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            args = [int(v) for v in re.findall(r"L[ib](\d+)E", m.group(1))]
            cur = None
            if "filter_sph_kernel" in m.group(1) and (
                    len(args) == 1 or args[1:] == [0]):
                cur = out.setdefault(args[0], [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", ln)
        if m and cur is not None:
            cur.append(m.group(1))
    return out


def sass_against_parent(parent_lib):
    """filter_sph's one-block instances here against the parent's
    (``--parent``): (report {WIDE: dict(instructions, parent, same)},
    failures). The tiled path must leave them as they were."""
    from planetmodel_sph_tpu_torch.ops.cuda import build
    mine = one_block_sass(build.lib_path("filter_sph"))
    theirs = one_block_sass(parent_lib)
    rep = {w: dict(instructions=len(mine.get(w, [])),
                   parent=len(theirs.get(w, [])),
                   same=bool(mine.get(w)) and mine.get(w) == theirs.get(w))
           for w in sorted(set(mine) | set(theirs))}
    for w, r in rep.items():
        print(f"  sass filter_sph one-block WIDE={w}: {r['instructions']} "
              f"instructions, the parent's {r['parent']}, the same: "
              f"{r['same']}", flush=True)
    bad = [w for w, r in rep.items() if not r["same"]]
    return rep, ([f"filter_sph's one-block SASS (WIDE={bad}) differs from "
                  "the parent's"] if bad or len(rep) != 2 else [])


def sass_pair_loops(sass):
    """probe_pass1_tile's sweep loops in its SASS (``cuobjdump -sass``):
    {kernel instance: [(instructions a live pair, exact)]}, one entry per
    innermost loop (a backward branch whose body holds no other) with a
    MUFU.RSQ in its body, one a live pair; `exact` where the body calls
    the square root's slow path (__fsqrt_rn past its range test)."""
    import re
    out, fn, ins = {}, None, []

    def close():
        if fn is None:
            return
        back = [(int(m.group(1), 16), addr) for addr, txt in ins
                for m in [re.search(r"BRA (0x[0-9a-f]+)", txt)]
                if m and int(m.group(1), 16) < addr]
        loops = []
        for lo, hi in back:
            if sum(lo <= a and b <= hi for a, b in back) != 1:
                continue
            body = [t for a, t in ins if lo <= a <= hi]
            pairs = sum("MUFU.RSQ" in t for t in body)
            if pairs:
                loops.append((len(body) / pairs,
                              any("CALL" in t for t in body)))
        out[fn] = loops

    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            close()
            fn, ins = m.group(1), []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m and fn is not None:
            ins.append((int(m.group(1), 16), m.group(2)))
    close()
    return out


def instance_key(name, kw, a=None):
    """The template arguments of the instance a call launches (pass2: mode,
    sign bug, viscosity, Balsara, gravity 0/1/2, receiver softening,
    energy, as pass2.cu orders them; gravity_fused: its near tier 0/1/2,
    the moment fields of the ring rows `a[2]` and bf16 0/1; p2p: receiver
    softening 0/1 and bf16 0/1; filter_sph: more than 32 boxes of 16
    targets a block, 0/1, and the tiled path, 0/1 (a tile's targets as
    the wrapper cuts them, ``groups2.filter_tiles``);
    pass1_gradh and pass1_sym have none)."""
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    if name == "filter_sph":
        b, tiled = kw["b"], kw["b"] > gk2.FILTER_MAX_GROUP
        if tiled:
            import torch
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            _, b = gk2.filter_tiles(b, n_groups(a),
                                    gk2.FILTER_BLOCKS_PER_SM * sms)
        return (name, (int(b > 32 * 16), int(tiled)))
    bf16 = int(bool(kw.get("bf16")))
    if name == "gravity_fused":
        near = (2 if kw.get("receiver_soft") else 1) \
            if kw.get("p2p_rows") is not None else 0
        return (name, (near, len(a[2]), bf16))
    if name == "p2p":
        return (name, (int(bool(kw.get("receiver_soft"))), bf16))
    if name != "pass2":
        return (name, ())
    grav = (2 if kw.get("p2p_rows") is not None else 1) if kw.get("grav") \
        else 0
    return (name, (gk2.MODES.index(kw.get("mode", "grad_h")),
                   int(kw.get("sign_bug", False)), int(kw.get("av", False)),
                   int(kw.get("balsara", False)), grav,
                   int(bool(kw.get("receiver_soft")) and grav > 0),
                   int(kw.get("energy", False))))


def _cu_define(source, name, header=None):
    """The value of ``#define name <number>[f]`` in csrc/<source> (or in
    the `header` beside it)."""
    import re
    path = os.path.join(ROOT, KERNELS[source][0])
    if header:
        path = os.path.join(os.path.dirname(path), header)
    with open(path) as f:
        m = re.search(rf"#define\s+{name}\s+([0-9.eE+-]+)f?\b", f.read())
    if not m:
        raise RuntimeError(f"{name} not found in {path}")
    return float(m.group(1))


def _gravity_shares(a, kw):
    """What gravity_fused evaluates: the far entries accepted with m > 0
    among all (group, entry) slots, and the ring (and blk) slots below nv
    with m > 0 among those below nv."""
    import torch
    nv, tgt, ring, far, acc = a

    def window(nv_w, m):
        slot = torch.arange(m.shape[1], device=nv_w.device)[None, :] \
            < nv_w[:, None]
        below, live = _n(slot), _n(slot & (m > 0.0))
        return below, live, live / max(below, 1)

    far_live = _n((acc > 0.5) & (far[0] > 0.0))
    out = dict(far_entries=acc.numel(), far_live=far_live,
               far_live_share=far_live / max(acc.numel(), 1))
    (out["ring_slots_below_nv"], out["ring_live"],
     out["ring_live_share"]) = window(nv, ring[0])
    if kw.get("blk_rows") is not None:
        (out["blk_slots_below_nv"], out["blk_live"],
         out["blk_live_share"]) = window(kw["nv_blk"], kw["blk_rows"][0])
    if kw.get("p2p_rows") is not None:
        # the near tier keeps the slots with m != 0
        (out["near_slots_below_nv"], out["near_live"],
         out["near_live_share"]) = window(kw["nv_p2p"],
                                          kw["p2p_rows"][-1].abs())
    return out


def _filter_shares(a, kw):
    """What filter_sph visits, modelled as filter_sph.cu decides: of the
    live slots (below nv, m > 0), the share kept, the share the bounding
    boxes of PSPH_FILTER_BOX targets pre-reject whole, the boxes whose
    targets a live slot tests (every box that does not pre-reject it) and
    the exact tests it makes (each such box's targets in order, to the
    first hit), beside the tests the bound charges (every target up to the
    first hit)."""
    import torch
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    size = int(_cu_define("filter_sph", "PSPH_FILTER_BOX"))
    margin = _cu_define("filter_sph", "PSPH_FILTER_MARGIN")
    nbox = -(-b // size)
    pad = nbox * size - b
    nan = float("nan")
    live_n = kept = rejected = boxes = tests = charged = 0
    for g0, g1, nv_c, rows in _filter_slices(nv, b, src):
        gs, s = g1 - g0, rows[0].shape[1]
        tx, ty, tz, tc, tsk = (c[g0 * b:g1 * b].reshape(gs, b, 1)
                               for c in tgt)
        sx, sy, sz, sc, ssk, sm = (r[:, None, :] for r in rows)
        live = _live(nv_c, sm)[:, 0, :]
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        cut = torch.maximum(tc, sc) + tsk + ssk
        hit = (r2 < cut * cut) & live[:, None, :]           # [gs, b, S]
        del dxx, dxy, dxz, r2, cut
        first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1, b)
        charged += int(torch.where(live, first, 0).sum())
        # boxes of `size` targets in order (the last one shorter)
        hitp = torch.nn.functional.pad(hit, (0, 0, 0, pad))
        hitb = hitp.reshape(gs, nbox, size, s)
        del hit, hitp
        any_b = hitb.any(dim=2)                               # [gs, nbox, S]
        first_b = hitb.int().argmax(dim=2) + 1
        del hitb
        bx, by, bz, bc, bk = (torch.nn.functional.pad(c[:, :, 0], (0, pad))
                              .reshape(gs, nbox, size)
                              for c in (tx, ty, tz, tc, tsk))
        valid = (torch.arange(nbox * size, device=nv.device)
                 < b).reshape(1, nbox, size)
        big = torch.tensor(float("inf"), device=nv.device)
        lo = [torch.where(valid, v, big).amin(dim=2)[..., None]
              for v in (bx, by, bz)]
        hi = [torch.where(valid, v, -big).amax(dim=2)[..., None]
              for v in (bx, by, bz)]
        fin = torch.ones_like(valid.expand(gs, -1, -1))
        for v in (bx, by, bz, bc, bk):
            fin = fin & (torch.isfinite(v) | ~valid)
        fin = fin & (((bc >= 0.0) & (bk >= 0.0)) | ~valid)
        cmax = torch.where(fin.all(dim=2),
                           torch.where(valid, bc, -big).amax(dim=2),
                           nan)[..., None]
        kmax = torch.where(valid, bk, -big).amax(dim=2)[..., None]
        sfin = (torch.isfinite(sx) & torch.isfinite(sy) & torch.isfinite(sz)
                & torch.isfinite(sc) & torch.isfinite(ssk) & (sc >= 0.0)
                & (ssk >= 0.0))
        sc_pre = torch.where(sfin, sc, nan)
        gap = [torch.clamp(torch.maximum(lo[k] - c, c - hi[k]), min=0.0)
               for k, c in enumerate((sx, sy, sz))]
        d2 = gap[0] * gap[0] + gap[1] * gap[1] + gap[2] * gap[2]
        cut_max = torch.maximum(cmax, sc_pre) + kmax + ssk
        met_ok = ~(d2 >= cut_max * cut_max * margin)          # [gs, nbox, S]
        del gap, d2, cut_max
        tested = met_ok & live[:, None, :]
        sizes = torch.full((nbox,), size, device=nv.device)
        sizes[-1] = b - (nbox - 1) * size
        n_tests = torch.where(any_b, first_b, sizes[None, :, None])
        live_n += _n(live)
        kept += _n(live & any_b.any(dim=1))
        rejected += _n(live & ~met_ok.any(dim=1))
        boxes += _n(tested)
        tests += int(torch.where(tested, n_tests, 0).sum())
    return dict(live_slots=live_n, kept=kept, kept_share=kept / max(live_n, 1),
                prerejected=rejected,
                prereject_share=rejected / max(live_n, 1),
                boxes_tested=boxes / max(live_n, 1),
                tests=tests, tests_per_live=tests / max(live_n, 1),
                charged_per_live=charged / max(live_n, 1))


def window_shares(name, a, kw):
    """What the windowed sweeps visit: the share of window slots below nv
    that are live (m != 0), and of the live (target, slot) pairs the share
    inside the support (q < 2 for pass 1; r min(ih_i, ih_j) < 2 for
    pass1_sym, where either spline adds, and for pass 2, where it adds its
    SPH terms; p2p evaluates every live pair) and, for pass1_sym, the
    share its skip test leaves out; with a merged P2P window its live
    share. gravity_fused and filter_sph: :func:`_gravity_shares`,
    :func:`_filter_shares`."""
    import torch
    if name == "gravity_fused":
        return _gravity_shares(a, kw)
    if name == "filter_sph":
        return _filter_shares(a, kw)
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    m_row = src[3] if name == "pass1_gradh" else src[-1]
    slot = torch.arange(s, device=nv.device)[None, :] < nv[:, None]
    below, live = _n(slot), _n(slot & (m_row != 0.0))
    out = dict(slots_below_nv=below, live_slots=live,
               live_share=live / max(below, 1), live_pairs=b * live)
    if name == "p2p":
        return out
    inside = skipped = 0
    q2_skip = _cu_define("pass1_gradh", "PSPH_Q2_SKIP", "common.cuh")
    for g0, g1 in _group_slices(g, slice_groups(a, kw)):
        tx, ty, tz, tih = (c[g0 * b:g1 * b].reshape(g1 - g0, b, 1)
                           for c in tgt[:4])
        sx, sy, sz = (r[g0:g1, None, :] for r in src[:3])
        lv = slot[g0:g1, None, :] & (m_row[g0:g1, None, :] != 0.0)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        sih = src[3][g0:g1, None, :]
        if name == "pass1_gradh":
            sup = torch.sqrt(r2) * tih < 2.0
        elif name == "pass1_sym":
            sup = torch.sqrt(r2) * torch.minimum(tih, sih) < 2.0
            # pass1_sym.cu's skip: (r2 ihm) ihm > PSPH_Q2_SKIP, ihm the
            # smaller of the positive ih (a NaN or non-positive ih: 0)
            ihm = torch.minimum(torch.where(tih > 0, tih, 0.0),
                                torch.where(sih > 0, sih, 0.0))
            skipped += _n(lv & ((r2 * ihm) * ihm > q2_skip))
            del ihm
        else:
            r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))
            sup = r * torch.minimum(tih, sih) < 2.0
        inside += _n(lv & sup)
        del lv, dxx, dxy, dxz, r2, sup
    out.update(pairs_inside=inside, inside_share=inside / max(b * live, 1))
    if name == "pass1_sym":
        out.update(pairs_skipped=skipped,
                   skipped_share=skipped / max(b * live, 1))
    if kw.get("p2p_rows") is not None:
        nvp, pm = kw["nv_p2p"], kw["p2p_rows"][-1]
        ps = torch.arange(pm.shape[1], device=nv.device)[None, :] \
            < nvp[:, None]
        out["p2p_live_share"] = _n(ps & (pm != 0.0)) / max(_n(ps), 1)
    return out


def same_bits(out, again) -> bool:
    """Two launches' outputs are bit for bit the same."""
    import torch
    out = out if isinstance(out, tuple) else (out,)
    again = again if isinstance(again, tuple) else (again,)
    return all(torch.equal(o.view(torch.int32), r.view(torch.int32))
               for o, r in zip(out, again))


# the kernels whose planted NaNs phase 4 holds against the plain versions
# (the all-pairs kernels: pairwise_plantings)
NAN_CHECKED = ("pass1_gradh", "pass1_sym", "pass2", "p2p", "gravity_fused",
               "filter_sph")


def _live_slot(nv, m_row, gi=None):
    """(group, slot): the last live slot (m != 0, below nv) of group gi,
    by default of the first group with more than one."""
    import torch
    s = m_row.shape[1]
    live = (torch.arange(s, device=nv.device)[None, :] < nv[:, None]) \
        & (m_row != 0.0)
    if gi is None:
        gi = int(torch.nonzero(live.sum(dim=1) > 1)[0])
    return gi, int(torch.nonzero(live[gi])[-1])


def _with_nan(seq, k, at, value=float("nan")):
    """seq with a copy of its k-th tensor that holds a NaN (or `value`) at
    `at`."""
    seq = list(seq)
    seq[k] = seq[k].clone()
    seq[k][at] = value
    return seq


def _filter_plantings(a, kw):
    """filter_sph's plantings, as :func:`nan_plantings` gives them: a NaN
    in the source x, sc, ssk or m of the last slot the plain version keeps
    in the first group that keeps one, and in tc or tsk of every target of
    that group. Each must drop what it touches: a NaN cut or r2 fails the
    test (the planted slot, or every slot of the group), and a NaN m fails
    m > 0."""
    import torch
    b = kw["b"]
    nv, tgt, src = a
    for g0, g1 in _group_slices(n_groups(a), slice_groups(a, kw)):
        keep = filter_plain(*slice_args(a, kw, g0, g1)[0])
        groups = torch.nonzero(keep.any(dim=1))
        if len(groups):
            gi = g0 + int(groups[0])
            j = int(torch.nonzero(keep[gi - g0])[-1])
            break
    else:
        raise RuntimeError("filter_sph: no slot kept to plant a NaN at")
    out = []
    for label, k in (("x", 0), ("sc", 3), ("ssk", 4), ("m", 5)):
        out.append((label, (nv, type(tgt)(tgt),
                            type(src)(_with_nan(src, k, (gi, j)))), kw, gi,
                    True))
    for label, k in (("tc", 3), ("tsk", 4)):
        out.append((label, (nv, type(tgt)(_with_nan(
            tgt, k, slice(gi * b, (gi + 1) * b))), src), kw, gi, True))
    return out


def nan_plantings(name, a, kw):
    """The NaNs phase 4 plants in one kernel call, one planting a launch:
    [(label, args, keywords, group, must_reach)]. Each puts a NaN in one
    field at the last live slot of a group (a pair outside the support
    for most of its targets: where a sweep leaves out work) or, for ih, in
    target 1's column too. pass1_gradh: x with a target ih, and m;
    pass1_sym: x with a target ih, the source and target ih, and m;
    pass2: the source and target ih, m, cc and a velocity row (when the
    form stages one); p2p: ih (source ih under min-h softening) and m;
    gravity_fused: ih (the near tier's source ih too) and m (the ring's,
    and the near tier's). Dead-slot plantings, pass1_sym and p2p: the same
    slot with m = 0 and a NaN ih ("dead ih", under min-h softening for
    p2p) or x ("dead x"), which the compaction must keep where the plain
    version forms NaN from it; gravity_fused with a near tier the same in
    its P2P window's slot ("dead near x", "dead near ih"). `must_reach`:
    the plain version's outputs hold a NaN for this planting whatever the
    inputs (a NaN m of the ring and far tiers is masked out by m > 0, a
    NaN velocity meets no viscosity where no pair approaches, a dead
    slot's NaN x meets pass1_sym only inside a spline of a NaN q, which is
    0, and a dead slot's NaN ih gives its pairs x = NaN, the outer branch
    and m/r = 0).
    filter_sph: :func:`_filter_plantings`."""
    import torch
    if name == "filter_sph":
        return _filter_plantings(a, kw)
    b = kw["b"]
    nv, tgt = a[0], list(a[1])
    if name == "gravity_fused":
        rows, fields = list(a[2]), {"m": 0}
    else:
        rows = list(a[2])
        fields = {"pass1_gradh": {"x": 0, "m": 3},
                  "pass1_sym": {"x": 0, "ih": 3, "m": 4},
                  "pass2": {"ih": 3, "m": 4, "cc": 5},
                  "p2p": {"m": len(rows) - 1}}[name]
        if name == "pass2" and len(rows) > 6:
            fields["velocity"] = 6
        if name == "p2p" and not kw.get("receiver_soft", False):
            fields["ih"] = 3
    m_row = rows[fields["m"]]
    gi, j = _live_slot(nv, m_row)
    near = kw.get("p2p_rows") is not None
    if near:
        prow = list(kw["p2p_rows"])
        _, jp = _live_slot(kw["nv_p2p"], prow[-1], gi)

    def target_ih():
        return _with_nan(tgt, 3, gi * b + min(1, b - 1))

    out = []
    labels = list(fields) + (["ih"] if name == "gravity_fused" else [])
    for label in labels:
        t, r, k2 = tgt, rows, dict(kw)
        if label in ("x", "ih"):
            t = target_ih()
        if label in fields:
            r = _with_nan(rows, fields[label], (gi, j))
        if near and label == "m":
            k2["p2p_rows"] = _with_nan(prow, len(prow) - 1, (gi, jp))
        if near and label == "ih" and name == "gravity_fused" \
                and not kw.get("receiver_soft", False):
            k2["p2p_rows"] = _with_nan(prow, 3, (gi, jp))
        reach = {"pass1_gradh": True, "pass1_sym": True,
                 "pass2": label != "velocity", "p2p": label == "m",
                 "gravity_fused": near and label == "m"}[name]
        args = (nv, type(a[1])(t), type(a[2])(r), *a[3:])
        out.append(("x+ih" if label == "x" else label, args, k2, gi, reach))
    if name in ("pass1_sym", "p2p"):
        # the slot made dead (m = 0), then a NaN x or ih there
        dead = _with_nan(rows, fields["m"], (gi, j), 0.0)
        for label, k in (("x", 0), ("ih", fields.get("ih"))):
            if k is None:
                continue
            args = (nv, a[1], type(a[2])(_with_nan(dead, k, (gi, j))))
            reach = label == ("ih" if name == "pass1_sym" else "x")
            out.append((f"dead {label}", args, kw, gi, reach))
    if name == "gravity_fused" and near:
        dead = _with_nan(prow, len(prow) - 1, (gi, jp), 0.0)
        soft = None if kw.get("receiver_soft", False) else 3
        for label, k in (("x", 0), ("ih", soft)):
            if k is not None:
                k2 = dict(kw, p2p_rows=_with_nan(dead, k, (gi, jp)))
                out.append((f"dead near {label}", a, k2, gi, label == "x"))
    return out


def nan_agreement(name, a, kw):
    """NaNs planted one field at a time (nan_plantings): for the planted
    group, the kernel's outputs must be NaN and infinite exactly where the
    plain version's are, counts equal, and the finite values within the
    case's tolerances (filter_sph: its mask row equal, the planting
    reaching it when the row differs from the unplanted one). Returns
    (message or None, {label: reached})."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    b = kw["b"]
    rows_out = name == "filter_sph"         # a [G, S] mask, not columns
    reached = {}
    for label, pa, pkw, gi, must in nan_plantings(name, a, kw):
        out = getattr(gk2, name)(*pa, **pkw)
        out = out if isinstance(out, tuple) else (out,)
        out = tuple(o[gi:gi + 1] if rows_out else o[gi * b:(gi + 1) * b]
                    for o in out)
        sa, skw = slice_args(pa, pkw, gi, gi + 1)
        ref = plain_fn(name)(*sa, **skw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        msg = non_finite_agree(out, ref)
        if msg:
            return f"{label}: {msg}", reached
        if rows_out:
            base = plain_fn(name)(
                *slice_args(a, kw, gi, gi + 1)[0])
            reached[label] = not torch.equal(ref[0], base)
        else:
            reached[label] = any(bool(torch.isnan(r).any()) for r in ref
                                 if r.is_floating_point())
        if must and not reached[label]:
            return (f"{label}: the planted NaN reached no output of the "
                    "plain version"), reached
        msg = finite_parts_agree(name, out, ref, kw)
        if msg:
            return f"{label}: {msg}", reached
    return None, reached


def non_finite_agree(out, ref):
    """None when the outputs are NaN and infinite (the same infinities)
    exactly where the plain version's are and their counts are equal, else
    what differs."""
    import torch
    for k, (o, r) in enumerate(zip(out, ref)):
        if not r.is_floating_point():
            if not torch.equal(o, r):
                return f"output {k}: counts differ with NaN inputs"
            continue
        same_nan = torch.equal(torch.isnan(o), torch.isnan(r))
        inf = torch.isinf(r)
        same_inf = torch.equal(torch.isinf(o), inf) and \
            torch.equal(o[inf], r[inf])
        if not (same_nan and same_inf):
            return (f"output {k}: NaN at {int(torch.isnan(o).sum())} "
                    f"targets, infinite at {int(torch.isinf(o).sum())}, the "
                    f"plain version at {int(torch.isnan(r).sum())} and "
                    f"{int(inf.sum())}")
    return None


def finite_parts_agree(name, out, ref, kw=None):
    """None when the outputs agree with the plain version's within the
    kernel's tolerances where the plain version's are finite, else what
    differs."""
    import torch
    fin = lambda t, r: torch.where(torch.isfinite(r), t, 0.0) \
        if r.is_floating_point() else t  # noqa: E731
    ok, _, msgs = compare(name, tuple(fin(o, r) for o, r in zip(out, ref)),
                          tuple(fin(r, r) for r in ref), kw)
    return None if ok else f"finite outputs: {msgs}"


def check_one(name, case, a, kw, ptxas=None, parent_libs=None, host=False):
    """One kernel call against its plain version, timed: the report.
    `ptxas`: the build's instances by (kernel, template arguments);
    `parent_libs`: {kernel: library} of another checkout's build, timed in
    turns with this one's; `host`: also the host time of a wrapper call."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    wrapper = getattr(gk2, name)
    out = wrapper(*a, **kw)
    torch.cuda.synchronize()
    ref = plain_sliced(name, a, kw)
    torch.cuda.synchronize()
    ok, err, msgs = compare(name, out, ref, kw)
    extra = {}
    if name in REDESIGNED:
        again = wrapper(*a, **kw)
        torch.cuda.synchronize()
        extra["same_bits"] = same_bits(out, again)
        if not extra["same_bits"]:
            ok = False
            msgs.append("two launches on the same inputs differ")
        del again
        extra["shares"] = window_shares(name, a, kw)
        extra["ptxas"] = (ptxas or {}).get(instance_key(name, kw, a))
    if name in NAN_CHECKED:
        nan_msg, extra["nan_reached"] = nan_agreement(name, a, kw)
        extra["nan_agrees"] = nan_msg is None
        if nan_msg:
            ok = False
            msgs.append(f"planted NaNs: {nan_msg}")
    ms = cuda_ms(lambda: wrapper(*a, **kw), KERNEL_REPS)
    dev_ms = device_ms(lambda: wrapper(*a, **kw))
    if host:
        extra["host_us"] = host_us(lambda: wrapper(*a, **kw))
    if kw.get("bf16"):
        extra.update(bf16_twin(name, a, kw, out))
        if not extra["bf16_vs_f32"] >= BF16_MIN_DIFF:
            ok = False
            msgs.append(f"differs from its f32 twin by only "
                        f"{extra['bf16_vs_f32']:.3e} of max|g| (a bf16 "
                        "instance that did nothing?)")
    if parent_libs and name in parent_libs and \
            (name, case) not in GROUP_SIZE_CASES:
        # the parent's kernel and this one in turns: parent, this, this,
        # parent, on the same inputs through the same wrapper (not at the
        # group sizes the parent's kernels refused), wrapper ms by CUDA
        # events and device ms by the profiler; a bf16 case its bf16
        # instance in both
        from planetmodel_sph_tpu_torch.ops.cuda import build
        turns = {"parent": [], "this": []}
        dev = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            with (build.library(name, parent_libs[name]) if who == "parent"
                  else contextlib.nullcontext()):
                turns[who].append(cuda_ms(lambda: wrapper(*a, **kw),
                                          KERNEL_REPS))
                if name in DEVICE_TURNS:
                    dev[who].append(device_ms(lambda: wrapper(*a, **kw)))
        extra["parent_ms"], extra["ms_in_turns"] = turns["parent"], \
            turns["this"]
        if name in DEVICE_TURNS:
            extra["parent_device_ms"], extra["device_ms_in_turns"] = \
                dev["parent"], dev["this"]
    plain_ms = cuda_ms(lambda: plain_sliced(name, a, kw), PLAIN_REPS)
    b_ms, b_by, nbytes, ops = bound(name, a, kw, out)
    shapes = {"groups": n_groups(a), "b": kw["b"],
              "window": list(a[2][0].shape),
              "targets": len(a[1]), "rows": len(a[2])}
    if kw.get("p2p_rows") is not None:
        shapes["p2p_window"] = list(kw["p2p_rows"][0].shape)
    if name == "gravity_fused":
        shapes["far"] = list(a[4].shape)
        if kw.get("blk_rows") is not None:
            shapes["blk_window"] = list(kw["blk_rows"][0].shape)
    label = name + (f" [{case}]" if case else "")
    hus = (f" host_us={extra['host_us']:.2f}" if "host_us" in extra
           else "")
    print(f"kernel {label}: {'ok' if ok else 'MISMATCH'} "
          f"max_abs_err={err:.3e} ms={ms:.4f} device_ms={fmt_ms(dev_ms)}{hus} "
          f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"shapes={shapes}", flush=True)
    if name in REDESIGNED:
        print(f"  {label}: {visits_line(name, extra)}", flush=True)
    if name in NAN_CHECKED:
        got = ", ".join(f"{k} {'reached' if v else 'masked'}"
                        for k, v in extra["nan_reached"].items())
        print(f"  {label}: planted NaNs "
              f"{'agree' if extra['nan_agrees'] else 'DIFFER'} ({got})",
              flush=True)
    if "bf16_vs_f32" in extra:
        f, h = extra["f32_ms_in_turns"], extra["bf16_ms_in_turns"]
        fd, hd = extra["f32_device_ms"], extra["bf16_device_ms"]
        print(f"  {label}: against its f32 twin: g differs by up to "
              f"{extra['bf16_vs_f32']:.3e} of max|g|, phi by "
              f"{extra['bf16_vs_f32_phi']:.3e}; in turns f32 {f[0]:.4f}, "
              f"bf16 {h[0]:.4f}, bf16 {h[1]:.4f}, f32 {f[1]:.4f} ms "
              f"({sum(f) / sum(h):.2f}x); device f32 {fmt_ms(fd[0])}, bf16 "
              f"{fmt_ms(hd[0])}, bf16 {fmt_ms(hd[1])}, f32 {fmt_ms(fd[1])}"
              " ms", flush=True)
    if "parent_ms" in extra:
        p, t = extra["parent_ms"], extra["ms_in_turns"]
        dev = ""
        if "device_ms_in_turns" in extra:
            pd, td = extra["parent_device_ms"], extra["device_ms_in_turns"]
            dev = (f"; device parent {fmt_ms(pd[0])}, this {fmt_ms(td[0])}, "
                   f"this {fmt_ms(td[1])}, parent {fmt_ms(pd[1])} ms")
        print(f"  {label}: in turns, parent {p[0]:.4f}, this {t[0]:.4f}, "
              f"this {t[1]:.4f}, parent {p[1]:.4f} ms "
              f"({sum(p) / sum(t):.2f}x){dev}", flush=True)
    for m in msgs:
        print(f"  {label}: {m}", flush=True)
    del out, ref
    torch.cuda.empty_cache()
    return dict(name=name, case=case, ok=ok, max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops, shapes=shapes,
                messages=msgs, **extra)


# the kernels whose in-turn lines against --parent also carry each turn's
# device ms (torch.profiler): the two whose near tier and bf16 bodies
# changed last
DEVICE_TURNS = ("gravity_fused", "p2p")


# the least difference of g (of max|g|) a bf16 case must show against its
# f32 twin: a bf16 instance that computed in f32 would otherwise pass
BF16_MIN_DIFF = 1e-4


def bf16_twin(name, a, kw, out):
    """A bf16 call's outputs `out` beside its f32 twin's on the same
    inputs: the largest difference of g (of the twin's max|g|) and of phi
    (relative), and both instances timed in turns (f32, bf16, bf16, f32),
    as wrapper ms (CUDA events) and device ms (torch.profiler)."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    wrapper = getattr(gk2, name)
    f32_kw = dict(kw, bf16=False)
    twin = wrapper(*a, **f32_kw)
    torch.cuda.synchronize()
    gscale = max(float(t.abs().max()) for t in twin[1:4])
    dg = max(float((o.double() - t.double()).abs().max())
             for o, t in zip(out[1:4], twin[1:4])) / max(gscale, 1e-30)
    dphi = float(((out[0].double() - twin[0].double()).abs()
                  / twin[0].double().abs().clamp(min=1e-30)).max())
    del twin
    turns = {"f32": [], "bf16": []}
    dev = {"f32": [], "bf16": []}
    for who in ("f32", "bf16", "bf16", "f32"):
        k2 = kw if who == "bf16" else f32_kw
        turns[who].append(cuda_ms(lambda: wrapper(*a, **k2), KERNEL_REPS))
        dev[who].append(device_ms(lambda: wrapper(*a, **k2)))
    return dict(bf16_vs_f32=dg, bf16_vs_f32_phi=dphi,
                f32_ms_in_turns=turns["f32"],
                bf16_ms_in_turns=turns["bf16"], f32_device_ms=dev["f32"],
                bf16_device_ms=dev["bf16"])


def visits_line(name, extra):
    """The per-case line of a redesigned kernel: what it visits (its
    window_shares), its instance's registers, shared memory and spills,
    and whether two launches gave the same bits."""
    sh, px = extra["shares"], extra["ptxas"] or {}
    if name == "gravity_fused":
        blk = (f", blk live {sh['blk_live_share']:.4f} of "
               f"{sh['blk_slots_below_nv']}" if "blk_live" in sh else "")
        near = (f", near tier live {sh['near_live_share']:.4f} of "
                f"{sh['near_slots_below_nv']}" if "near_live" in sh else "")
        what = (f"far accepted and live {sh['far_live_share']:.4f} of "
                f"{sh['far_entries']} (group, entry) slots, ring live "
                f"{sh['ring_live_share']:.4f} of {sh['ring_slots_below_nv']}"
                f" slots below nv{blk}{near}")
    elif name == "filter_sph":
        what = (f"kept {sh['kept_share']:.4f} of {sh['live_slots']} live "
                f"slots, pre-rejected whole {sh['prereject_share']:.4f}; a "
                f"live slot tests the targets of {sh['boxes_tested']:.3f} "
                f"boxes, {sh['tests_per_live']:.3f} exact tests (the bound "
                f"charges {sh['charged_per_live']:.3f})")
    elif name == "p2p":
        what = (f"live {sh['live_share']:.4f} of {sh['slots_below_nv']} "
                f"slots below nv, every one of {sh['live_pairs']} live pairs "
                "evaluated")
    else:
        p2p = (f", P2P window live {sh['p2p_live_share']:.4f}"
               if "p2p_live_share" in sh else "")
        support = "either support" if name == "pass1_sym" else "the support"
        skip = (f", skipped {sh['skipped_share']:.4f}"
                if "skipped_share" in sh else "")
        what = (f"live {sh['live_share']:.4f} of {sh['slots_below_nv']} "
                f"slots below nv{p2p}, inside {support} "
                f"{sh['inside_share']:.4f} of {sh['live_pairs']} live "
                f"pairs{skip}")
    return (f"{what}; {px.get('regs')} registers, {px.get('smem')} B "
            f"shared, spills {px.get('spill_stores')}/"
            f"{px.get('spill_loads')} B; two launches "
            f"{'bit-identical' if extra['same_bits'] else 'DIFFER'}")


def stream_checks(seen):
    """Launches on a stream that is not the default one: probe_launch and
    the production pass1_gradh inside ``torch.cuda.stream(side)`` and
    inside a CUDA graph capture. On the side stream the input is written
    after a long device sleep queued on that same stream, and the kernel
    must see the new value: a launch on a stale stream handle would run
    before the write. In the graph the input is written after the
    capture, and the replay must see it. Each result is held against the
    plain version on the new input (probe_launch exactly, pass1_gradh to
    its tolerances). Returns ({check: ok}, failures)."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    gen = torch.Generator().manual_seed(3)
    x_new = torch.rand(LAUNCH_SHAPE, generator=gen).cuda()
    nv, tgt, src = seen["pass1_gradh"][0]
    b = seen["pass1_gradh"][1]["b"]
    m_new = src[3] * 2.0
    cases = {
        "probe_launch": (lambda x: probes.probe_launch(x),
                         torch.zeros_like(x_new), x_new,
                         lambda out: bool(torch.equal(
                             out, probes.probe_launch_plain(x_new)))),
        "pass1_gradh": (lambda m: gk2.pass1_gradh(
            nv, tgt, [*src[:3], m], b=b), src[3].clone(), m_new,
            lambda out: compare("pass1_gradh", out, plain_sliced(
                "pass1_gradh", (nv, tgt, [*src[:3], m_new]),
                {"b": b}))[0]),
    }
    res, failures = {}, []
    for name, (call, buf, new, check) in cases.items():
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            torch.cuda._sleep(SIDE_SLEEP_CYCLES)
            buf.copy_(new)
            out = call(buf)
        cur.wait_stream(side)
        torch.cuda.synchronize()
        res[f"{name} on a side stream"] = check(out)
        buf = torch.zeros_like(new)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call(buf)
        buf.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        res[f"{name} in a CUDA graph"] = check(out)
        del graph, out
    for k, ok in res.items():
        print(f"stream check, {k}: {'ok' if ok else 'MISMATCH'}",
              flush=True)
        if not ok:
            failures.append(f"stream check: {k} disagrees with the plain "
                            "version")
    return res, failures


# the production path's case of the kernels that have several
MAIN_CASE = {"pass2": "grad_h+merged", "gravity_fused": "far_only"}

# the bf16 twins (grav_pair_dtype="bfloat16"): each f32 case named here is
# held again on the same inputs with bf16=True, as "<case>+bf16", for the
# legs that launch that bf16 instance at those shapes (none: an extra)
BF16_TWINS = {
    ("gravity_fused", "far_only"): ("prod100k_bf16",),
    ("p2p", "min_h"): ("sym100k_bf16",),
    ("gravity_fused", "far_only@sym100k"): ("sym100k_bf16",),
    ("gravity_fused", "near+min_h"): ("sym100k_bf16_every_tier",),
    ("p2p", "receiver_h"): (),
    ("p2p", "min_h@b33@sym100k"): (),
    ("gravity_fused", "near+min_h+blk"): (),
    ("gravity_fused", "near+receiver_h@parity3k"): (),
}


def bf16_case(name, case, a, kw):
    """The bf16 twin of one case, as check_modes takes it."""
    return (name, case + "+bf16", BF16_TWINS[(name, case)], a,
            dict(kw, bf16=True))


def with_bf16_twins(cases):
    """The cases, each named in BF16_TWINS followed by its bf16 twin."""
    for name, case, legs, a, kw in cases:
        yield name, case, legs, a, kw
        if (name, case) in BF16_TWINS:
            yield bf16_case(name, case, a, kw)


def check_kernels(seen, ptxas=None, parent_libs=None, only=None):
    """Phase 4 on the production path's inputs: each kernel (of `only`,
    where given) against its plain version, timed. Returns ({name:
    report}, failures)."""
    reports, failures = {}, []
    for name in ("filter_sph", "pass1_gradh", "pass2", "gravity_fused"):
        if only is not None and name not in only:
            continue
        if name not in seen:
            failures.append(f"{name}: not called while recording inputs")
            continue
        a, kw = seen[name]
        reports[name] = check_one(name, MAIN_CASE.get(name, ""), a, kw,
                                  ptxas, parent_libs,
                                  host=name in COMPACTED)
        if not reports[name]["ok"]:
            failures.append(f"{name}: disagrees with its plain version")
    return reports, failures


def check_modes(cases, ptxas=None, parent_libs=None, only=None):
    """Phase 4 for every other mode of the windowed kernels (of `only`,
    where given). Returns ([report], failures)."""
    reports, failures = [], []
    t_next = time.perf_counter()
    for name, case, legs, a, kw in cases:
        if only is not None and name not in only:
            t_next = time.perf_counter()
            continue
        t0 = time.perf_counter()
        rep = check_one(name, case, a, kw, ptxas, parent_libs)
        rep["legs"] = list(legs)
        # the wall of making the case's inputs and of its checks
        rep["wall_s"] = dict(inputs=t0 - t_next,
                             checks=time.perf_counter() - t0)
        if sum(rep["wall_s"].values()) >= 5:
            print(f"  {name} [{case}]: inputs {rep['wall_s']['inputs']:.1f}"
                  f" s, checks {rep['wall_s']['checks']:.1f} s", flush=True)
        reports.append(rep)
        if not rep["ok"]:
            failures.append(f"{name} [{case}]: disagrees with its plain "
                            "version")
        del a, kw
        t_next = time.perf_counter()
    want = {("filter_sph", "sym100k"), ("filter_sph", "settle100k"),
            ("pass1_gradh", "settle100k"),
            ("pass1_sym", "symmetric"), ("p2p", "min_h"),
            ("p2p", "receiver_h"), ("pass2", "symmetric"),
            ("pass2", "asymmetric+sign_bug"),
            ("pass2", "symmetric+fused+receiver_h"),
            ("pass2", "grad_h+av+merged"),
            ("pass2", "grad_h+av+balsara+merged"),
            ("pass2", "grad_h+av+balsara+energy+merged"),
            ("gravity_fused", "far_only@sym100k"),
            ("gravity_fused", "far_only@settle100k"),
            ("gravity_fused", "near+min_h"),
            ("gravity_fused", "near+receiver_h"),
            ("gravity_fused", "near+receiver_h@parity3k"),
            ("filter_sph", "adia100k"), ("pass1_gradh", "adia100k"),
            ("pass2", "grad_h+av+energy+merged"),
            ("pass2", "grad_h+energy+merged"),
            ("gravity_fused", "far_only@adia100k"),
            ("p2p", "min_h@sg100k"), ("gravity_fused", "far_only+blk"),
            ("gravity_fused", "near+min_h+blk"),
            ("pass1_sym", "symmetric@basalt100k"),
            ("pass2", "symmetric+av+energy@basalt100k"),
            ("gravity_fused", "near+min_h+monopole@basalt100k"),
            ("filter_sph", "exact_h_solve"), ("pass1_gradh", "exact_h_solve"),
            ("filter_sph", "exact100k"), ("pass1_gradh", "exact100k"),
            ("pass2", "grad_h@exact100k")} | GROUP_SIZE_CASES | {
                (name, case + "+bf16") for name, case in BF16_TWINS}
    want = {w for w in want if only is None or w[0] in only}
    missing = want - {(r["name"], r["case"]) for r in reports}
    if missing:
        failures.append(f"kernel cases not checked: {sorted(missing)}")
    return reports, failures


# steps of the dense scene from its cold ball to past its first collapse
# (free-fall time some 39, dt 0.02: the benchmark's 2,500-step cycle)
COLLAPSE_STEPS = 2100


def pairwise_cases(n):
    """The all-pairs kernels' inputs at n particles: (name, case, cfg, args,
    kw, on_main_path) from primed ``ics.jupiter`` states (the cold ball).
    The viscosity case takes ``ics.rotating_planet`` with a homologous
    contraction added (v -= 0.02 x), so every pair approaches and the curl
    is not zero, and the Balsara factors its own priming pass leaves in
    the state. From the plan's size on (``pairwise.PLAN_MIN_N``), also the
    ball past its first collapse (COLLAPSE_STEPS of the dense step): its
    centre dense, its boxes smaller."""
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    cfg = config_mod.jupiter_3k(n=n)
    st = planet.prime(ics.jupiter(cfg), cfg)
    base = (st.pos, st.h, st.mass)
    cases = [("pairwise_pass1", "symmetric_max", cfg, base, {}, True),
             ("pairwise_pass1", "receiver_h",
              cfg.replace(softening_mode="receiver_h"), base, {}, False),
             ("pairwise_pass1", "no_gravity",
              cfg.replace(gravity_solver="none"), base, {}, False)]
    p2 = (*base, st.rho, st.pressure)
    cases += [("pairwise_pass2", "symmetric", cfg, p2, {}, True),
              ("pairwise_pass2", "asymmetric+sign_bug",
               cfg.replace(grad_p_mode="reference_asymmetric",
                           kernel_deriv_sign_bug=True), p2, {}, False)]
    acfg = cfg.replace(av_alpha=1.0, av_beta=2.0, av_balsara=True)
    rot = ics.rotating_planet(acfg, omega=0.05)
    rot = planet.prime(rot.replace(vel=rot.vel - 0.02 * rot.pos), acfg)
    cases.append(("pairwise_pass2", "symmetric+av+balsara", acfg,
                  (rot.pos, rot.h, rot.mass, rot.rho, rot.pressure),
                  dict(vel=rot.vel, fbal=rot.balsara), False))
    if n == config_mod.parity().n:
        pcfg, pst = parity_start()
        # what `parity3k`'s first step gives the two kernels: pass 1 with
        # no gravity (the tree takes it), pass 2 asymmetric with the sign
        # bug (no viscosity: the velocities are not read)
        cases += [("pairwise_pass1", "parity3k", pcfg,
                   (pst.pos, pst.h, pst.mass), {}, False),
                  ("pairwise_pass2", "parity3k", pcfg,
                   (pst.pos, pst.h, pst.mass, pst.rho, pst.pressure), {},
                   False)]
    if n >= pw.PLAN_MIN_N:
        late = planet.run(st, cfg, COLLAPSE_STEPS)
        cases += [("pairwise_pass1", "symmetric_max@collapse", cfg,
                   (late.pos, late.h, late.mass), {}, False),
                  ("pairwise_pass2", "symmetric@collapse", cfg,
                   (late.pos, late.h, late.mass, late.rho, late.pressure),
                   {}, False)]
    return cases


def pairwise_plantings(name, args, kw, cfg):
    """The non-finite values phase 4 plants in one all-pairs call, one
    planting a launch: [(label, args, keywords, must_reach)], each in one
    field of one particle: the last one (its block of targets is the last,
    partial one) and one a third of the way in. Each lies outside the
    supports of most targets; its own block meets it in a diagonal tile,
    every other block in a tile without the self test. The fields: a NaN
    x, a +inf x (an infinite r2, which the q^2 test would skip but for
    the tile's flag), a NaN h (the wrapper's guard makes it 1), a NaN m,
    and for pass 2 a NaN pressure and (with viscosity) velocity.
    `must_reach`: the plain version's outputs hold a NaN for it whatever
    the inputs (a non-finite x meets pass 1 only inside a spline of a NaN
    or infinite q, which is 0, unless direct gravity reads it; a NaN
    velocity meets the viscosity of no pair that approaches, but the
    Balsara sums of every pair)."""
    n = args[0].shape[0]
    grav = name == "pairwise_pass1" and cfg.gravity_solver == "direct"
    out = []
    for j in (n - 1, n // 3):
        out += [(f"x@{j}", tuple(_with_nan(args, 0, (j, 0))), kw,
                 grav or name == "pairwise_pass2"),
                (f"x+inf@{j}", tuple(_with_nan(args, 0, (j, 0),
                                               float("inf"))), kw,
                 grav or name == "pairwise_pass2"),
                (f"h@{j}", tuple(_with_nan(args, 1, j)), kw, False),
                (f"m@{j}", tuple(_with_nan(args, 2, j)), kw, True)]
        if name == "pairwise_pass2":
            out.append((f"P@{j}", tuple(_with_nan(args, 4, j)), kw, True))
            if kw.get("vel") is not None:
                vel = _with_nan([kw["vel"]], 0, (j, 0))[0]
                out.append((f"velocity@{j}", args, dict(kw, vel=vel),
                            kw.get("fbal") is not None and cfg.av_balsara))
    return out


def pairwise_nan_agreement(name, kernel, plain, args, kw, cfg):
    """NaNs planted one field at a time (pairwise_plantings): the kernel's
    outputs must be NaN and infinite exactly where the plain version's
    are, counts equal, and the finite values within the tolerances.
    Returns (message or None, {label: reached})."""
    import torch
    reached = {}
    as_tuple = lambda o: tuple(o) if isinstance(o, tuple) else (o,)
    for label, pa, pkw, must in pairwise_plantings(name, args, kw, cfg):
        out = as_tuple(kernel(*pa, cfg, **pkw))
        ref = as_tuple(plain(*pa, cfg, **pkw))
        msg = non_finite_agree(out, ref)
        if msg:
            return f"{label}: {msg}", reached
        reached[label] = any(bool(torch.isnan(r).any()) for r in ref
                             if r.is_floating_point())
        if must and not reached[label]:
            return (f"{label}: the planted NaN reached no output of the "
                    "plain version"), reached
        msg = finite_parts_agree(name, out, ref)
        if msg:
            return f"{label}: {msg}", reached
    return None, reached


def pairwise_instance(name, cfg, kw, planned=False):
    """The template arguments of the all-pairs instance a call launches
    (pass 1: direct gravity, receiver softening with it; pass 2:
    viscosity, Balsara with it; both: a plan)."""
    if name == "pairwise_pass1":
        grav = cfg.gravity_solver == "direct"
        return (name, (int(grav),
                       int(grav and cfg.softening_mode == "receiver_h"),
                       int(planned)))
    av = cfg.av_alpha > 0.0 and kw.get("vel") is not None
    return (name, (int(av), int(av and cfg.av_balsara), int(planned)))


def parent_signatures(parent):
    """The other checkout's C signatures (``SIGNATURES`` of its
    ops/cuda/build.py), read from its source."""
    import ast
    path = os.path.join(parent, "planetmodel_sph_tpu_torch", "ops", "cuda",
                        "build.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    keep = [node for node in tree.body if isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "SIGNATURES"
                    for t in node.targets)]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns["SIGNATURES"]


def parent_pairwise(parent):
    """The other checkout's ``ops/cuda/pairwise.py``, loaded from its
    source as a module of this package: its relative imports (the EOS,
    ``dense.Pass1Out``, the launch path) resolve here, and its wrappers
    launch with its own C interface and source splits. Its kernels are
    timed through it inside ``build.library(name, its library, its
    signature)``."""
    import importlib.util
    path = os.path.join(parent, "planetmodel_sph_tpu_torch", "ops", "cuda",
                        "pairwise.py")
    spec = importlib.util.spec_from_file_location(
        "planetmodel_sph_tpu_torch.ops.cuda.parent_pairwise", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pw_turns(fns, reps=KERNEL_REPS):
    """Each of `fns` ({who: (fn, context)}) timed in the turns given by
    the order of `fns`' keys there and back (a, b, ..., b, a): wrapper ms
    (cuda_ms) and device ms (device_ms) of each turn, {who: [(ms,
    device_ms), ...]}."""
    order = list(fns) + list(fns)[::-1]
    out = {who: [] for who in fns}
    for who in order:
        fn, ctx = fns[who]
        with ctx():
            out[who].append((cuda_ms(fn, reps), device_ms(fn)))
    return out


def _parent_ctx(parent, *names):
    """A context in which the named kernels launch the other checkout's
    libraries (`parent`: dict(libs, sigs, module))."""
    from planetmodel_sph_tpu_torch.ops.cuda import build

    @contextlib.contextmanager
    def ctx():
        with contextlib.ExitStack() as stack:
            for name in names:
                stack.enter_context(build.library(
                    name, parent["libs"][name], parent["sigs"][name]))
            yield
    return ctx


def check_pairwise(n, parent=None, ptxas=None):
    """Phase 4 for the all-pairs kernels at n particles, with planted
    non-finite values and a second launch held to the same bits. From
    ``pairwise.PLAN_MIN_N`` on each case runs as the main path does, with
    a plan built from its positions (the non-finite values are planted
    after it was built, so their sub-tile is far from most warps), and
    prints the plan's near share and its boxes' far share for the
    planted particles. With `parent`
    (dict(libs, sigs, module): another checkout's build, C signatures and
    wrapper module, :func:`parent_pairwise`) each case is also timed in
    turns with that checkout's wrapper and kernel (parent, this, this,
    parent: wrapper and device ms). `ptxas`: the build's instances by
    (kernel, template arguments). Returns ({name: report of the main
    path's case, "cases": [...]}, failures)."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    wrappers = {"pairwise_pass1": (pw.pass1, pw.pass1_plain),
                "pairwise_pass2": (pw.pass2, pw.pass2_plain)}
    reports, failures = {"cases": []}, []
    shares, plans = {}, {}
    as_tuple = lambda o: tuple(o) if isinstance(o, tuple) else (o,)
    for name, case, cfg, args, kw, on_main in pairwise_cases(n):
        key = (args[0].data_ptr(), args[1].data_ptr())
        if key not in plans:
            plan = pw.plan_for(args[0])
            plans[key] = (plan, plan_cells(args[0], args[1], plan.perm)
                          if plan is not None else None)
        plan, cells = plans[key]
        kernel = functools.partial(wrappers[name][0], plan=plan)
        plain = wrappers[name][1]
        out = kernel(*args, cfg, **kw)
        torch.cuda.synchronize()
        ref = plain(*args, cfg, **kw)
        torch.cuda.synchronize()
        ok, err, msgs = compare(name, as_tuple(out), as_tuple(ref))
        again = kernel(*args, cfg, **kw)
        torch.cuda.synchronize()
        same = same_bits(as_tuple(out), as_tuple(again))
        if not same:
            ok = False
            msgs.append("two launches on the same inputs differ")
        del again
        nan_msg, reached = pairwise_nan_agreement(name, kernel, plain, args,
                                                  kw, cfg)
        if nan_msg:
            ok = False
            msgs.append(f"planted NaNs: {nan_msg}")
        near = None
        if plan is not None:
            plan.counts.zero_()
            kernel(*args, cfg, **kw)
            near = pw.near_share(plan)
        ms = cuda_ms(lambda: kernel(*args, cfg, **kw), KERNEL_REPS)
        dev_ms = device_ms(lambda: kernel(*args, cfg, **kw))
        turns = None
        if parent:
            pkernel = getattr(parent["module"], wrappers[name][0].__name__)
            turns = _pw_turns({
                "parent": (lambda: pkernel(*args, cfg, **kw),
                           _parent_ctx(parent, name)),
                "this": (lambda: kernel(*args, cfg, **kw),
                         contextlib.nullcontext)})
        plain_ms = cuda_ms(lambda: plain(*args, cfg, **kw), PLAIN_REPS)
        b_ms, b_by, nbytes, ops = pairwise_bound(name, args, kw, cfg,
                                                 as_tuple(out), cells)
        if key not in shares:
            shares[key] = pairwise_shares(args[0], args[1])
        sh = shares[key]
        far = None
        if cells is not None:
            # the planted particles' boxes: far from this share of boxes
            cell, far_cells = cells
            far = {j: float(far_cells[cell[j]].double().mean())
                   for j in (n - 1, n // 3)}
        px = (ptxas or {}).get(pairwise_instance(name, cfg, kw,
                                                 plan is not None)) or {}
        rep = dict(name=name, case=case, n=n, ok=ok, max_abs_err=err, ms=ms,
                   device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes, ops=ops,
                   splits=pw.splits_for(n),
                   planned=plan is not None, near_share=near,
                   planted_far_share=far, same_bits=same, shares=sh,
                   ptxas=px or None, nan_agrees=nan_msg is None,
                   nan_reached=reached, messages=msgs)
        if turns:
            rep["parent_turns"], rep["turns"] = turns["parent"], \
                turns["this"]
        reports["cases"].append(rep)
        if on_main:
            reports[name] = rep
        label = f"{name} [{case}, n={n}]"
        print(f"kernel {label}: "
              f"{'ok' if ok else 'MISMATCH'} max_abs_err={err:.3e} "
              f"ms={ms:.4f} device_ms={fmt_ms(dev_ms)} "
              f"plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        print(f"  {label}: inside either support {sh['inside_share']:.5f} "
              f"of {sh['pairs']} pairs, skipped by the q^2 test "
              f"{sh['skipped_share']:.5f}; {px.get('regs')} registers, "
              f"{px.get('smem')} B shared, spills {px.get('spill_stores')}/"
              f"{px.get('spill_loads')} B; two launches "
              f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        if plan is not None:
            print(f"  {label}: planned, near share {near:.5f} of the "
                  f"(warp, sub-tile) pairs; the planted particles' boxes "
                  f"far from " + ", ".join(
                      f"{v:.4f} (particle {j})" for j, v in far.items())
                  + " of the boxes", flush=True)
        got = ", ".join(f"{k} {'reached' if v else 'masked'}"
                        for k, v in reached.items())
        print(f"  {label}: planted NaNs "
              f"{'agree' if nan_msg is None else 'DIFFER'} ({got})",
              flush=True)
        if turns:
            p, t = turns["parent"], turns["this"]
            print(f"  {label}: in turns, parent {p[0][0]:.4f}, this "
                  f"{t[0][0]:.4f}, this {t[1][0]:.4f}, parent {p[1][0]:.4f}"
                  f" ms ({sum(a for a, _ in p) / sum(a for a, _ in t):.2f}x);"
                  " device " + ", ".join(fmt_ms(d) for d in (
                      p[0][1], t[0][1], t[1][1], p[1][1])) + " ms",
                  flush=True)
        for m in msgs:
            print(f"  {name} [{case}]: {m}", flush=True)
        if not ok:
            failures.append(f"{name} [{case}, n={n}]: disagrees with its "
                            "plain version")
        del out, ref
        torch.cuda.empty_cache()
    return reports, failures


# the sizes at which the plan's cost and gain are timed (PLAN_MIN_N)
PLAN_SIZES = (3000, 8192, 16384, 32768)


def plan_times(n, parent=None):
    """A force evaluation's two sweeps at n particles of the primed cold
    ball: with a plan (its build included), without, and with `parent`'s
    wrappers and kernels, in turns (parent, planned, unplanned, unplanned,
    planned, parent): wrapper and device ms of each, and the plan's own.
    What ``pairwise.PLAN_MIN_N`` was chosen from."""
    import torch
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    cfg = config_mod.jupiter_3k(n=n)
    st = planet.prime(ics.jupiter(cfg), cfg)
    a1 = (st.pos, st.h, st.mass)
    a2 = (*a1, st.rho, st.pressure)

    def sweeps(mod, planned):
        def fn():
            plan = mod.plan(st.pos) if planned else None
            kw = {"plan": plan} if planned else {}
            mod.pass1(*a1, cfg, **kw)
            mod.pass2(*a2, cfg, **kw)
        return fn
    fns = {}
    if parent:
        fns["parent"] = (sweeps(parent["module"], False),
                         _parent_ctx(parent, *ALL_PAIRS))
    fns["planned"] = (sweeps(pw, True), contextlib.nullcontext)
    fns["unplanned"] = (sweeps(pw, False), contextlib.nullcontext)
    turns = _pw_turns(fns)
    plan_ms = cuda_ms(lambda: pw.plan(st.pos), KERNEL_REPS)
    plan_dev = device_ms(lambda: pw.plan(st.pos))
    plan = pw.plan(st.pos)
    pw.pass1(*a1, cfg, plan=plan)
    share = pw.near_share(plan)
    rep = dict(n=n, turns=turns, plan_ms=plan_ms, plan_device_ms=plan_dev,
               near_share=share, planned_by_default=pw.plan_for(st.pos)
               is not None)
    line = "; ".join(f"{who} " + ", ".join(
        f"{ms:.4f} ({fmt_ms(d)})" for ms, d in v) for who, v in
        turns.items())
    print(f"plan n={n}: pass 1 + pass 2 wrapper ms (device ms) in turns: "
          f"{line}; the plan alone {plan_ms:.4f} ({fmt_ms(plan_dev)}); near "
          f"share {share:.5f}; planned by default "
          f"{rep['planned_by_default']}", flush=True)
    del st
    torch.cuda.empty_cache()
    return rep


# ---------------------------------------------------------------------------
# the tools' probes
# ---------------------------------------------------------------------------

def probe_cases():
    """(name, case, args, kw) of each probe at the reference tools' shapes,
    inputs drawn from seeded generators and moved to the card. The FMA
    chain's v lies in (0.5, 1.0000001], so acc stays finite for every
    element (the reference's own input is 1.0000001 everywhere)."""
    import torch
    from planetmodel_sph_tpu_torch.tools import microbench
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(FMA_SHAPE, generator=gen)
    x = (1.0000001 * (1.0 - 0.5 * u)).cuda()
    yield "probe_fma", f"reps={FMA_REPS}", (x,), {"reps": FMA_REPS}
    yield "probe_launch", "", (torch.rand(LAUNCH_SHAPE,
                                          generator=gen).cuda(),), {}
    packed = torch.randn((GATHER_NB, GATHER_C * 64), generator=gen).cuda()
    idx = torch.randint(0, GATHER_NB, (GATHER_NB, GATHER_W), generator=gen,
                        dtype=torch.int32).cuda()
    yield "probe_gather", "", (packed, idx), {}
    for sg in TILE_SUPERS:
        nv, tgt, rows = microbench.tile_inputs(sg=sg, device="cuda")
        yield ("probe_pass1_tile", f"SG={sg}", (nv, tgt, rows),
               {"tb": 64 * sg, "chunk": 512})


def chain_ms(fn, x, k):
    """Host ms per call of k chained calls x = fn(x) after one warm-up,
    from a synchronize to a synchronize: the fixed cost of a launch."""
    import torch
    from planetmodel_sph_tpu_torch.tools import roofline
    return roofline.chained(fn, x, k, torch.device("cuda")) * 1e3


def tile_plantings(a, kw):
    """probe_pass1_tile's plantings, one a launch: [(label, args,
    must_reach)], a NaN, an +inf and a finite 1e13 in turn in instance 0:
    at the x of its last dead slot below nv, of a slot in [nv, span) and of
    one past the span, at target 1's ih, at the x of its first target with
    ih < 0, and at the m of its last live and last dead slot below nv.
    `must_reach`: the reference's sweep is not finite at some target for
    this planting whatever the other inputs (a NaN ih; an infinite ih, c =
    inf, or live m, 0 * inf; a NaN live m), or finite everywhere (a slot
    past the span, a dead m); None where it depends on the inputs (a NaN
    position gives q = NaN and W = 0, an infinite one W = inf only where q
    = -inf)."""
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    nv, tgt, rows = a
    tb, s = kw["tb"], rows[0].shape[1]
    nvg = int(nv[0])
    span = int(probes.tile_span(nv[:1], s, kw["chunk"])[0])
    live = (rows[4][0, :nvg] > 0.5).nonzero()[:, 0]
    dead = (rows[4][0, :nvg] <= 0.5).nonzero()[:, 0]
    neg = int((tgt[3][:tb, 0] < 0).nonzero()[0, 0])
    places = [("dead x", "rows", 0, (0, int(dead[-1])), None),
              ("span x", "rows", 0, (0, min(nvg, span - 1)), None),
              ("past x", "rows", 0, (0, min(span, s - 1)), False),
              ("target ih", "tgt", 3, (1, 0), True),
              ("target x", "tgt", 0, (neg, 0), None),
              ("live m", "rows", 3, (0, int(live[-1])), True),
              ("dead m", "rows", 3, (0, int(dead[-1])), False)]
    out = []
    for label, which, k, at, reach in places:
        for value in (float("nan"), float("inf"), 1e13):
            t, r = ((_with_nan(tgt, k, at, value), rows) if which == "tgt"
                    else (tgt, _with_nan(rows, k, at, value)))
            # a large finite ih or m may leave every target finite
            out.append((f"{label}={value:g}", (nv, t, r),
                        None if value == 1e13 and reach else reach))
    return out


def tile_nan_agreement(a, kw):
    """probe_pass1_tile on each of tile_plantings: NaN and infinite at the
    same targets as the plain version, the rest within TILE_TOL of each
    target's sum of |m W|. Returns (message or None, {label: reached})."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    reached = {}
    for label, pa, must in tile_plantings(a, kw):
        out = probes.probe_pass1_tile(*pa, **kw)
        ref, mag = probes.probe_pass1_tile_plain(*pa, chunk=kw["chunk"])
        msg = non_finite_agree((out,), (ref,))
        if msg:
            return f"{label}: {msg}", reached
        reached[label] = not bool(torch.isfinite(ref).all())
        if must is not None and reached[label] != must:
            return (f"{label}: the plain version is "
                    f"{'not ' if reached[label] else ''}finite"), reached
        fin = torch.isfinite(ref)
        err = (out.double() - ref.double()).abs()[fin]
        if bool((err > TILE_TOL * mag.double()[fin]).any()):
            return f"{label}: finite outputs outside TILE_TOL", reached
    return None, reached


def check_probe(name, case, a, kw, parent_libs=None):
    """One probe against its plain version (probe_gather and probe_launch
    exactly, probe_fma to FMA_RTOL, probe_pass1_tile to TILE_TOL of each
    target's sum of |m W|, and on its SG = 1 and 8 cases with non-finite
    and far-out values planted, tile_nan_agreement), timed: the report.
    `parent_libs`: {kernel: library} of another checkout's build, timed in
    turns with this one's."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    kernel = getattr(probes, name)
    plain = getattr(probes, name + "_plain")
    if name == "probe_pass1_tile":
        call_plain = lambda: plain(*a, chunk=kw["chunk"])  # noqa: E731
    else:
        call_plain = lambda: plain(*a, **kw)  # noqa: E731
    out = kernel(*a, **kw)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all())
    if name == "probe_pass1_tile":
        ref, mag = call_plain()
        err = (out.double() - ref.double()).abs()
        bad = int((err > TILE_TOL * mag.double()).sum())
    else:
        ref = call_plain()
        err = (out.double() - ref.double()).abs()
        lim = FMA_RTOL * ref.double().abs() if name == "probe_fma" else 0.0
        bad = int((err > lim).sum())
    ok = finite and bad == 0 and out.shape == ref.shape
    max_err = float(err.max())
    msgs = [] if ok else [f"{bad} entries outside tolerance, finite "
                          f"{finite}"]
    extra = {}
    if name == "probe_pass1_tile":
        again = kernel(*a, **kw)
        extra["same_bits"] = same_bits(out, again)
        if not extra["same_bits"]:
            ok = False
            msgs.append("two launches on the same inputs differ")
        if kw["tb"] // 64 in TILE_NAN_SUPERS:
            nan_msg, extra["nan_reached"] = tile_nan_agreement(a, kw)
            extra["nan_agrees"] = nan_msg is None
            if nan_msg:
                ok = False
                msgs.append(f"planted values: {nan_msg}")
    library_ms = library_dev = graph_ms = None
    if name == "probe_launch":
        # the fixed cost of one launch: chains of launches, each on the
        # previous output, as the reference's measure_launch; the wrapper
        # and torch.mul in turns, the median of CHAIN_TURNS chains each
        mul = lambda v: torch.mul(v, probes.LAUNCH_SCALE)  # noqa: E731
        chains = {kernel: [], mul: []}
        for _ in range(CHAIN_TURNS):
            for fn in chains:
                chains[fn].append(chain_ms(fn, a[0], LAUNCH_CHAIN))
        ms, library_ms = (sorted(c)[len(c) // 2] for c in chains.values())
        plain_ms = chain_ms(plain, a[0], LAUNCH_CHAIN)
        library_dev = device_ms(
            lambda: torch.mul(a[0], probes.LAUNCH_SCALE))
        from planetmodel_sph_tpu_torch.tools import roofline
        graph_ms = roofline.graph_launch(LAUNCH_CHAIN) * 1e3
    else:
        ms = cuda_ms(lambda: kernel(*a, **kw), KERNEL_REPS)
        plain_ms = cuda_ms(call_plain, PLAIN_REPS)
        if name == "probe_gather":
            rows = a[1].long()
            library_ms = cuda_ms(lambda: a[0][rows], KERNEL_REPS)
            library_dev = device_ms(lambda: a[0][rows])
    dev_ms = device_ms(lambda: kernel(*a, **kw))
    if parent_libs and name in parent_libs:
        # the parent's kernel and this one in turns: parent, this, this,
        # parent, on the same inputs through the same wrapper; then the
        # parent's device time
        from planetmodel_sph_tpu_torch.ops.cuda import build
        turns = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            with (build.library(name, parent_libs[name]) if who == "parent"
                  else contextlib.nullcontext()):
                turns[who].append(cuda_ms(lambda: kernel(*a, **kw),
                                          KERNEL_REPS))
        extra["parent_ms"], extra["ms_in_turns"] = turns["parent"], \
            turns["this"]
        with build.library(name, parent_libs[name]):
            extra["parent_device_ms"] = device_ms(lambda: kernel(*a, **kw))
    b_ms, b_by, nbytes, ops = bound(name, a, kw, out)
    shapes = {"inputs": [list(t.shape) for t in a
                         if isinstance(t, torch.Tensor)],
              "out": list(out.shape)}
    if name == "probe_pass1_tile":
        shapes = {"instances": a[2][0].shape[0], "tb": kw["tb"],
                  "rows": list(a[2][0].shape), "nv": int(a[0][0])}
    label = name + (f" [{case}]" if case else "")
    print(f"kernel {label}: {'ok' if ok else 'MISMATCH'} "
          f"max_abs_err={max_err:.3e} ms={ms:.4f} "
          f"device_ms={fmt_ms(dev_ms, 5)} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms} "
          f"library_device_ms={library_dev} bound_ms={b_ms:.5f} ({b_by}) "
          f"shapes={shapes}", flush=True)
    if graph_ms is not None:
        print(f"  {label}: a launch in a chain of {LAUNCH_CHAIN}: "
              f"{ms:.5f} ms a wrapper call (torch.mul {library_ms:.5f}), "
              f"{graph_ms:.5f} ms replayed from a CUDA graph", flush=True)
    if "same_bits" in extra:
        print(f"  {label}: two launches "
              f"{'bit-identical' if extra['same_bits'] else 'DIFFER'}",
              flush=True)
    if "nan_reached" in extra:
        got = ", ".join(f"{k} {'reached' if v else 'masked'}"
                        for k, v in extra["nan_reached"].items())
        print(f"  {label}: planted values "
              f"{'agree' if extra['nan_agrees'] else 'DIFFER'} ({got})",
              flush=True)
    if "parent_ms" in extra:
        p, t = extra["parent_ms"], extra["ms_in_turns"]
        print(f"  {label}: in turns, parent {p[0]:.4f}, this {t[0]:.4f}, "
              f"this {t[1]:.4f}, parent {p[1]:.4f} ms "
              f"({sum(p) / sum(t):.2f}x); parent device_ms "
              f"{fmt_ms(extra['parent_device_ms'], 5)}", flush=True)
    for m in msgs:
        print(f"  {label}: {m}", flush=True)
    del out, ref
    torch.cuda.empty_cache()
    return dict(name=name, case=case, ok=ok, max_abs_err=max_err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_dev, graph_ms=graph_ms,
                bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops, shapes=shapes,
                messages=msgs, **extra)


def check_probes(parent_libs=None):
    """Phase 4 for the tools' four probes. Returns ([report],
    failures)."""
    reports, failures = [], []
    for name, case, a, kw in probe_cases():
        rep = check_probe(name, case, a, kw, parent_libs)
        reports.append(rep)
        if not rep["ok"]:
            failures.append(f"{name} [{case}]: disagrees with its plain "
                            f"version: {rep['messages']}")
    return reports, failures


def tools_phase(state, cfg, main_wall, card):
    """Phase 5e: the port's roofline and microbench tools, the probes'
    main path: the launch counts reset just before and read just after.
    The card's ceilings beside the published peaks, the work one force
    evaluation issues at the settled state, the modeled floor against the
    main path's measured step, the gather variants and tile widths.
    Fails on a launch count or a rate that is not finite and positive,
    never on a rate's value. Returns (report, failures)."""
    import torch
    from planetmodel_sph_tpu_torch.ops import structure
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    from planetmodel_sph_tpu_torch.tools import microbench, roofline
    st = structure.build(state.pos, state.h, state.mass, cfg)
    work = roofline.count_work(cfg, st)
    del st
    torch.cuda.synchronize()
    launch.reset_launches()
    disp = roofline.measure_dispatch()
    hbm = roofline.measure_hbm(k=HBM_K, mb=HBM_MB)
    vpu = roofline.measure_vpu(k=VPU_K, reps=roofline.VPU_RATE_REPS)
    launch_cost = roofline.measure_launch(k=LAUNCH_CHAIN)
    lat = launch_cost["eager_s"]
    gathers = microbench.bench_gathers(k=TOOL_K)
    tiles = microbench.bench_kernel_tiles(k=TOOL_K, supers=TILE_SUPERS)
    torch.cuda.synchronize()
    launches = dict(launch.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    # probe_launch: the eager chain and its warm-up, then the graphed
    # chain's warm-up and the launches it captured (a replay calls no
    # wrapper and counts nothing)
    want.update(probe_fma=VPU_K + 1, probe_launch=2 * LAUNCH_CHAIN + 2,
                probe_gather=TOOL_K + 1,
                probe_pass1_tile=len(TILE_SUPERS) * (TOOL_K + 1))
    floor = roofline.modeled_floor(cfg, work, vpu, hbm, lat)
    step_s = main_wall / STEPS
    print(f"roofline on {card} (published peaks: {PEAK_F32 / 1e12:.0f} "
          f"TFLOP/s f32, {PEAK_BYTES / 1e12:.2f} TB/s):", flush=True)
    print(f"  dispatch {disp * 1e6:.3f} us; memory stream r+w "
          f"{hbm / 1e9:.1f} GB/s ({hbm / PEAK_BYTES * 100:.1f} % of peak); "
          f"f32 FMA {vpu / 1e12:.3f} TFLOP/s at reps="
          f"{roofline.VPU_RATE_REPS} ({vpu / PEAK_F32 * 100:.1f} % of "
          f"peak); launch {lat * 1e6:.3f} us a wrapper call, "
          f"{launch_cost['graph_s'] * 1e6:.3f} us in a CUDA graph",
          flush=True)
    print(f"  count_work {work}", flush=True)
    print(f"  modeled floor {floor['total'] * 1e3:.4f} ms/step (f32 "
          f"{floor['vpu'] * 1e3:.4f}, gathers {floor['hbm'] * 1e3:.4f}, "
          f"launches {floor['launch'] * 1e3:.4f}, h-solve "
          f"{floor['amort'] * 1e3:.4f}) against the main path's measured "
          f"{step_s * 1e3:.4f} ms/step ({floor['total'] / step_s * 100:.1f} "
          "%)", flush=True)
    print(f"  probe launches {({k: v for k, v in launches.items() if v})}",
          flush=True)
    rates = dict(dispatch_s=disp, hbm_Bps=hbm, vpu_ops=vpu, launch_s=lat,
                 launch_graph_s=launch_cost["graph_s"])
    failures = []
    for k, v in rates.items():
        if not (math.isfinite(v) and v > 0.0):
            failures.append(f"roofline: {k} = {v}")
    if launches != want:
        failures.append(f"tools: launch counts {launches} != {want}")
    rep = dict(card=card, **rates, vpu_reps=roofline.VPU_RATE_REPS,
               work=work, floor=floor, measured_step_s=step_s,
               gathers_s=gathers,
               tiles={str(k): dict(s=v[0], gpair_per_s=v[1])
                      for k, v in tiles.items()},
               launches=launches, expected=want)
    return rep, failures


def state_agreement(a, b, rtol=2e-5, atol=1e-6):
    """Field by field: floats within rtol/atol, integers equal. Returns
    (ok, {field: max abs difference})."""
    from planetmodel_sph_tpu_torch.state import FIELDS
    ok, errs = True, {}
    for k in FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        d = (x.double() - y.double()).abs()
        errs[k] = float(d.max())
        if x.is_floating_point():
            ok &= bool((d <= atol + rtol * y.double().abs()).all())
        else:
            ok &= bool((d == 0).all())
    return ok, errs


def agreement_ratios(a, b, rtol=2e-5, atol=1e-6):
    """Field by field, the largest |a - b| over state_agreement's limit
    for b (1 is the limit; integers: the largest |a - b|)."""
    from planetmodel_sph_tpu_torch.state import FIELDS
    out = {}
    for k in FIELDS:
        x, y = getattr(a, k).double(), getattr(b, k).double()
        d = (x - y).abs()
        if getattr(b, k).is_floating_point():
            d = d / (atol + rtol * y.abs())
        out[k] = float(d.max())
    return out


def _tree_run(tree, args, timeout=900, module=True):
    """`python -m <args>` (or `python <args>`) in `tree`'s checkout (its
    own package and state file), in a process of its own: stdout."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, *(["-m"] if module else []), *args],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(args)} in {tree} exited "
                           f"{r.returncode}: {r.stderr[-2000:]}")
    return r.stdout


# One turn of the two probes, run by `python -c` in a checkout of its own
# (it imports that checkout's package, which builds its own kernels): a
# probe_launch wrapper call and torch.mul in chains of LAUNCH_CHAIN, host
# microseconds a call; probe_gather and packed[idx] at the microbench
# tool's shape, the median of KERNEL_REPS CUDA-event timings in ms.
PROBE_TURN = """
import json, time, torch
from planetmodel_sph_tpu_torch.ops.cuda import probes
def chain_us(fn, x, k):
    y = fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
        y = fn(y)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / k * 1e6
def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return sorted(ts)[len(ts) // 2]
gen = torch.Generator().manual_seed(0)
x = torch.rand(%(shape)r, generator=gen).cuda()
packed = torch.randn((%(nb)d, %(c)d * 64), generator=gen).cuda()
idx = torch.randint(0, %(nb)d, (%(nb)d, %(w)d), generator=gen,
                    dtype=torch.int32).cuda()
rows = idx.long()
print(json.dumps({
    "launch_us": chain_us(probes.probe_launch, x, %(k)d),
    "mul_us": chain_us(lambda v: torch.mul(v, 1.000001), x, %(k)d),
    "gather_ms": event_ms(lambda: probes.probe_gather(packed, idx), %(r)d),
    "index_ms": event_ms(lambda: packed[rows], %(r)d)}))
""" % dict(shape=LAUNCH_SHAPE, nb=GATHER_NB, c=GATHER_C, w=GATHER_W,
           k=LAUNCH_CHAIN, r=KERNEL_REPS)


def probe_turns(trees):
    """The two probes from each checkout, each in a process of its own, in
    the order parent, this, this, parent: [{tree, launch_us, mul_us,
    gather_ms, index_ms}]."""
    rows = []
    for who in ("parent", "this", "this", "parent"):
        out = _tree_run(trees[who], ["-c", PROBE_TURN], module=False)
        row = dict(tree=who, **json.loads(out.strip().splitlines()[-1]))
        rows.append(row)
        print(f"  probes, {who}: probe_launch {row['launch_us']:.3f} us a "
              f"call (torch.mul {row['mul_us']:.3f}), probe_gather "
              f"{row['gather_ms']:.4f} ms (packed[idx] "
              f"{row['index_ms']:.4f})", flush=True)
    return rows


# `sym100k` as README.md runs it: the settled state under the unfused
# symmetric step (pass1_sym, pass2 symmetric, p2p, the far-only
# gravity_fused and filter_sph)
SYM_BENCH = ["--set", "grad_p_mode=symmetric", "--set", "h_mode=relax",
             "--set", "fuse_p2p_sph=false", "--set",
             "fuse_p2p_residual=false", "--set", "p2p_window=256", "--set",
             "m2p_window=256"]
# `sg100k`: `sym100k` with the supergroup far tier
SG_BENCH = SYM_BENCH + ["--set", "sg_blocks=4", "--set", "blk_window=768"]
# `dense32k`: the dense jupiter_3k step at n = 32768, the all-pairs kernels
DENSE_BENCH = ["--preset", "jupiter_3k", "--n", "32768", "--steps", "20"]


def bench_turns(trees, label, extra=()):
    """`bench --repeat 3 [extra]` from each checkout in its own process, in
    the order parent, this, this, parent, the first of each with --profile
    (busy time, idle share): ([row], {tree: median steps/s over every
    repeat of its two runs}; the profiled runs, which the trace slows, are
    left out of the medians)."""
    rows = []
    for k, who in enumerate(("parent", "this", "this", "parent")):
        out = _tree_run(trees[who], ["planetmodel_sph_tpu_torch.bench",
                                     "--repeat", "3", *extra]
                        + (["--profile"] if k < 2 else []))
        for ln in out.splitlines():
            if ln.startswith("{"):
                r = json.loads(ln)
                row = dict(tree=who, steps_per_s=r["steps_per_sec"],
                           overflow=r["overflow"],
                           profiled=bool(r.get("profiled")),
                           device_busy_s=r.get("device_busy_s"),
                           device_idle_share=r.get("device_idle_share"),
                           device_s_by_kernel=r.get("device_s_by_kernel"))
                rows.append(row)
                busy = (f" (profiled: busy {row['device_busy_s']:.5f} s, "
                        f"idle {row['device_idle_share']:.4f})"
                        if r.get("profiled") else "")
                print(f"  {label}, {who}: {r['steps_per_sec']} "
                      f"steps/s{busy}", flush=True)
    med = {}
    for who in trees:
        sps = sorted(r["steps_per_s"] for r in rows
                     if r["tree"] == who and not r["profiled"])
        med[who] = sps[len(sps) // 2] if sps else float("nan")
    print(f"  {label} medians: this {med['this']:.3f}, parent "
          f"{med['parent']:.3f} steps/s ({med['this'] / med['parent']:.3f}x)",
          flush=True)
    return rows, med


def parent_phase(parent, state, cfg):
    """Phase 7, with --parent DIR: the two probes (probe_turns), the
    production step, `sym100k`, `sg100k` and `dense32k` from DIR's
    checkout and from this one in turns, each whole (its kernels, its
    Python; bench_turns); then each
    checkout's sorted and unsorted chunks (the CLI's 64 steps of the
    settled state, restored from npz checkpoints that differ only in
    sorted_chunks) against each other, as phase 5f holds them. Returns
    (report, failures)."""
    from planetmodel_sph_tpu_torch.utils import checkpoint
    trees = {"parent": os.path.abspath(parent), "this": ROOT}
    rep, failures = {"unsorted": {}}, []
    rep["probes"] = probe_turns(trees)
    rep["steps"], rep["median_steps_per_s"] = bench_turns(
        trees, "production step")
    for leg, extra in (("sym100k", SYM_BENCH), ("sg100k", SG_BENCH),
                       ("dense32k", DENSE_BENCH)):
        rep[f"{leg}_steps"], rep[f"{leg}_median_steps_per_s"] = bench_turns(
            trees, leg, extra)
    work = os.path.join(OUT_DIR, "parent_phase")
    os.makedirs(work, exist_ok=True)
    starts = {}
    for sorted_ in (True, False):
        starts[sorted_] = os.path.join(work, f"start_sorted{int(sorted_)}"
                                       ".npz")
        checkpoint.save(starts[sorted_], state,
                        cfg.replace(sorted_chunks=sorted_), 0)
    for who, tree in trees.items():
        ends = {}
        for sorted_, start in starts.items():
            ends[sorted_] = os.path.join(work, f"end_{who}_sorted"
                                         f"{int(sorted_)}.npz")
            _tree_run(tree, ["planetmodel_sph_tpu_torch.cli", "run",
                             "--device", "cuda", "--restore", start,
                             "--steps", str(STEPS), "--diag-every",
                             str(STEPS), "--checkpoint", ends[sorted_]])
        a, _, _ = checkpoint.load(ends[False], device="cpu")
        b, _, _ = checkpoint.load(ends[True], device="cpu")
        ratios = agreement_ratios(a, b)
        rep["unsorted"][who] = ratios
        worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
        print(f"  unsorted against sorted, {who}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in worst) + " of the limit", flush=True)
    if max(rep["unsorted"]["this"].values()) > 1.0:
        failures.append("parent phase: this checkout's unsorted chunks "
                        "leave the sorted run's tolerance")
    return rep, failures


def slice5_legs(cfg, state, main_out, exact_state):
    """Phase 5f: `exact100k` (particle-exact SPH lists), `unsorted100k`
    (the production step with sorted_chunks=False, held against the main
    path's sorted run of the same start at the reference's tolerance) and
    `dense3k_k4` (the cached dense step). Returns ([report], failures)."""
    reports, failures = [], []
    ecfg = cfg.replace(**EXACT_KW)
    _, rep, fails = run_leg("exact100k", exact_state, ecfg, EXACT_STEPS,
                            expected_launches(ecfg, EXACT_STEPS),
                            "conserved")
    reports.append(rep)
    failures += fails
    ucfg = cfg.replace(sorted_chunks=False)
    uout, rep, fails = run_leg("unsorted100k", state, ucfg, UNSORTED_STEPS,
                               expected_launches(ucfg, UNSORTED_STEPS),
                               "conserved")
    ok, errs = state_agreement(uout, main_out)
    ratios = agreement_ratios(uout, main_out)
    rep.update(agrees_with_sorted=ok, max_abs_diff_to_sorted=errs,
               ratio_to_limit=ratios)
    worst = max(ratios, key=ratios.get)
    print(f"  unsorted100k against the sorted main path (rtol 2e-5, atol "
          f"1e-6, counts equal): {'ok' if ok else 'MISMATCH'}; max |diff| "
          f"pos {errs['pos']:.3e} vel {errs['vel']:.3e} rho "
          f"{errs['rho']:.3e} n_neighbors {errs['n_neighbors']:.0f}; "
          f"worst {worst} at {ratios[worst]:.4f} of the limit", flush=True)
    if not ok:
        failures.append(f"unsorted100k: state differs from the sorted run: "
                        f"{errs}")
    reports.append(rep)
    failures += fails
    del uout
    n, steps, k = DENSE_K4
    rep, fails = dense_main(n, steps, label="dense3k_k4", rebuild_every=k)
    reports.append(rep)
    failures += fails
    return reports, failures


# ---------------------------------------------------------------------------
# main path and the small-input agreement
# ---------------------------------------------------------------------------

def expected_launches(cfg, steps):
    """Launches per kernel of `steps` cached steps on grid neighbours
    (`steps` a multiple of rebuild_every). Per chunk: one filter per build
    that refines its window (sub-block refine or exact lists; two builds
    under the Newton solve, which also takes h_newton_iters-1
    warm-started density sweeps); one density sweep and one pass 2 per
    step; under RESPA one far launch per period plus the seed, and one P2P
    sweep per step unless pass 2 holds the whole near field; else one
    gravity launch per step."""
    k = cfg.rebuild_every
    chunks = steps // k
    gradh = cfg.grad_p_mode == "grad_h"
    newton = cfg.adaptive_h and cfg.h_mode == "newton" and gradh
    merged = cfg.fuse_p2p_sph and cfg.fuse_p2p_residual
    respa = cfg.respa_every > 1 and k % cfg.respa_every == 0
    refine = cfg.sph_refine_subblock or cfg.sph_exact_window > 0
    out = {"filter_sph": chunks * (2 if newton else 1) * int(refine),
           "pass1_gradh" if gradh else "pass1_sym": chunks * (
               k + (max(1, cfg.h_newton_iters - 1) if newton else 0)),
           "pass2": chunks * k,
           "gravity_fused": chunks * (1 + k // cfg.respa_every if respa
                                      else k)}
    if respa and not merged:
        out["p2p"] = chunks * k
    return out


def all_finite(state):
    import torch
    from planetmodel_sph_tpu_torch.state import FIELDS
    return [k for k in FIELDS
            if getattr(state, k).is_floating_point()
            and not bool(torch.isfinite(getattr(state, k)).all())]


def momentum(state):
    m = state.mass.double()
    return float(((m[:, None] * state.vel.double()).sum(dim=0)).norm())


def inner_ball(state, n_keep):
    """The n_keep particles nearest the centre of mass, every field."""
    import torch
    from planetmodel_sph_tpu_torch.state import FIELDS, ParticleState
    m = state.mass
    com = (m[:, None] * state.pos).sum(dim=0) / m.sum()
    idx = torch.argsort(((state.pos - com) ** 2).sum(dim=1))[:n_keep]
    idx = torch.sort(idx).values
    return ParticleState(**{k: getattr(state, k)[idx].contiguous()
                            for k in FIELDS})


def _run_carry(state, cfg, steps):
    """``planet.init_carry`` and `steps` ``planet.step_carry`` calls:
    (state, the last structure's overflow counters)."""
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure
    c = planet.init_carry(state, cfg)
    for _ in range(steps):
        c = planet.step_carry(c, cfg)
    assert c.tick == steps
    return c.state, structure.overflow_info(c.st)


def small_agreement(state, cfg, prime=False, fields=("pos", "rho"),
                    carry=False):
    """Phase 6: the same pipeline on the card and on the CPU from one small
    input. `fields` (pos and rho) must agree within rtol 1e-4, atol 1e-4
    (the bound tests/test_structure.py holds the fused cached run to),
    overflow counters exactly. `prime`: evaluate the forces under `cfg`
    first, on each device (the state was made under another
    configuration). `carry`: drive the steps through the cached-step API
    (a rebuild every SMALL_STEPS // 2 steps) instead of ``run_info``."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.state import FIELDS, ParticleState
    small = inner_ball(state, SMALL_N)
    scfg = cfg.replace(n=small.n, rebuild_every=SMALL_STEPS // 2,
                       respa_every=SMALL_STEPS // 4, sort_every=SMALL_STEPS)
    cpu = ParticleState(**{k: getattr(small, k).cpu() for k in FIELDS})
    if prime:
        pcfg = scfg.replace(rebuild_every=1, respa_every=1)
        small, cpu = planet.prime(small, pcfg), planet.prime(cpu, pcfg)
    run = _run_carry if carry else planet.run_info
    out_g, info_g = run(small, scfg, SMALL_STEPS)
    out_c, info_c = run(cpu, scfg, SMALL_STEPS)
    res = {}
    ok = True
    for k in fields:
        a = getattr(out_g, k).cpu().double()
        b = getattr(out_c, k).double()
        err = (a - b).abs()
        lim = 1e-4 + 1e-4 * b.abs()
        res[k + "_max_abs_err"] = float(err.max())
        ok &= bool((err <= lim).all())
    ov_g = {k: int(v) for k, v in info_g.items()}
    ov_c = {k: int(v) for k, v in info_c.items()}
    ok &= ov_g == ov_c
    res.update(ok=ok, overflow_gpu=ov_g, overflow_cpu=ov_c, n=small.n,
               steps=SMALL_STEPS)
    return res


def run_leg(label, state, cfg, steps, expect, energy, note="",
            expect_bf16=None):
    """One leg through ``planet.run_info``, the launch counts reset just
    before and read just after. `energy`: 'conserved' (|relative change| <
    1e-2), a number (|relative change| below it), 'not_growing' (damping
    and viscosity remove energy by design: the relative change must be <=
    0) or 'printed'. Under an evolved-u EOS the total energy holds the
    evolved u, which must stay finite with a rate that is not identically
    0. `note` is printed beside the launch counts. `expect_bf16`: the
    launches of the bf16 instances (launch.BF16_LAUNCHES) the leg must
    make, 0 for any not named. Returns (state, report, failures)."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    from planetmodel_sph_tpu_torch.utils import diagnostics
    e0 = diagnostics.measure(state, cfg)
    want = dict.fromkeys(launch.LAUNCHES, 0)
    want.update(expect)
    want_bf16 = dict.fromkeys(launch.BF16_LAUNCHES, 0)
    want_bf16.update(expect_bf16 or {})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    t0 = time.perf_counter()
    out, info = planet.run_info(state, cfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    bf16_launches = dict(launch.BF16_LAUNCHES)
    overflow = {k: int(v) for k, v in info.items()}
    e1 = diagnostics.measure(out, cfg)
    de = float((e1["total_energy"] - e0["total_energy"])
               / abs(e0["total_energy"]))
    nbrs = float(e1["neighbors_avg"])
    bad_fields = all_finite(out)
    rep = dict(leg=label, n=state.n, steps=steps, wall_s=wall,
               steps_per_s=steps / wall, overflow=overflow,
               launches=launches, expected=want,
               bf16_launches=bf16_launches, expected_bf16=want_bf16,
               non_finite=bad_fields,
               neighbors_avg=nbrs, momentum_mag=float(e1["momentum_mag"]),
               rel_energy_change=de,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"leg {label}: n={state.n} {steps} steps in {wall:.3f} s = "
          f"{steps / wall:.3f} steps/s, peak memory "
          f"{rep['peak_mem_gb']:.3f} GB", flush=True)
    b16 = {k: v for k, v in bf16_launches.items() if v}
    print(f"  launches { {k: v for k, v in launches.items() if v} }"
          f"{', of them bf16 ' + str(b16) if b16 else ''}"
          f"{' (' + note + ')' if note else ''}", flush=True)
    print(f"  overflow {overflow} non-finite {bad_fields} neighbors_avg "
          f"{nbrs:.2f} momentum_mag {rep['momentum_mag']:.3e} rel energy "
          f"change {de:.3e}", flush=True)
    failures = []
    if any(overflow.values()):
        failures.append(f"{label}: overflow counters not 0: {overflow}")
    if launches != want:
        failures.append(f"{label}: launch counts {launches} != {want}")
    if bf16_launches != want_bf16:
        failures.append(f"{label}: bf16 launch counts {bf16_launches} != "
                        f"{want_bf16}")
    if bad_fields:
        failures.append(f"{label}: non-finite fields: {bad_fields}")
    if not 30.0 <= nbrs <= 80.0:
        failures.append(f"{label}: neighbors_avg {nbrs:.2f} outside 30-80")
    limit = 1e-2 if energy == "conserved" else energy
    if not isinstance(limit, str) and not abs(de) < limit:
        failures.append(f"{label}: total energy moved by {de:.3e} in "
                        f"{steps} steps (limit {limit})")
    if cfg.evolves_u:
        rep.update(u_max_before=float(state.u.max()),
                   u_max_after=float(out.u.max()),
                   du_dt_max=float(out.du_dt.abs().max()))
        print(f"  max u {rep['u_max_before']:.6e} -> "
              f"{rep['u_max_after']:.6e}, max |du/dt| "
              f"{rep['du_dt_max']:.3e}", flush=True)
        if not rep["du_dt_max"] > 0.0:
            failures.append(f"{label}: du_dt is identically 0")
    if energy == "not_growing" and not de <= 0.0:
        failures.append(f"{label}: total energy grew by {de:.3e} in "
                        f"{steps} steps")
    return out, rep, failures


def grid_legs(cfg, sym_state, settle_state, settle_cfg):
    """Phase 5c: the three configurations of the general grid + tree step.
    Returns ([report], failures)."""
    reports, failures = [], []

    def leg(*a):
        out, rep, fails = run_leg(*a)
        reports.append(rep)
        failures.extend(fails)
        return out

    # sym100k: the settled state under the unfused symmetric step; its
    # force fields are evaluated again under the new configuration first
    sym = cfg.replace(**SYM_KW)
    st = leg("sym100k", sym_state, sym, SYM_STEPS,
             expected_launches(sym, SYM_STEPS), "conserved")
    tiers = sym.replace(respa_every=1, rebuild_every=SYM_TIER_STEPS)
    leg("sym100k_every_tier", st, tiers, SYM_TIER_STEPS,
        expected_launches(tiers, SYM_TIER_STEPS), "conserved")
    del st

    # settle100k: the settle phase from the raw polytrope
    st = leg("settle100k", settle_state, settle_cfg, SETTLE_STEPS,
             expected_launches(settle_cfg, SETTLE_STEPS), "not_growing")
    bal = settle_cfg.replace(av_balsara=True)
    leg("settle100k_balsara", st, bal, SETTLE_BALSARA_STEPS,
        expected_launches(bal, SETTLE_BALSARA_STEPS), "not_growing")
    del st

    # parity3k: the parity preset as the command line gives it
    pcfg, st = parity_start()
    leg("parity3k", st, pcfg, PARITY_STEPS,
        dict(pairwise_pass1=PARITY_STEPS, pairwise_pass2=PARITY_STEPS,
             gravity_fused=PARITY_STEPS), "printed")
    return reports, failures


# the reference's band of bf16 against f32 gravity (tests/test_structure.py
# test_bf16_gravity_close_to_f32): phi rtol, g atol of max|g|
BF16_PHI_RTOL = 5e-3
BF16_G_ATOL = 1e-2


def first_eval_band(label, state, cfg32, cfg16):
    """A leg's first evaluation under cfg16 (grav_pair_dtype='bfloat16')
    against its f32 twin's: one chunk set-up from `state` (the structure
    does not depend on the pair dtype), then the gravity the leg's first
    step evaluates, the near tier with the far tiers under RESPA, every
    tier otherwise. phi must agree within BF16_PHI_RTOL and grad phi within
    BF16_G_ATOL of its largest magnitude on the live rows, both finite.
    Returns the report."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure
    run_state, st = planet.chunk_setup(state, cfg32)
    respa = planet._respa(cfg32) and \
        cfg32.rebuild_every % cfg32.respa_every == 0
    fields = {}
    for tag, c in (("f32", cfg32), ("bf16", cfg16)):
        kw = planet._forces_kw(c, run_state.u, run_state.matid,
                               run_state.balsara)
        kw.setdefault("fbal", run_state.balsara)
        f = planet._forces_block(run_state.pos, run_state.h, run_state.mass,
                                 c, st, vel=run_state.vel, solve_h=False,
                                 sorted_io=True,
                                 grav_tiers="near" if respa else "all", **kw)
        phi, g = f.phi, f.grad_phi
        if respa:
            phi_f, g_f, _ = structure.gravity_far(
                run_state.pos, run_state.h, run_state.mass, c, st,
                sorted_io=True)
            phi, g = phi + phi_f, g + g_f
        fields[tag] = (phi.double(), g.double())
    live = st.groups.live.reshape(-1)
    (p32, g32), (p16, g16) = fields["f32"], fields["bf16"]
    phi_err = float(((p16 - p32).abs() / p32.abs())[live].max())
    g_err = float((g16 - g32)[live].abs().max() / g32[live].abs().max())
    finite = bool(torch.isfinite(p16[live]).all()
                  and torch.isfinite(g16[live]).all())
    ok = finite and phi_err <= BF16_PHI_RTOL and g_err <= BF16_G_ATOL
    what = "near + far" if respa else "every tier"
    print(f"leg {label}: first evaluation ({what}), "
          f"bf16 against f32: phi {phi_err:.3e} (band rtol "
          f"{BF16_PHI_RTOL}), grad phi {g_err:.3e} of max|g| (band "
          f"{BF16_G_ATOL}), finite {finite}: {'ok' if ok else 'OUTSIDE'}",
          flush=True)
    del run_state, st, fields
    return dict(respa=respa, phi_rel_err=phi_err, g_err=g_err,
                finite=finite, ok=ok)


def f32_twin_run(start, cfg, steps):
    """The f32 twin of a bf16 leg, run just before it: (end state, steps/s,
    relative energy change)."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.utils import diagnostics
    e0 = diagnostics.measure(start, cfg)["total_energy"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = planet.run_info(start, cfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e1 = diagnostics.measure(out, cfg)["total_energy"]
    return out, steps / wall, float((e1 - e0) / abs(e0))


def bf16_legs(cfg, state, sym_state):
    """Phase 5c': the bfloat16 gravity pair path, each leg beside its f32
    twin, run from the same state just before it (steps/s and the energy
    change): `prod100k_bf16` (the settled state under the production flags
    with grav_pair_dtype='bfloat16', 64 steps: every far-only
    gravity_fused launch bf16, pass 2's merged near window f32) and
    `sym100k_bf16` (64 RESPA steps: every p2p and far-only launch bf16;
    then 8 every-tier steps from its end: every gravity_fused launch
    bf16). A bf16 leg starts from its state primed again under its own
    configuration, as ``bench --set`` primes a state file (the stored
    fields, phi among them, are the f32 twin's: the energy change would
    read the switch of pair dtype). Each leg's first evaluation is held
    against f32 in the reference's band. Returns ([report], failures)."""
    from planetmodel_sph_tpu_torch.models import planet
    reports, failures = [], []

    def leg(label, start32, c32, steps, bf16_names, start16=None):
        c16 = c32.replace(grav_pair_dtype="bfloat16")
        if start16 is None:
            start16 = planet.prime(start32, c16.replace(rebuild_every=1,
                                                        respa_every=1))
        band = first_eval_band(label, start16, c32, c16)
        out32, rate32, de32 = f32_twin_run(start32, c32, steps)
        exp = expected_launches(c16, steps)
        out, rep, fails = run_leg(
            label, start16, c16, steps, exp, "conserved",
            expect_bf16={k: exp[k] for k in bf16_names},
            note=f"bf16: every {' and '.join(bf16_names)} launch")
        rep.update(first_eval=band, f32_twin=dict(steps_per_s=rate32,
                                                  rel_energy_change=de32))
        print(f"  {label} beside its f32 twin: {rep['steps_per_s']:.3f} "
              f"against {rate32:.3f} steps/s, rel energy change "
              f"{rep['rel_energy_change']:.3e} against {de32:.3e}",
              flush=True)
        reports.append(rep)
        failures.extend(fails)
        if not band["ok"]:
            failures.append(f"{label}: first evaluation outside the bf16 "
                            f"band: {band}")
        return out32, out

    leg("prod100k_bf16", state, cfg, STEPS, ("gravity_fused",))
    sym = cfg.replace(**SYM_KW)
    out32, out16 = leg("sym100k_bf16", sym_state, sym, SYM_STEPS,
                       ("p2p", "gravity_fused"))
    leg("sym100k_bf16_every_tier", out32,
        sym.replace(respa_every=1, rebuild_every=SYM_TIER_STEPS),
        SYM_TIER_STEPS, ("gravity_fused",), start16=out16)
    return reports, failures


def energy_legs(cfg, adia_state, sg_state, basalt_cfg, basalt_state,
                sym_de):
    """Phase 5d: the energy equation and the supergroup far tier. `sym_de`:
    the relative energy change of the `sym100k` leg, which `sg100k`'s must
    match in order of magnitude. Returns ([report], failures)."""
    reports, failures = [], []

    def leg(*a, **kw):
        out, rep, fails = run_leg(*a, **kw)
        reports.append(rep)
        failures.extend(fails)
        return out

    # adia100k: the production chunk with the evolved internal energy
    adia = cfg.replace(**ADIA_KW)
    st = leg("adia100k", adia_state, adia, ADIA_STEPS,
             expected_launches(adia, ADIA_STEPS), 1e-3)
    noav = adia.replace(av_alpha=0.0, av_beta=0.0,
                        rebuild_every=ADIA_NOAV_STEPS,
                        respa_every=ADIA_NOAV_STEPS)
    leg("adia100k_no_av", st, noav, ADIA_NOAV_STEPS,
        expected_launches(noav, ADIA_NOAV_STEPS), 1e-3)
    del st

    # basalt4k: the Tillotson impact at the preset's own size, dense: the
    # reference's envelope for this impact is a few percent
    bcfg, bst = basalt_start()
    out = leg("basalt4k", bst, bcfg, BASALT_STEPS, {}, 0.06,
              note="no hand kernel: with an evolved u the dense step takes "
              "ops/dense.py, as the reference's does; its all-pairs "
              "kernels have no energy column")
    if not float(out.u.max()) > float(bst.u.max()):
        failures.append("basalt4k: max(u) did not rise")
    del out, bst

    # basalt100k: the same impact on grid neighbours with tree gravity
    leg("basalt100k", basalt_state, basalt_cfg, BASALT100K_STEPS,
        dict(pass1_sym=BASALT100K_STEPS, pass2=BASALT100K_STEPS,
             gravity_fused=BASALT100K_STEPS), 0.06)

    # sg100k: sym100k with the supergroup far tier
    sg = cfg.replace(**SYM_KW, **SG_KW)
    st = leg("sg100k", sg_state, sg, SYM_STEPS,
             expected_launches(sg, SYM_STEPS), "conserved")
    sg_de = reports[-1]["rel_energy_change"]
    print(f"  sg100k rel energy change {sg_de:.3e} against sym100k's "
          f"{sym_de:.3e}", flush=True)
    if not abs(sg_de) <= 10.0 * abs(sym_de):
        failures.append(f"sg100k: energy moved by {sg_de:.3e}, more than "
                        f"ten times sym100k's {sym_de:.3e}")
    tiers = sg.replace(respa_every=1, rebuild_every=SYM_TIER_STEPS)
    leg("sg100k_every_tier", st, tiers, SYM_TIER_STEPS,
        expected_launches(tiers, SYM_TIER_STEPS), "conserved")
    return reports, failures


def dense_main(n, steps, label=None, **kw):
    """Phase 5 for the dense path: the cold-start bench's sequence through
    the entry points (initial conditions, priming pass, a warm-up run of
    the same length, the timed run), the launch counts reset just before
    the timed run and read just after. `kw` changes the ``jupiter_3k``
    preset (`dense3k_k4`: rebuild_every=4). Returns (report, failures)."""
    import torch
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    from planetmodel_sph_tpu_torch.utils import diagnostics
    cfg = config_mod.jupiter_3k(n=n, **kw)
    label = label or f"dense n={n}"
    torch.cuda.reset_peak_memory_stats()
    state = planet.prime(ics.jupiter(cfg), cfg)
    state = planet.run(state, cfg, steps)
    e0 = diagnostics.measure(state, cfg)
    torch.cuda.synchronize()
    launch.reset_launches()
    t0 = time.perf_counter()
    out, info = planet.run_info(state, cfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    expect.update(pairwise_pass1=steps, pairwise_pass2=steps,
                  pairwise_plan=steps if n >= pw.PLAN_MIN_N else 0)
    overflow = {k: int(v) for k, v in info.items()}
    e1 = diagnostics.measure(out, cfg)
    de = float((e1["total_energy"] - e0["total_energy"])
               / abs(e0["total_energy"]))
    nbrs = float(e1["neighbors_avg"])
    mom = float(e1["momentum_mag"])
    bad_fields = all_finite(out)
    rep = dict(leg=label, n=n, steps=steps, wall_s=wall,
               steps_per_s=steps / wall,
               particle_steps_per_s=n * steps / wall, overflow=overflow,
               launches=launches, expected=expect, non_finite=bad_fields,
               neighbors_avg=nbrs, momentum_mag=mom, rel_energy_change=de,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{label}: {steps} steps in {wall:.3f} s = "
          f"{steps / wall:.2f} steps/s = {n * steps / wall:.4g} "
          f"particle-steps/s, peak memory {rep['peak_mem_gb']:.3f} GB",
          flush=True)
    print(f"  launches {launches}", flush=True)
    print(f"  overflow {overflow} non-finite {bad_fields} neighbors_avg "
          f"{nbrs:.2f} momentum_mag {mom:.3e} rel energy change {de:.3e}",
          flush=True)
    failures = []
    if any(overflow.values()):
        failures.append(f"{label}: overflow counters not 0: {overflow}")
    if launches != expect:
        failures.append(f"{label}: launch counts {launches} != {expect}")
    if bad_fields:
        failures.append(f"{label}: non-finite fields: {bad_fields}")
    if not 30.0 <= nbrs <= 80.0:
        failures.append(f"{label}: neighbors_avg {nbrs:.2f} outside "
                        "30-80")
    if not mom < 1e-4:
        failures.append(f"{label}: momentum_mag {mom:.3e} >= 1e-4")
    if not abs(de) < 1e-2 * max(1.0, steps / 100.0):
        failures.append(f"{label}: total energy moved by {de:.3e} in "
                        f"{steps} steps")
    return rep, failures


def dense_small_agreement():
    """Phase 6 for the dense path: DENSE_SMALL_N particles from the port's
    initial conditions (drawn on the CPU, so both runs start from identical
    particles), primed and run SMALL_STEPS steps on the card and on the
    CPU. The neighbour counts after the first step must be equal, pos and
    rho after the last within rtol 1e-4, atol 1e-4."""
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    cfg = config_mod.jupiter_3k(n=DENSE_SMALL_N, radius=20.0,
                                particle_radius=4.0)
    res, ok = {}, True
    ends = []
    for dev in ("cuda", "cpu"):
        st = planet.prime(ics.jupiter(cfg, device=dev), cfg)
        first = planet.run(st, cfg, 1)
        ends.append((first, planet.run(first, cfg, SMALL_STEPS - 1)))
    (first_g, out_g), (first_c, out_c) = ends
    diff = int((first_g.n_neighbors.cpu() != first_c.n_neighbors).sum())
    res["first_step_count_mismatches"] = diff
    ok &= diff == 0
    for k in ("pos", "rho"):
        a = getattr(out_g, k).cpu().double()
        b = getattr(out_c, k).double()
        err = (a - b).abs()
        res[k + "_max_abs_err"] = float(err.max())
        ok &= bool((err <= 1e-4 + 1e-4 * b.abs()).all())
    res.update(ok=ok, n=cfg.n, steps=SMALL_STEPS,
               neighbors_avg=float(out_g.n_neighbors.float().mean()))
    return res


def probe_entry(name, source, replaces, probe_reports, launches):
    """The kernels line's entry of one probe: its first case, the others
    (probe_pass1_tile's wider tiles) under "case_<case>"; launches from
    the tools phase."""
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "graph_ms")
    own = [r for r in probe_reports if r["name"] == name]
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[name], **{k: own[0][k] for k in keys})
    if own[0]["case"]:
        entry["case"] = own[0]["case"]
    for c in own[1:]:
        entry["case_" + c["case"]] = {k: c[k] for k in keys}
    return entry


# ---------------------------------------------------------------------------
# phase 8: the long horizon, each run in a process of its own
# ---------------------------------------------------------------------------

LONG_DIR = os.path.join(OUT_DIR, "long_horizon")
LONG_KERNELS = ("pass1_gradh", "pass2", "gravity_fused", "filter_sph")
DENSE_KERNELS = ("pairwise_pass1", "pairwise_pass2")
PNG_NON_BLACK = 0.5       # "mostly non-black": the share of lit pixels
# the reference's published results (docs/results/RESULTS.md:38-43,
# :150-156, :339-343), printed beside this run's, never in their place
REFERENCE = dict(energy_per_10k=1.54e-5, max_momentum=7.26e-5,
                 spin_per_10k=1.38e-5, rotating_l_rel_per_10k=1.38e-3,
                 rotating_energy_per_10k=6.6e-5,
                 equilibrium_relax_per_10k=1.0e-2)

# `python -c` of one entry point as a user runs it (`python -m MODULE
# ARGS`), its launch counts reset before and written to COUNTS after
COUNTED_RUN = """
import json, runpy, sys
from planetmodel_sph_tpu_torch.ops.cuda import launch
counts, mod = sys.argv[1], sys.argv[2]
sys.argv = [mod] + sys.argv[3:]
launch.reset_launches()
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
finally:
    with open(counts, "w") as f:
        json.dump(launch.LAUNCHES, f)
"""


def _counted_cmd(label, module, args, logdir=LONG_DIR):
    counts = os.path.join(logdir, f"{label}.launches.json")
    return [sys.executable, "-c", COUNTED_RUN, counts, module, *args], counts


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def counted_run(label, module, args, timeout=900, logdir=LONG_DIR):
    """`python -m module args` from the root in a process of its own, its
    output in <logdir>/<label>.log: dict(rc, wall_s, launches, out); the
    launches are that process's own (not those of ranks it spawns)."""
    cmd, counts = _counted_cmd(label, module, args, logdir)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=timeout)
    with open(os.path.join(logdir, f"{label}.log"), "w") as f:
        f.write(r.stdout + "\n--- stderr\n" + r.stderr)
    launches = json.load(open(counts)) if os.path.exists(counts) else {}
    return dict(args=[module, *args], rc=r.returncode,
                wall_s=time.perf_counter() - t0, launches=launches,
                out=r.stdout, err_tail=r.stderr[-2000:])


DEBUG_NANS_DIR = os.path.join(OUT_DIR, "debug_nans")
DEBUG_NANS_STEPS = 64     # two diagnostics chunks of 32: phase 5's cell
NAN_PARTICLE = 12345      # the particle whose mass phase 5g makes NaN


def _cli_in_process(args):
    """``cli.main(args)`` in this process, its stderr captured and its
    launches counted from 0: (exit code, stderr, wall s, launches)."""
    import contextlib
    import io
    import torch
    from planetmodel_sph_tpu_torch import cli
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    buf = io.StringIO()
    torch.cuda.synchronize()
    launch.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        try:
            rc = cli.main(args)
        except Exception:               # noqa: BLE001 - reported, fails
            rc = 1
            traceback.print_exc()
    torch.cuda.synchronize()
    return (rc, buf.getvalue(), time.perf_counter() - t0,
            {k: v for k, v in launch.LAUNCHES.items() if v})


def debug_nans_phase(card):
    """Phase 5g: ``cli run --debug-nans`` on the card. The settled state's
    64-step production run (``--restore``, diagnostics every 32 steps) in
    this process, after a warm-up run, without the flag, with, with,
    without: the same bits (its npz checkpoints equal), the same launches,
    overflow 0, each run's own "steps in" wall and the call's wall (the
    state's load included, the same in all four) printed. Then the same
    state with one mass made NaN: the ``FloatingPointError`` (a non-zero
    exit from ``python -m``) naming a field, a step and the first op or
    kernel, and no checkpoint. Returns (report, failures)."""
    import re
    import numpy as np
    from planetmodel_sph_tpu_torch.utils import checkpoint
    shutil.rmtree(DEBUG_NANS_DIR, ignore_errors=True)
    os.makedirs(DEBUG_NANS_DIR)
    print(f"phase 5g (--debug-nans) on {card}", flush=True)
    t_all = time.perf_counter()
    base = ["run", "--restore", STATE, "--steps", str(DEBUG_NANS_STEPS),
            "--diag-every", "32"]
    runs, fails = [], []
    _cli_in_process(base)               # a warm-up, its numbers not kept
    for k, flag in enumerate((False, True, True, False)):
        ck = os.path.join(DEBUG_NANS_DIR, f"run{k}.npz")
        m = os.path.join(DEBUG_NANS_DIR, f"run{k}.jsonl")
        rc, err, wall, launches = _cli_in_process(
            base + ["--checkpoint", ck, "--metrics-jsonl", m]
            + (["--debug-nans"] if flag else []))
        said = re.search(r"(\d+) steps in ([\d.]+)s", err)
        rows = [json.loads(ln) for ln in open(m)] if os.path.exists(m) \
            else []
        over = {key: sum(int(r.get(key, 0)) for r in rows)
                for key in ("nbr_overflow", "tree_overflow")}
        r = dict(debug_nans=flag, rc=rc, wall_s=wall,
                 run_s=float(said.group(2)) if said else None,
                 launches=launches, overflow=over, checkpoint=ck)
        runs.append(r)
        print(f"  {'with' if flag else 'without'} --debug-nans: exit {rc}, "
              f"{DEBUG_NANS_STEPS} steps in {r['run_s']} s (the call "
              f"{wall:.4f} s with the state's load), launches {launches}, "
              f"overflow {over}", flush=True)
        if (rc != 0 or any(over.values()) or not os.path.exists(ck)
                or r["run_s"] is None):
            fails.append(f"phase 5g run {k} (--debug-nans {flag}): exit "
                         f"{rc}, overflow {over}: {err[-500:]}")
    if not fails:
        ref = np.load(runs[0]["checkpoint"])
        for k, r in enumerate(runs[1:], 1):
            z = np.load(r["checkpoint"])
            r["same_bits"] = sorted(z.files) == sorted(ref.files) and all(
                np.array_equal(ref[f], z[f]) for f in ref.files)
            if not r["same_bits"] or r["launches"] != runs[0]["launches"]:
                fails.append(f"phase 5g run {k}: same bits "
                             f"{r['same_bits']}, launches {r['launches']} "
                             f"against {runs[0]['launches']}")
        with_s = [r["wall_s"] for r in runs if r["debug_nans"]]
        without_s = [r["wall_s"] for r in runs if not r["debug_nans"]]
        print(f"  same bits and launches in all four: {not fails}; the "
              f"calls' walls with {[round(x, 4) for x in with_s]}, without "
              f"{[round(x, 4) for x in without_s]} s "
              f"({sum(with_s) / sum(without_s):.3f}x)", flush=True)
    state, cfg, step = checkpoint.load(STATE, device="cpu")
    state.mass[NAN_PARTICLE] = float("nan")
    bad = os.path.join(DEBUG_NANS_DIR, "nan_mass.npz")
    never = os.path.join(DEBUG_NANS_DIR, "never.npz")
    checkpoint.save(bad, state, cfg, step)
    rc, err, wall, launches = _cli_in_process(
        base[:2] + [bad] + base[3:] + ["--debug-nans", "--checkpoint",
                                       never])
    with open(os.path.join(DEBUG_NANS_DIR, "nan_mass.log"), "w") as f:
        f.write(err)
    msg = [ln for ln in err.splitlines()
           if ln.startswith("FloatingPointError")]
    nan_run = dict(rc=rc, wall_s=wall, launches=launches,
                   message=msg[-1] if msg else None)
    print(f"  planted NaN mass (particle {NAN_PARTICLE}): exit "
          f"{nan_run['rc']}, {nan_run['message']} ({nan_run['wall_s']:.1f}"
          " s)", flush=True)
    m = nan_run["message"] or ""
    if (nan_run["rc"] == 0 or "NaN in the state's" not in m
            or "step" not in m or "came out of" not in m
            or os.path.exists(never)):
        fails.append(f"phase 5g planted NaN: exit {nan_run['rc']}, message "
                     f"{m!r}, checkpoint written {os.path.exists(never)}")
    for f in glob.glob(os.path.join(DEBUG_NANS_DIR, "*.npz")):
        os.remove(f)            # 12 MB each: the logs and report stay
    rep = dict(runs=runs, nan_run=nan_run,
               total_s=time.perf_counter() - t_all)
    print(f"phase 5g: {rep['total_s']:.1f} s", flush=True)
    return rep, fails


def _http(port, path, payload=None):
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def served_run(label, args, timeout=600):
    """:func:`counted_run` of ``cli run ... --serve 0``: on the line that
    names the viewer's port, pause the run from the viewer, wait for the
    first frame, GET /diag.json and /points.bin, steer a knob, resume."""
    cmd, counts = _counted_cmd(label, "planetmodel_sph_tpu_torch.cli", args)
    t0 = time.perf_counter()
    got = dict(diag=None, points_n=None, points_bytes=None, error=None)
    err = []
    with open(os.path.join(LONG_DIR, f"{label}.log"), "w") as log:
        p = subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=log,
                             stderr=subprocess.PIPE, text=True)
        try:
            for line in p.stderr:
                err.append(line)
                if "live view -> http://127.0.0.1:" not in line or \
                        got["diag"] is not None:
                    continue
                port = int(line.rsplit(":", 1)[1])
                try:
                    _http(port, "/control", {"cmd": "pause"})
                    t_wait = time.perf_counter()
                    while True:
                        d = json.loads(_http(port, "/diag.json"))
                        if "step" in d or time.perf_counter() - t_wait > 120:
                            break
                        time.sleep(0.2)
                    got["diag"] = d
                    pts = _http(port, "/points.bin")
                    got["points_n"] = int.from_bytes(pts[:4], "little")
                    got["points_bytes"] = len(pts)
                    _http(port, "/control", {"cmd": "set", "overrides":
                                             {"vel_damping": 0.0}})
                    _http(port, "/control", {"cmd": "resume"})
                except OSError as e:
                    got["error"] = f"{type(e).__name__}: {e}"
            rc = p.wait(timeout=timeout)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        log.write("--- stderr\n" + "".join(err))
    launches = json.load(open(counts)) if os.path.exists(counts) else {}
    return dict(args=["planetmodel_sph_tpu_torch.cli", *args], rc=rc,
                wall_s=time.perf_counter() - t0, launches=launches,
                err_tail="".join(err)[-2000:], **got)


def png_non_black(path) -> float:
    """The share of pixels of a PNG that are not black."""
    from PIL import Image
    import numpy as np
    with Image.open(path) as im:
        a = np.asarray(im.convert("RGB"))
    return float((a.sum(axis=-1) > 0).mean())


def _phase_rates(out):
    """The drift tool's lines 'phase P: N steps in S s of stepping =
    R steps/s; retried chunks T s' as {P: dict(steps, s, steps_per_s,
    retried_s)}."""
    rates = {}
    for ln in out.splitlines():
        if ln.startswith("phase ") and "steps/s" in ln:
            name, rest = ln[len("phase "):].split(":", 1)
            w = rest.split()
            rates[name] = dict(steps=int(w[0]), s=float(w[3]),
                               steps_per_s=float(w[8]),
                               retried_s=float(w[12]))
    return rates


def failed_gates(g, budgets=(1e-3, 1e-3, 5e-5)):
    """The names of the ship gate's budgets that `g` (gate_numbers) misses."""
    if g is None:
        return ["drift rows"]
    de, pm, sp = budgets
    out = [name for name, bad in (
        ("|dE|/|E|", not g["energy_per_10k"] <= de),
        ("max |p|", not g["max_momentum"] <= pm),
        ("overflow", g["overflow"] != 0),
        ("dL/I", g["spin_per_10k"] is not None
         and not g["spin_per_10k"] <= sp)) if bad]
    return out


def long_horizon_failures(rep):
    """What phase 8's report `rep` fails: a run that exited non-zero, a
    kernel its path runs that was not launched, the ship gate, the
    rotating body's overflow or energy, the equilibrium artifacts, the
    bench lines, the command line's artifacts and served frames, the block
    overlay's filter launch."""
    fails = []
    for label, r in rep["runs"].items():
        if r["rc"] != 0 and label != "drift100k":
            fails.append(f"phase 8 {label}: exit code {r['rc']}: "
                         f"{r.get('err_tail', '')[-300:]}")
        idle = [k for k in r["expect_launched"]
                if not r["launches"].get(k)]
        if idle:
            fails.append(f"phase 8 {label}: no launch of {idle} "
                         f"(launches {r['launches']})")
    d = rep["runs"]["drift100k"]
    bad = failed_gates(d.get("gate"))
    if d["rc"] != 0 or bad:
        fails.append(f"phase 8 drift100k: ship gate FAIL ({', '.join(bad)}"
                     f"; exit code {d['rc']})")
    r = rep["runs"]["rotating_l_check"]
    s = r.get("summary") or {}
    if s.get("overflow") != 0 or not math.isfinite(
            s.get("energy_drift_per_10k", math.nan)):
        fails.append(f"phase 8 rotating_l_check: overflow "
                     f"{s.get('overflow')}, energy drift "
                     f"{s.get('energy_drift_per_10k')}")
    e = rep["runs"]["equilibrium_run"]
    if e.get("missing") or not (e.get("png_non_black") or 0) \
            >= PNG_NON_BLACK:
        fails.append(f"phase 8 equilibrium_run: missing {e.get('missing')}, "
                     f"PNG lit share {e.get('png_non_black')}")
    lines = rep["runs"]["bench_lines"].get("lines", [])
    if len(lines) != 2 or any("error" in ln or not ln.get("value", 0) > 0
                              for ln in lines):
        fails.append(f"phase 8 bench --lines: {lines}")
    c = rep["runs"]["cli"]
    if c.get("error") or not (c.get("diag") or {}).get("step") or \
            c.get("points_n") != c.get("n") or c.get("missing"):
        fails.append(f"phase 8 cli: served {c.get('diag')}, points "
                     f"{c.get('points_n')}, missing {c.get('missing')}, "
                     f"error {c.get('error')}")
    b = rep["runs"]["cli_blocks"]
    if b["launches"].get("filter_sph") != b.get("expect_filter") or \
            b.get("missing"):
        fails.append(f"phase 8 cli --render-blocks: filter_sph "
                     f"{b['launches'].get('filter_sph')} != "
                     f"{b.get('expect_filter')}, missing {b.get('missing')}")
    return fails


def _missing(paths):
    return [os.path.relpath(p, LONG_DIR) for p in paths
            if not os.path.exists(p)]


def long_horizon_phase(card):
    """Phase 8: the long-horizon tools, bench lines and the command
    line's rendering and viewer, each in a process of its own with its
    launch counts read after it (README's commands). Returns (report,
    failures)."""
    from planetmodel_sph_tpu_torch.tools import drift100k
    shutil.rmtree(LONG_DIR, ignore_errors=True)
    os.makedirs(LONG_DIR)
    t_all = time.perf_counter()
    runs = {}
    print(f"phase 8 (long horizon) on {card}", flush=True)

    # a. the drift protocol at its defaults, into a fresh directory
    ddir = os.path.join(LONG_DIR, "drift100k")
    r = counted_run("drift100k", "planetmodel_sph_tpu_torch.tools.drift100k",
                    ["--out", ddir], timeout=1100)
    jsonl = os.path.join(ddir, "metrics.jsonl")
    r.update(expect_launched=LONG_KERNELS,
             gate=drift100k.gate_numbers(jsonl) if os.path.exists(jsonl)
             else None, phases=_phase_rates(r["out"]),
             retried=[ln for ln in r["out"].splitlines()
                      if "chunk retried" in ln or "back to preset" in ln],
             gate_line=next((ln for ln in r["out"].splitlines()
                             if ln.startswith("SHIP GATE")), None))
    runs["drift100k"] = r
    g = r["gate"] or {}
    print(f"  drift100k: {r['gate_line']} ({r['wall_s']:.1f} s)", flush=True)
    print(f"    gate numbers {g} (reference: |dE|/|E| "
          f"{REFERENCE['energy_per_10k']:g}, max |p| "
          f"{REFERENCE['max_momentum']:g}, dL/I "
          f"{REFERENCE['spin_per_10k']:g})", flush=True)
    for name, ph in r["phases"].items():
        print(f"    {name}: {ph['steps']} steps at {ph['steps_per_s']:.3f} "
              f"steps/s ({ph['retried_s']:.3f} s of retried chunks)",
              flush=True)
    print(f"    retried chunks: {r['retried'] or 'none'}; launches "
          f"{r['launches']}", flush=True)

    # b. the rotating body from the settled state
    rot = os.path.join(LONG_DIR, "rotating_l_100k.json")
    r = counted_run("rotating_l_check",
                    "planetmodel_sph_tpu_torch.tools.rotating_l_check",
                    ["--omega", "0.01", "--steps", "3000", "--widen", "1.5",
                     "--out", rot])
    r.update(expect_launched=LONG_KERNELS, summary={
        k: v for k, v in json.load(open(rot)).items() if k != "rows"}
        if os.path.exists(rot) else None)
    runs["rotating_l_check"] = r
    s = r["summary"] or {}
    print(f"  rotating_l_check: |dL|/|L| {s.get('l_rel_drift_per_10k')} and "
          f"energy {s.get('energy_drift_per_10k')} per 10k steps, overflow "
          f"{s.get('overflow')} (reference: "
          f"{REFERENCE['rotating_l_rel_per_10k']:g} and "
          f"{REFERENCE['rotating_energy_per_10k']:g}); launches "
          f"{r['launches']} ({r['wall_s']:.1f} s)", flush=True)

    # c. the 3k hydrostatic equilibrium (relax-mode h: the all-pairs
    # kernels)
    edir = os.path.join(LONG_DIR, "equilibrium")
    r = counted_run("equilibrium_run",
                    "planetmodel_sph_tpu_torch.tools.equilibrium_run",
                    ["--preset", "jupiter_3k", "--steps", "10000", "--out",
                     edir])
    arts = [os.path.join(edir, f) for f in (
        "equilibrium_diags.npz", "equilibrium_state.psph",
        "equilibrium.png", "profile.json")]
    png, prof = arts[2], arts[3]
    r.update(expect_launched=DENSE_KERNELS, missing=_missing(arts),
             png_non_black=png_non_black(png) if os.path.exists(png)
             else None,
             energy_drift=json.load(open(prof))["energy_drift"]
             if os.path.exists(prof) else None,
             lines=[ln for ln in r["out"].splitlines()
                    if "steps/s" in ln or "drift" in ln])
    runs["equilibrium_run"] = r
    print(f"  equilibrium_run jupiter_3k: drift {r['energy_drift']} over "
          f"10000 steps; {'; '.join(r['lines'])}; PNG lit "
          f"{r['png_non_black']}; launches {r['launches']} "
          f"({r['wall_s']:.1f} s)", flush=True)

    # d. a drift probe from a's final checkpoint
    pjsonl = os.path.join(LONG_DIR, "drift_probe.jsonl")
    r = counted_run("drift_probe",
                    "planetmodel_sph_tpu_torch.tools.drift_probe",
                    ["--probe", "ctrl", "--steps", "1000", "--settled",
                     os.path.join(ddir, "state.psph"), "--out", pjsonl])
    r.update(expect_launched=LONG_KERNELS, row=json.loads(
        open(pjsonl).readline()) if os.path.exists(pjsonl) else None)
    runs["drift_probe"] = r
    print(f"  drift_probe ctrl: {r['row']}; launches {r['launches']} "
          f"({r['wall_s']:.1f} s)", flush=True)

    # e. the two bench lines
    r = counted_run("bench_lines", "planetmodel_sph_tpu_torch.bench",
                    ["--lines"])
    r.update(expect_launched=LONG_KERNELS + DENSE_KERNELS,
             lines=[json.loads(ln) for ln in r["out"].splitlines()
                    if ln.startswith("{")])
    runs["bench_lines"] = r
    for ln in r["lines"]:
        print(f"  bench --lines: {json.dumps(ln)}", flush=True)

    # f. the command line: frames, GIF, final PNG and the live viewer
    frames = os.path.join(LONG_DIR, "frames")
    gif = os.path.join(LONG_DIR, "run.gif")
    final = os.path.join(LONG_DIR, "final.png")
    r = served_run("cli", ["run", "--preset", "jupiter_3k", "--steps", "40",
                           "--render-every", "10", "--render-every-dir",
                           frames, "--animate", gif, "--render", final,
                           "--render-blocks", "--serve", "0"])
    r.update(expect_launched=DENSE_KERNELS, n=3000, missing=_missing(
        [gif, final] + [os.path.join(frames, f"frame_{i:05d}.png")
                        for i in range(4)]))
    runs["cli"] = r
    print(f"  cli run --serve: /diag.json step {(r['diag'] or {}).get('step')}"
          f" paused {(r['diag'] or {}).get('paused')}, /points.bin "
          f"{r['points_n']} points ({r['points_bytes']} B); missing "
          f"{r['missing']}; launches {r['launches']} ({r['wall_s']:.1f} s)",
          flush=True)
    # ... and the block overlay on the settled 100k state: one chunk's two
    # builds (the Newton solve's and the chunk's), then the overlay's
    blocks = os.path.join(LONG_DIR, "blocks.png")
    r = counted_run("cli_blocks", "planetmodel_sph_tpu_torch.cli",
                    ["run", "--restore", STATE, "--steps", "8",
                     "--diag-every", "8", "--render", blocks,
                     "--render-blocks", "--render-color-by", "material"])
    r.update(expect_launched=LONG_KERNELS, expect_filter=3,
             missing=_missing([blocks]))
    runs["cli_blocks"] = r
    print(f"  cli run --render-blocks (100k): launches {r['launches']} "
          f"(filter_sph 2 + 1 for the overlay) ({r['wall_s']:.1f} s)",
          flush=True)

    for r in runs.values():
        r.pop("out", None)
    rep = dict(runs=runs, reference=REFERENCE,
               total_s=time.perf_counter() - t_all)
    print(f"phase 8: {rep['total_s']:.1f} s", flush=True)
    return rep, long_horizon_failures(rep)


# ---------------------------------------------------------------------------
# phase 9: the replicated data-parallel path, each leg's ranks processes of
# their own
# ---------------------------------------------------------------------------

DP_DIR = os.path.join(OUT_DIR, "dp")
# (leg, ranks, device, windows widened by): world size 1 over NCCL, as the
# reference's CLI runs on a one-device host; then ranks that share the one
# card over gloo (NCCL refuses two ranks on one card), the card's stand-in
# for the reference's virtual CPU mesh, where a rank's G target groups
# differ from the NB source blocks. At 25,000 targets a rank the grouping
# drops a level (grouping.effective_level: 8^3 cells > 25,000 / 64), so a
# group may cross the level-3 cells the single set's never cross, and the
# production windows overflow (its near window most): the four-rank leg's
# windows are three times the production ones (capacities only: with
# nothing dropped the sums are the same)
DP_LEGS = (("dp1", 1, "cuda", 1.0), ("dp2", 2, "cuda:0", 1.0),
           ("dp4", 4, "cuda:0", 3.0))
# dp against one device (tests/test_parallel.py:161-164)
DP_RTOL, DP_ATOL = 2e-3, 2e-3
DP_TIMEOUT_S = 300        # one collective's longest wait in a phase-9 rank
DP_CLI = ["run", "--preset", "jupiter_3k", "--devices", "2", "--steps",
          "64", "--diag-every", "32"]
DP_CLI_INDIVISIBLE = ["run", "--device", "cpu", "--n", "511", "--devices",
                      "2", "--steps", "2"]


def morton_order(pos):
    """The particles' order along the Morton curve of the cubic box about
    them, as the reference's ``halo.morton_shard_state`` sorts a state
    before cutting its shards."""
    import torch
    from planetmodel_sph_tpu_torch.ops import morton
    lo = pos.amin(0)
    hi = lo + (pos.amax(0) - lo).max()
    return torch.sort(morton.encode(pos, lo, hi), stable=True).indices


def dp_rank(mesh, work, steps, record, widen):
    """One rank of a phase-9 leg: the settled state's shard, one warm-up
    chunk, then `steps` steps of ``dp.make_run_info`` from the shard timed
    between two collectives, the launch counts reset just before and read
    just after. On more than one rank the state's rows are first put in
    Morton order, so each rank's targets are a compact part of the planet
    (in the file's order a rank's targets are a random subset, each group
    of 64 spans a larger extent and the production windows overflow).
    The windows are widened by `widen`. Rank 0 with `record` keeps the four kernels' inputs of its first
    evaluation (the last call of each up to the first pass 2: the chunk
    build's filter, the seed far force, the first near force's density
    and pass 2). Writes work/rank<r>.json; rank 0 also work/state.pt (the
    gathered pos and rho, back in the file's order) and work/inputs.pt."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import grouping
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    from planetmodel_sph_tpu_torch.parallel import dp, mesh as mesh_mod
    from planetmodel_sph_tpu_torch.runtime import snapshot
    from planetmodel_sph_tpu_torch.tools.rotating_l_check import widened
    state, cfg, _ = snapshot.load(STATE, device=mesh.device)
    cfg = widened(cfg, widen)
    order = None
    if mesh.size > 1:
        order = morton_order(state.pos)
        state = planet._permute_state(state, order)
    local = mesh_mod.shard_state(state, mesh)
    del state
    run = dp.make_run_info(cfg, mesh)
    run(local, cfg.rebuild_every)       # warm-up: libraries, allocations
    rec, orig = {}, {}
    if record and mesh.rank == 0:
        def spy(name, fn):
            def call(*a, **kw):
                out = fn(*a, **kw)
                if "pass2" not in rec:
                    rec[name] = (a, kw)
                return out
            return call
        orig = {k: getattr(gk2, k) for k in LONG_KERNELS}
        for k, fn in orig.items():
            setattr(gk2, k, spy(k, fn))

    def sync():
        mesh_mod.psum(torch.zeros((), device=mesh.device), mesh)
        torch.cuda.synchronize(mesh.device)

    sync()
    launch.reset_launches()
    t0 = time.perf_counter()
    out, info = run(local, steps)
    torch.cuda.synchronize(mesh.device)
    launches = dict(launch.LAUNCHES)
    sync()
    wall = time.perf_counter() - t0
    for k, fn in orig.items():
        setattr(gk2, k, fn)
    full = mesh_mod.gather_state(out, mesh)
    if order is not None:
        full = planet._permute_state(full, torch.argsort(order))
    bsz, lg = cfg.nbr_group_size, cfg.nbr_group_level
    rep = dict(rank=mesh.rank, backend=mesh.backend, device=str(mesh.device),
               wall_s=wall, launches=launches,
               expected=expected_launches(cfg, steps),
               info={k: int(v) for k, v in info.items()},
               groups=grouping.n_groups_static(local.n, bsz, lg),
               blocks=grouping.n_groups_static(cfg.n, bsz, lg),
               local_n=local.n)
    with open(os.path.join(work, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rep, f)
    if mesh.rank == 0:
        torch.save(dict(pos=full.pos.cpu(), rho=full.rho.cpu(),
                        non_finite=all_finite(full)),
                   os.path.join(work, "state.pt"))
        if rec:
            torch.save(rec, os.path.join(work, "inputs.pt"))


def dp_agreement(pos, rho, ref):
    """Entries of pos and rho outside the phase-9 bounds against `ref`
    (pos rtol DP_RTOL atol DP_ATOL, rho rtol DP_RTOL), and the largest
    errors."""
    dp_ = (pos.double() - ref["pos"].double()).abs()
    dr = (rho.double() - ref["rho"].double()).abs()
    return dict(
        pos_bad=int((dp_ > DP_ATOL + DP_RTOL * ref["pos"].double().abs())
                    .sum()),
        rho_bad=int((dr > DP_RTOL * ref["rho"].double().abs()).sum()),
        pos_max_abs_err=float(dp_.max()),
        rho_max_rel_err=float((dr / ref["rho"].double().abs()).max()))


def dp_leg(leg, d, device, widen, ref, ptxas):
    """One leg: its ranks started by ``parallel.mesh.spawn``, their files
    read back, the result held against `ref` and, at D > 1, the four
    kernels held against their plain versions on rank 0's inputs. Returns
    (report, {"pos", "rho"} of the gathered state, kernel case reports)."""
    import tempfile
    import torch
    from planetmodel_sph_tpu_torch.parallel import mesh as mesh_mod
    # the recorded inputs are some 100-400 MB: kept out of OUT_DIR
    work = tempfile.mkdtemp(prefix=f"psph_{leg}_")
    t0 = time.perf_counter()
    rep = dict(leg=leg, ranks=d, device=device, widen=widen)
    got, cases = None, []
    try:
        mesh_mod.spawn(dp_rank, d, device=device,
                       args=(work, STEPS, d > 1, widen),
                       timeout_s=DP_TIMEOUT_S)
        ranks = [json.load(open(os.path.join(work, f"rank{r}.json")))
                 for r in range(d)]
        st = torch.load(os.path.join(work, "state.pt"), weights_only=True)
        got = {"pos": st["pos"], "rho": st["rho"]}
        wall = max(r["wall_s"] for r in ranks)
        rep.update(
            backend=ranks[0]["backend"], wall_s=wall,
            steps_per_s=STEPS / wall, rank_launches=[r["launches"]
                                                     for r in ranks],
            launches={k: sum(r["launches"][k] for r in ranks)
                      for k in ranks[0]["launches"]},
            expected=ranks[0]["expected"], info=ranks[0]["info"],
            groups=ranks[0]["groups"], blocks=ranks[0]["blocks"],
            local_n=ranks[0]["local_n"], non_finite=st["non_finite"],
            **dp_agreement(got["pos"], got["rho"], ref))
        if d > 1:
            rec = torch.load(os.path.join(work, "inputs.pt"),
                             map_location="cuda:0", weights_only=True)
            rep["recorded"] = sorted(rec)
            for name in LONG_KERNELS:
                if name not in rec:
                    continue
                a, kw = rec[name]
                case = "@".join(filter(None, (MAIN_CASE.get(name), leg)))
                c = check_one(name, case, a, kw, ptxas)
                c["legs"] = [leg]
                cases.append(c)
            del rec
    except Exception as e:            # noqa: BLE001 - reported, exits 1
        rep["error"] = f"{type(e).__name__}: {e}"
        rep["traceback"] = traceback.format_exc()[-3000:]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rep["phase_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return rep, got, cases


def dp_cli_run(label, args, timeout=300):
    """``python -m planetmodel_sph_tpu_torch.cli ARGS`` from the root:
    dict(rc, wall_s, lines), its output in DP_DIR/<label>.log."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "planetmodel_sph_tpu_torch.cli",
                        *args], cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=timeout)
    with open(os.path.join(DP_DIR, f"{label}.log"), "w") as f:
        f.write(r.stdout + "\n--- stderr\n" + r.stderr)
    return dict(args=args, rc=r.returncode, wall_s=time.perf_counter() - t0,
                lines=[ln for ln in r.stderr.splitlines() if any(
                    w in ln for w in ("clamped", "steps/s", "energy drift",
                                      "not divisible", "WARNING", "Error"))],
                err_tail=r.stderr[-1500:])


def dp_phase(card, main_ref, ptxas):
    """Phase 9: the dp path at D = 1 (NCCL) and D = 2, 4 (gloo ranks on
    the one card), each held against the single path's run (`main_ref`:
    its pos, rho, overflow, launches and steps/s), the four kernels on the
    shared-card legs' inputs, and the command line's --devices. Returns
    (report, failures, kernel case reports)."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    t_all = time.perf_counter()
    print(f"phase 9 (data parallel) on {card}", flush=True)
    legs, cases, first = {}, [], None
    for leg, d, device, widen in DP_LEGS:
        # D = 1 against the single path, the shared-card legs against D = 1
        ref = main_ref if first is None else first
        legs[leg], got, c = dp_leg(leg, d, device, widen, ref, ptxas)
        cases += c
        if leg == "dp1":
            first = got
        r = legs[leg]
        if "error" in r:
            print(f"  {leg}: FAILED {r['error']}", flush=True)
            continue
        print(f"  {leg} ({d} rank(s), {r['backend']} on {device}, windows "
              f"x{widen}): "
              f"{STEPS} steps in {r['wall_s']:.3f} s = "
              f"{r['steps_per_s']:.3f} steps/s (single path "
              f"{main_ref['steps_per_s']:.3f}); G = {r['groups']} target "
              f"groups a rank, NB = {r['blocks']} source blocks", flush=True)
        against = "the single path" if leg == "dp1" else "dp1"
        print(f"    launches, summed over the ranks: {r['launches']} "
              f"(single path {main_ref['launches']}); overflow "
              f"{r['info']}; against {against}"
              f": pos max abs err {r['pos_max_abs_err']:.3e}, rho max rel "
              f"err {r['rho_max_rel_err']:.3e}, outside the bounds "
              f"{r['pos_bad']} / {r['rho_bad']}", flush=True)
    cli = dp_cli_run("cli_devices", DP_CLI)
    cli_bad = dp_cli_run("cli_indivisible", DP_CLI_INDIVISIBLE)
    for label, r in (("cli --devices 2", cli), ("cli --n 511", cli_bad)):
        print(f"  {label}: exit {r['rc']}; {'; '.join(r['lines'])} "
              f"({r['wall_s']:.1f} s)", flush=True)
    rep = dict(legs=legs, cli=cli, cli_indivisible=cli_bad,
               single=dict(steps_per_s=main_ref["steps_per_s"],
                           launches=main_ref["launches"],
                           overflow=main_ref["overflow"]),
               cases=[{k: c[k] for k in ("name", "case", "ok", "legs",
                                         "max_abs_err", "shapes", "shares")}
                      for c in cases],
               total_s=time.perf_counter() - t_all)
    print(f"phase 9: {rep['total_s']:.1f} s", flush=True)
    return rep, dp_failures(rep), cases


def dp_failures(rep):
    """What phase 9's report `rep` fails: a leg that raised; a rank whose
    launches are not the single path's count for its steps, or a kernel of
    the path not launched; overflow; non-finite fields; pos or rho outside
    the bounds; a shared-card leg whose target groups equal the source
    blocks; a kernel case that disagrees with its plain version or is
    missing; the command line's exit codes and lines."""
    fails = []
    if any(rep["single"]["overflow"].values()):
        fails.append(f"phase 9: the single path overflowed "
                     f"{rep['single']['overflow']}")
    for leg, d, _, _ in DP_LEGS:
        r = rep["legs"].get(leg)
        if r is None or "error" in r:
            fails.append(f"phase 9 {leg}: {None if r is None else r['error']}")
            continue
        for k, rl in enumerate(r["rank_launches"]):
            want = dict.fromkeys(rl, 0)
            want.update(r["expected"])
            if rl != want:
                fails.append(f"phase 9 {leg} rank {k}: launches {rl} != "
                             f"{want}")
        idle = [k for k in LONG_KERNELS if not r["launches"].get(k)]
        if idle:
            fails.append(f"phase 9 {leg}: no launch of {idle}")
        if any(r["info"].values()):
            fails.append(f"phase 9 {leg}: overflow {r['info']}")
        if r["non_finite"]:
            fails.append(f"phase 9 {leg}: non-finite {r['non_finite']}")
        if r["pos_bad"] or r["rho_bad"]:
            fails.append(f"phase 9 {leg}: {r['pos_bad']} pos and "
                         f"{r['rho_bad']} rho entries outside rtol "
                         f"{DP_RTOL} atol {DP_ATOL}")
        if d > 1 and r["groups"] == r["blocks"]:
            fails.append(f"phase 9 {leg}: G == NB ({r['groups']})")
    want = {(n, leg[0]) for n in LONG_KERNELS for leg in DP_LEGS
            if leg[1] > 1}
    seen = {(c["name"], c["legs"][0]) for c in rep["cases"]}
    if want - seen:
        fails.append(f"phase 9: kernel cases not checked "
                     f"{sorted(want - seen)}")
    for c in rep["cases"]:
        if not c["ok"]:
            fails.append(f"phase 9 {c['name']} [{c['case']}]: disagrees "
                         "with its plain version")
    c = rep["cli"]
    text = "\n".join(c["lines"])
    if c["rc"] != 0 or "clamped to 1" not in text or "(dp x1)" not in text \
            or "energy drift" not in text:
        fails.append(f"phase 9 cli --devices 2: exit code {c['rc']}, lines "
                     f"{c['lines']}: {c.get('err_tail', '')[-300:]}")
    if rep["cli_indivisible"]["rc"] != 2:
        fails.append(f"phase 9 cli --n 511 --devices 2: exit code "
                     f"{rep['cli_indivisible']['rc']}, not 2")
    return fails


# ---------------------------------------------------------------------------
# phase 10: the halo layout (parallel/halo.py) through its tools, each run
# a process of its own; phase 11: the developer tools
# ---------------------------------------------------------------------------

HALO_DIR = os.path.join(OUT_DIR, "halo")
TOOLS_DIR = os.path.join(OUT_DIR, "tools")
TRACE_DIR = os.path.join(TOOLS_DIR, "trace")     # phase 11's trace_run
TOOLS_PKG = "planetmodel_sph_tpu_torch.tools."
# the halo step's kernels: the production set, and p2p (the collision's
# configuration leaves the fusion flags at False: an unfused near tier)
HALO_KERNELS = LONG_KERNELS + ("p2p",)
HALO_N = 32768            # the reference's 32k validation, 8 ranks, R = 3
HALO_DEBUG_N = 2048
HALO_STEPS = 2000         # leg 2: through approach and impact
# leg 2's windows times this (capacities only: where nothing overflows the
# sums are the same). At build_cfg's own windows the merged state
# overflows on the halo layout from step 1,500 on (9,809 SPH and 417 tree
# entries dropped over the 2,000 steps; at the end a rank's groups need up
# to 819 SPH sub-blocks of the 768), while one device runs the same
# trajectory at those windows without overflow: 4,096 targets a rank are
# grouped at level 2 (grouping.effective_level), one device's 32,768 at
# level 3, so a rank's groups span more. The reference never reached the
# impact (its 32k leg 2 never ran, its 8k one stopped at step 200).
HALO_LEG2_WIDEN = 2.0
HALO_SEGMENT = 100        # its segments (the tool's default)
HALO_RANKS = 8
# leg 1's position gate (|dpos| p99 <= HALO_POS_GATE * scale) and the
# tool's own |dvel| p99 bar, which the reference's 32k run fails too
HALO_POS_GATE = 1e-3
HALO_DVEL_BAR = 1e-2
# the reference's 32k leg 1 (docs/results/halo32k/leg1.log), printed
# beside this run's, never in its place
REFERENCE_HALO = dict(dpos_p99=0.0193, dpos_max=0.121, scale=67.7,
                      dvel_p99=0.0274, dvel_max=0.189, frac_off=0.0013,
                      viol_per_segment=808)
# the halo layout on the one card: --devices 8 clamps to 1 rank, and a
# ring of radius 1 over 1 rank would collect the rank itself: refused
HALO_CLI = ["run", "--n", "4096", "--neighbor", "grid", "--gravity", "tree",
            "--devices", "8", "--steps", "2", "--set", "dp_mode=halo"]


def single_device_leg2(ball_path):
    """Leg 2's start (the settled ball, two copies approaching, primed, as
    ``tools.halo_collision`` builds it) run on one device for HALO_STEPS
    steps in HALO_SEGMENT-step segments: the overflow counters of each."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.tools import halo_collision as hc
    from planetmodel_sph_tpu_torch.utils import checkpoint
    cfg = hc.build_cfg(HALO_N)
    ball, _, _ = checkpoint.load(ball_path, device="cuda")
    st = planet.prime(hc.two_body(ball, 60.0, 0.6), cfg)
    over = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HALO_STEPS // HALO_SEGMENT):
        st, info = planet.run_info(st, cfg, HALO_SEGMENT)
        over.append([int(info["nbr_overflow"]), int(info["tree_overflow"])])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    first = next(((k + 1) * HALO_SEGMENT for k, o in enumerate(over)
                  if any(o)), None)
    del st, ball
    torch.cuda.empty_cache()
    return dict(steps=HALO_STEPS, overflow=over, first_overflow_step=first,
                finite=True, wall_s=wall, steps_per_s=HALO_STEPS / wall)


def _lines_with(out, *words):
    return [ln for ln in out.splitlines() if any(w in ln for w in words)]


def halo_phase(card, ptxas):
    """Phase 10: settle_ball, halo_collision (8 gloo ranks on the card,
    rank 0 recording the kernels' inputs, each then held against its plain
    version), halo_debug and the command line's refusal of a ring that
    would collect the one rank itself. Returns (report, failures, kernel
    case reports)."""
    import tempfile
    import torch
    shutil.rmtree(HALO_DIR, ignore_errors=True)
    os.makedirs(HALO_DIR)
    t_all = time.perf_counter()
    print(f"phase 10 (the halo layout) on {card}", flush=True)
    runs, cases = {}, []

    # a. leg 0: the n/2 ball, settled on the card
    ball = os.path.join(HALO_DIR, "ball.psph")
    r = counted_run("settle_ball", TOOLS_PKG + "settle_ball",
                    ["--n", str(HALO_N), "--out", ball], timeout=600,
                    logdir=HALO_DIR)
    r.update(expect_launched=LONG_KERNELS, lines=_lines_with(
        r["out"], "settled", "occupancy", "probe", "ball ->"),
        saved=os.path.exists(ball))
    runs["settle_ball"] = r
    print(f"  settle_ball --n {HALO_N}: exit {r['rc']}; "
          f"{'; '.join(r['lines'])}; launches {r['launches']} "
          f"({r['wall_s']:.1f} s)", flush=True)

    # b. the collision: leg 1 (both layouts, 64 steps) and leg 2
    cdir = os.path.join(HALO_DIR, "collision")
    work = tempfile.mkdtemp(prefix="psph_halo_")
    rec = os.path.join(work, "inputs.pt")
    try:
        r = counted_run("halo_collision", TOOLS_PKG + "halo_collision",
                        ["--n", str(HALO_N), "--ball-ck", ball, "--device",
                         "cuda:0", "--steps", str(HALO_STEPS),
                         "--leg2-widen", str(HALO_LEG2_WIDEN), "--out",
                         cdir, "--record-inputs", rec], timeout=900,
                        logdir=HALO_DIR)
        spath = os.path.join(cdir, "summary.json")
        s = json.load(open(spath)) if os.path.exists(spath) else None
        seg_viol = [int(ln.rsplit("viol=", 1)[1]) for ln in
                    r["out"].splitlines() if ln.startswith("leg1 seg")]
        r.update(summary=s, leg1_viol=seg_viol, lines=_lines_with(
            r["out"], "ranks up", "leg1", "leg2", "re-shard", "persist"))
        runs["halo_collision"] = r
        if os.path.exists(rec):
            inputs = torch.load(rec, map_location="cuda:0",
                                weights_only=True)
            r["recorded"] = sorted(inputs)
            for name in HALO_KERNELS:
                if name in inputs:
                    a, kw = inputs[name]
                    c = check_one(name, "halo32k", a, kw, ptxas)
                    c["legs"] = ["halo"]
                    cases.append(c)
            del inputs
    finally:
        shutil.rmtree(work, ignore_errors=True)
    s = r.get("summary") or {}
    print(f"  halo_collision --n {HALO_N} (8 gloo ranks on cuda:0): exit "
          f"{r['rc']} ({r['wall_s']:.1f} s)", flush=True)
    for ln in r["lines"]:
        print(f"    {ln}", flush=True)
    if s:
        ref = REFERENCE_HALO
        print(f"    leg 1: |dpos| p99 {s['dpos_p99']:.4g} of scale "
              f"{s['scale']:.4g} (gate {HALO_POS_GATE:g} x scale; "
              f"reference {ref['dpos_p99']:g} of {ref['scale']:g}), |dvel| "
              f"p99 {s['dvel_p99']:.4g} (reference {ref['dvel_p99']:g}; the "
              f"tool's bar {HALO_DVEL_BAR:g}), share off by more than 1e-3 "
              f"scale {s['frac_off']:.4g} (reference {ref['frac_off']:g}), "
              f"violations a segment {r['leg1_viol']} (reference "
              f"{ref['viol_per_segment']}), pair_duplicates "
              f"{s['pair_duplicates']}, overflow {s['leg1_overflow']}, "
              f"{s['leg1_wall_s']:.1f} s", flush=True)
        print(f"    leg 2 (windows x{s['leg2_widen']:g}, capacities: see "
              f"HALO_LEG2_WIDEN): {s['steps']} steps, finite "
              f"{s['leg2_finite']}, "
              f"overflow {s['leg2_overflow']}, re-shards {s['reshards']}, "
              f"violations {s['halo_violations']}, energy_rel_change "
              f"{s['energy_rel_change']:.4g}, momentum_max "
              f"{s['momentum_max']:.4g}, {s['leg2_steps_per_s']:.3f} "
              f"steps/s (8 ranks time-slice one card, gloo stages every "
              f"collective through host memory: no scaling number)",
              flush=True)
        print(f"    launches summed over the ranks: {s['launches']}; the "
              f"main process (leg 0 load, prime) {r['launches']}",
              flush=True)

    # b2. the same two-body state on one device through leg 2's steps:
    # where the configuration's windows stop holding the merger, apart
    # from the layout
    runs["single"] = r = single_device_leg2(ball)
    print(f"  one device, the same two-body state, {r['steps']} steps: "
          f"overflow (nbr, tree) by {HALO_SEGMENT}-step segment "
          f"{r['overflow']}, first at step {r['first_overflow_step']}; "
          f"{r['steps_per_s']:.1f} steps/s ({r['wall_s']:.1f} s)",
          flush=True)

    # c. halo_debug at 2048: occupancy, then 8 segments of both layouts
    r = counted_run("halo_debug", TOOLS_PKG + "halo_debug",
                    [str(HALO_DEBUG_N)], timeout=600, logdir=HALO_DIR)
    r.update(lines=_lines_with(r["out"], "occupancy", "seg ", "finite"))
    runs["halo_debug"] = r
    print(f"  halo_debug {HALO_DEBUG_N}: exit {r['rc']} "
          f"({r['wall_s']:.1f} s)", flush=True)
    for ln in r["lines"]:
        print(f"    {ln}", flush=True)

    # d. the command line on the one card: refused by name
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "planetmodel_sph_tpu_torch.cli",
                        *HALO_CLI], cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=300)
    with open(os.path.join(HALO_DIR, "cli.log"), "w") as f:
        f.write(p.stdout + "\n--- stderr\n" + p.stderr)
    r = dict(args=HALO_CLI, rc=p.returncode, wall_s=time.perf_counter() - t0,
             lines=_lines_with(p.stderr, "clamped", "2R >= D"))
    runs["cli"] = r
    print(f"  cli {' '.join(HALO_CLI)}: exit {r['rc']}; "
          f"{'; '.join(r['lines'])} ({r['wall_s']:.1f} s)", flush=True)

    for r in runs.values():
        r.pop("out", None)
    rep = dict(runs=runs, reference=REFERENCE_HALO,
               cases=[{k: c[k] for k in ("name", "case", "ok", "legs",
                                         "max_abs_err", "shapes", "shares")
                       if k in c} for c in cases],
               total_s=time.perf_counter() - t_all)
    print(f"phase 10: {rep['total_s']:.1f} s", flush=True)
    return rep, halo_failures(rep), cases


def halo_failures(rep):
    """What phase 10's report fails: a run's exit code (halo_collision
    may exit 2 only when the tool's |dvel| bar is the one thing it
    misses); leg 1 non-finite, overflowing or outside the position gate;
    leg 2 non-finite or overflowing; a halo kernel not launched on a leg
    or disagreeing with its plain version; halo_debug's lines; the
    command line not refusing the ring by name."""
    fails = []
    runs = rep["runs"]
    r = runs["settle_ball"]
    if r["rc"] != 0 or not r["saved"]:
        fails.append(f"phase 10 settle_ball: exit {r['rc']}, ball saved "
                     f"{r['saved']}: {r.get('err_tail', '')[-300:]}")
    idle = [k for k in r["expect_launched"] if not r["launches"].get(k)]
    if idle:
        fails.append(f"phase 10 settle_ball: no launch of {idle}")
    r = runs["halo_collision"]
    s = r.get("summary")
    if not s:
        fails.append(f"phase 10 halo_collision: exit {r['rc']}, no summary: "
                     f"{r.get('err_tail', '')[-500:]}")
    else:
        pos_ok = s["dpos_p99"] <= HALO_POS_GATE * s["scale"]
        if not pos_ok:
            fails.append(f"phase 10 halo_collision: |dpos| p99 "
                         f"{s['dpos_p99']:.4g} > {HALO_POS_GATE:g} x scale "
                         f"{s['scale']:.4g}")
        only_dvel = pos_ok and s["dvel_p99"] > HALO_DVEL_BAR
        if r["rc"] not in ((0, 2) if only_dvel else (0,)):
            fails.append(f"phase 10 halo_collision: exit {r['rc']}")
        if any(v for leg in s["leg1_overflow"].values() for v in leg):
            fails.append(f"phase 10 leg 1 overflow {s['leg1_overflow']}")
        if any(s["leg2_overflow"]) or not s["leg2_finite"]:
            fails.append(f"phase 10 leg 2: overflow {s['leg2_overflow']}, "
                         f"finite {s['leg2_finite']}")
        for leg in ("leg1_replicated", "leg1_halo", "leg2"):
            idle = [k for k in HALO_KERNELS if not s["launches"][leg][k]]
            if idle:
                fails.append(f"phase 10 {leg}: no launch of {idle}")
        if len(r["leg1_viol"]) != 8:
            fails.append(f"phase 10 leg 1: {len(r['leg1_viol'])} segments")
    seen = {c["name"] for c in rep["cases"]}
    if set(HALO_KERNELS) - seen:
        fails.append(f"phase 10: kernel cases not checked "
                     f"{sorted(set(HALO_KERNELS) - seen)}")
    for c in rep["cases"]:
        if not c["ok"]:
            fails.append(f"phase 10 {c['name']} [{c['case']}]: disagrees "
                         "with its plain version")
    r = runs["halo_debug"]
    segs = [ln for ln in r["lines"] if ln.startswith("seg ")]
    if r["rc"] != 0 or len(segs) != 8 or not all(
            ln.count("finite=True") == 2 for ln in segs) or not any(
            "occupancy (unbounded)" in ln for ln in r["lines"]):
        fails.append(f"phase 10 halo_debug: exit {r['rc']}, lines "
                     f"{r['lines']}: {r.get('err_tail', '')[-300:]}")
    r = runs["cli"]
    if r["rc"] == 0 or not any("2R >= D" in ln and "halo_ring_radius" in ln
                               for ln in r["lines"]):
        fails.append(f"phase 10 cli: exit {r['rc']}, lines {r['lines']}")
    return fails


# phase 11: each developer tool at one small setting, (module, arguments,
# the lines it must print)
A8_TOOLS = (
    ("profile_build", ["--ck", STATE, "--k", "4"],
     ("build (full)", "morton encode+argsort", "cell_groups (incl sort)",
      "block stats + [G,NB] geometry", "_compact_rows")),
    ("scaling_bench", ["--dense-n", "3000,10000", "--grid-n",
                       "30000,100000", "--steps", "100"],
     ("'n': 3000, 'pipeline': 'dense+direct",
      "'n': 10000, 'pipeline': 'dense+direct",
      "'n': 30000, 'pipeline': 'grid+tree", "'n': 100000")),
    ("neighbors_of", ["--restore", STATE, "--particle", "12345",
                      "--max-print", "5"],
     ("dense oracle:", "window pipeline: group",
      "OK: window candidates cover the oracle exactly")),
    ("span_stats", ["--ck", STATE],
     ("SPH exact window (particle ids):", "P2P window (sub-block ids):",
      "M2P ring window (sub-block ids):")),
    ("ksweep", ["--sub", "32", "--k", "16"], ("sub=32 K=16:",)),
    ("ksweep2", ["--var", "r3ship"], ("r3ship      :",)),
    ("micro_gather", [], ("packed [132288,6] row-gather -> [2067,512]",
                          "same, Morton-local ids",
                          "take_along_axis [2067,5120]->[,512] x6",
                          "entry-gather [4134,160] (640B rows)")),
    # the trace and stage tools: the reference's stage labels, a traced
    # production chunk and its device time by category
    ("profile_block", ["--ck", STATE, "--k", "4"],
     ("n=100000  bsz=64", "groups=2067")),
    ("trace_run", ["--ck", STATE, "--steps", "16", "--out", TRACE_DIR],
     ("warm:", "trace ->", "total device self time:",
      "of the traced window", "of the untraced run")),
    ("trace_summary", [TRACE_DIR, "--by-category"],
     ("total device self time:", "of the traced window",
      "of the untraced run")),
)
# the stage labels of the reference's tools/profile_block.py, each of
# which must begin a line of the port's
PROFILE_BLOCK_STAGES = (
    "forces (full)", "build", "prep (sorts)", "sph rows gather (geom x5)",
    "window gather (p2p geom x5)", "h-solve (newton, throwaway build)",
    "pass1 kernel", "pass2 kernel", "p2p kernel",
    "unsort (inverse-perm gather x3)")


def trace_categories(lines):
    """(total ms, {category: ms}) of ``trace_summary --by-category``'s
    printout."""
    import re
    total, cats = None, {}
    for ln in lines:
        m = re.match(r"total device self time: ([\d.]+) ms", ln)
        if m:
            total = float(m.group(1))
        m = re.match(r"\s*([\d.]+) ms\s+[\d.]+%\s+(.+)$", ln)
        if m:
            cats[m.group(2)] = float(m.group(1))
    return total, cats


def tools_a8_checks(name, lines):
    """What phase 11 holds beyond a tool's lines: every stage label of the
    reference's profile_block beginning a line, with a finite checksum;
    trace_summary's eight categories summing to its total (each rounded
    to 1e-3 ms), with device time and hand kernels in it."""
    import re
    if name == "profile_block":
        bad = []
        for label in PROFILE_BLOCK_STAGES:
            hit = [ln for ln in lines if ln.startswith(label + " ")]
            m = hit and re.search(r"checksum (\S+)\)", hit[0])
            if not m or not math.isfinite(float(m.group(1))):
                bad.append(label)
        return [f"stages missing or not finite: {bad}"] if bad else []
    if name == "trace_summary":
        total, cats = trace_categories(lines)
        if total is None or len(cats) != 8 or not total > 0 \
                or not cats.get("hand kernels", 0) > 0 \
                or abs(sum(cats.values()) - total) > 1e-3 * len(cats):
            return [f"categories {cats} against the total {total} ms"]
    return []


def tools_a8_phase(card):
    """Phase 11: the developer tools at one setting each (README's
    commands), each tool's ``main`` called in this process (a process of
    its own would cost its start-up again) with its printed lines captured
    and its launches counted from 0. Returns (report, failures)."""
    import contextlib
    import importlib
    import io
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    t_all = time.perf_counter()
    print(f"phase 11 (developer tools) on {card}", flush=True)
    runs = {}
    for name, args, want in A8_TOOLS:
        mod = importlib.import_module(TOOLS_PKG + name)
        buf = io.StringIO()
        torch.cuda.synchronize()
        launch.reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = mod.main(args)
            err = None
        except Exception as e:          # noqa: BLE001 - reported, fails
            rc, err = 1, f"{type(e).__name__}: {e}"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        with open(os.path.join(TOOLS_DIR, f"{name}.log"), "w") as f:
            f.write(text + (f"\n--- error\n{err}\n" if err else ""))
        lines = [ln for ln in text.splitlines() if ln.strip()]
        missing = [w for w in want if not any(w in ln for ln in lines)]
        r = dict(args=[name, *args], rc=rc, error=err, wall_s=wall,
                 launches={k: v for k, v in launch.LAUNCHES.items() if v},
                 lines=lines[-24:], missing=missing)
        runs[name] = r
        print(f"  {name} {' '.join(args)}: exit {rc}, launches "
              f"{r['launches']} ({wall:.1f} s)", flush=True)
        for ln in lines[-12:]:
            print(f"    {ln}", flush=True)
        r["failed_lines"] = [ln for ln in lines if "FAILED" in ln]
        r["failed_lines"] += tools_a8_checks(name, lines)
        torch.cuda.empty_cache()
    trace = os.path.join(TRACE_DIR, "trace.json")
    if os.path.exists(trace):
        # tens of MB with its Python stacks: its summary stays in the logs
        runs["trace_run"]["trace_mb"] = os.path.getsize(trace) / 2**20
        os.remove(trace)
    rep = dict(runs=runs, total_s=time.perf_counter() - t_all)
    print(f"phase 11: {rep['total_s']:.1f} s", flush=True)
    return rep, tools_a8_failures(rep)


def tools_a8_failures(rep):
    """What phase 11's report fails: a tool missing from it, one that
    raised or exited non-zero, a line it did not print, a variant it
    reports FAILED."""
    fails = []
    for name, _, _ in A8_TOOLS:
        r = rep["runs"].get(name)
        if r is None:
            fails.append(f"phase 11 {name}: not run")
        elif r["rc"] != 0 or r["missing"] or r["failed_lines"]:
            fails.append(f"phase 11 {name}: exit {r['rc']}, missing "
                         f"{r['missing']}, {r['failed_lines']}: "
                         f"{r['error']}")
    return fails

def mark(phase, t_all):
    """Print when a phase starts, in seconds since the run's start."""
    print(f"phase {phase} starts {time.perf_counter() - t_all:.1f} s into "
          "the run", flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of another commit (e.g. unpacked with "
                    "git archive into a git-ignored directory): its "
                    "redesigned and all-pairs kernels are timed in turns "
                    "with this one's in phase 4, and phase 7 compares the "
                    "two checkouts' production, sym100k and sg100k steps")
    ap.add_argument("--halo-only", action="store_true",
                    help="a trial of phases 10 and 11 alone after the "
                    "build (no kernel line, no final line)")
    ap.add_argument("--only", default=None, metavar="KERNEL[,KERNEL]",
                    help="a trial of phases 1-4 on these windowed kernels' "
                    "cases alone, with --parent in turns too (no kernel "
                    "line, no final line)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this run needs a "
                    "CUDA card")
    try:
        from planetmodel_sph_tpu_torch.models import planet
        from planetmodel_sph_tpu_torch.ops.cuda import build
        from planetmodel_sph_tpu_torch.ops.cuda import launch
        from planetmodel_sph_tpu_torch.runtime import snapshot
        from planetmodel_sph_tpu_torch.utils import diagnostics
    except ImportError as e:
        return fail(f"the port's package is not importable: {e}")
    if not os.path.exists(STATE):
        return fail(f"settled state missing: {STATE}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    t_all = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        return fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    report["card"] = card
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build (with --only of the all-pairs kernels, theirs alone)
    only = set(args.only.split(",")) if args.only else None
    pairs_only = only is not None and only <= set(ALL_PAIRS)
    t0 = time.perf_counter()
    try:
        logs = build.build_all(ALL_PAIRS if pairs_only else None, force=True)
    except RuntimeError as e:
        return fail(str(e))
    t_build = time.perf_counter() - t0
    report["build_s"] = t_build
    print(f"build: {len(logs)} kernels in {t_build:.2f} s", flush=True)
    built = set(ALL_PAIRS) if pairs_only else set(KERNELS)
    if set(logs) != built:
        return fail(f"built {sorted(logs)}, expected {sorted(built)}")
    for n, (_, log) in logs.items():
        # one line per source: its entry points, the most registers any of
        # them uses, and the spill reports that are not all zero
        lines = [ln.strip() for ln in log.splitlines()]
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln and "registers" in ln]
        spills = [ln for ln in lines if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"  ptxas {n}: {len(regs)} entry points, at most "
              f"{max(regs, default=0)} registers, {len(spills)} with "
              "spills", flush=True)
        for ln in spills:
            print(f"    {ln}", flush=True)
    parent_libs = parent_pw = None
    sass_fails = []
    in_turns = ALL_PAIRS if pairs_only else \
        REDESIGNED + ALL_PAIRS + ("probe_pass1_tile",)
    if args.parent:
        # the other checkout's kernels, built into its own directory
        parent = os.path.abspath(args.parent)
        pkg = os.path.join(parent, "planetmodel_sph_tpu_torch")
        pout = os.path.join(pkg, "build")
        t0 = time.perf_counter()
        # the all-pairs kernels are timed through the other checkout's own
        # wrappers; any other kernel whose C interface changed since cannot
        # be called through this checkout's wrapper
        psig = parent_signatures(parent)
        changed = [n for n in in_turns if n not in ALL_PAIRS
                   and psig.get(n) != build.SIGNATURES[n]]
        if changed:
            print(f"the parent's {', '.join(changed)}: another C interface, "
                  "not timed in turns", flush=True)
        in_turns = tuple(n for n in in_turns if n not in changed)
        try:
            # filter_sph also for its SASS, whatever its C interface
            build.build_all(sorted({*in_turns, *(
                () if pairs_only else ("filter_sph",))}), force=True,
                src=os.path.join(pkg, "csrc"), out=pout)
        except RuntimeError as e:
            return fail(f"the parent's kernels: {e}")
        parent_libs = {n: build.lib_path(n, pout) for n in in_turns}
        if not pairs_only:
            report["filter_sass"], sass_fails = sass_against_parent(
                build.lib_path("filter_sph", pout))
        parent_pw = dict(libs=parent_libs, sigs=psig,
                         module=parent_pairwise(parent))
        print(f"build of the parent's {', '.join(in_turns)}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {}
    for n in (ALL_PAIRS if pairs_only else
              REDESIGNED + ALL_PAIRS + ("probe_pass1_tile",)):
        # every instance of the redesigned kernels, by template arguments
        for inst in ptxas_instances(logs[n][1]):
            # the all-pairs sources' other entry points (the plan's keys,
            # the stages, the reduces) apart from their sweeps' instances
            sweep = n not in ALL_PAIRS or f"{n}_kernel" in inst["entry"]
            ptxas[(n, inst["args"] if sweep else inst["entry"])] = inst
            print(f"  ptxas {n}{list(inst['args']) if inst['args'] else ''}"
                  f": {inst['regs']} registers, {inst['smem']} B shared, "
                  f"{inst['stack']} B stack, spills {inst['spill_stores']}/"
                  f"{inst['spill_loads']} B", flush=True)
    report["ptxas"] = [dict(name=k[0], **v) for k, v in ptxas.items()]
    if pairs_only:
        # phase 4 for the all-pairs kernels alone, and the plan's sizes
        failures = []
        report["pairwise_cases"] = []
        for n, _ in DENSE_RUNS:
            r, fails = check_pairwise(n, parent_pw, ptxas)
            failures += fails
            report["pairwise_cases"] += r["cases"]
        report["plan_sizes"] = [plan_times(n, parent_pw)
                                for n in PLAN_SIZES]
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_only.json"), "w") as f:
            json.dump(report, f, indent=1)
        for m in failures:
            print(f"FAIL: {m}", file=sys.stderr, flush=True)
        print(f"total {time.perf_counter() - t_all:.1f} s (phases 1, 2 and "
              f"4 on {', '.join(sorted(only))} only)", flush=True)
        return 1 if failures else 0
    # the tile probe's sweep loops in SASS: instructions a live pair
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           build.lib_path("probe_pass1_tile")],
                          capture_output=True, text=True).stdout
    report["tile_sass"] = sass_pair_loops(sass)
    for fn, loops in report["tile_sass"].items():
        print(f"  sass {fn}: " + ", ".join(
            f"{'exact' if exact else 'in-range'} {per:.1f}"
            for per, exact in loops) + " instructions a live pair",
            flush=True)
    if not any(report["tile_sass"].values()):
        return fail("no sweep loop found in probe_pass1_tile's SASS")

    if args.halo_only:
        failures = []
        report["halo"], fails, _ = halo_phase(card, ptxas)
        failures += fails
        report["tools_a8"], fails = tools_a8_phase(card)
        failures += fails
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_halo.json"), "w") as f:
            json.dump(report, f, indent=1)
        for m in failures:
            print(f"FAIL: {m}", file=sys.stderr, flush=True)
        print(f"total {time.perf_counter() - t_all:.1f} s (phases 1, 2, "
              "10 and 11 only)", flush=True)
        return 1 if failures else 0

    # 3. load
    t0 = time.perf_counter()
    state, cfg, step0 = snapshot.load(STATE, device="cuda")
    torch.cuda.synchronize()
    print(f"load: n={state.n} step={step0} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 4. kernels against their plain versions
    seen = capture_inputs(state, cfg)
    torch.cuda.synchronize()
    kreports, failures = check_kernels(seen, ptxas, parent_libs, only)
    failures += sass_fails
    if only is None:
        report["stream_checks"], fails = stream_checks(seen)
        failures += fails
    prod_twin = [bf16_case("gravity_fused", "far_only",
                           *seen["gravity_fused"])]
    del seen
    torch.cuda.empty_cache()
    # the settle phase's start: a raw polytrope at the same n, primed
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics
    settle_cfg = config_mod.jupiter_100k(**SETTLE_KW)
    settle_state = planet.prime(ics.polytrope(settle_cfg), settle_cfg.replace(
        rebuild_every=1))
    # sym100k's start: the settled state's force fields evaluated again
    # under that configuration
    sym_cfg = cfg.replace(**SYM_KW)
    sym_state = planet.prime(state, sym_cfg.replace(rebuild_every=1,
                                                    respa_every=1))
    # adia100k's start: the settled state with its internal energy set
    # from the polytropic relation (a polytropic run never updates u),
    # primed under the adiabatic EOS; sg100k's: sym100k's (the force
    # fields do not depend on the far tier's partition beyond the MAC's
    # error); basalt100k's: the impact's initial conditions, primed
    from planetmodel_sph_tpu_torch import bench as bench_mod
    adia_cfg = cfg.replace(**ADIA_KW)
    adia_state = planet.prime(
        bench_mod.with_thermal_state(state, cfg, adia_cfg),
        adia_cfg.replace(rebuild_every=1, respa_every=1))
    sg_cfg = cfg.replace(**SYM_KW, **SG_KW)
    sg_state = planet.prime(state, sg_cfg.replace(rebuild_every=1,
                                                  respa_every=1))
    basalt_cfg, basalt_state = basalt_start(grid=True)
    # exact100k's start: the settled state primed under the exact lists
    exact_cfg = cfg.replace(**EXACT_KW)
    exact_state = planet.prime(state, exact_cfg.replace(rebuild_every=1,
                                                        respa_every=1))
    mode_reports, fails = check_modes(itertools.chain(
        prod_twin, with_bf16_twins(itertools.chain(
            mode_cases(state, cfg, sym_state, settle_state, settle_cfg),
            energy_cases(cfg, adia_state, sg_state, basalt_cfg,
                         basalt_state),
            exact_cases(cfg, exact_state), group_size_cases(cfg, state)))),
        ptxas, parent_libs, only)
    del prod_twin
    failures += fails
    report["kernel_modes"] = mode_reports
    if only is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "chip_smoke_only.json"), "w") as f:
            json.dump(report, f, indent=1)
        for m in failures:
            print(f"FAIL: {m}", file=sys.stderr, flush=True)
        print(f"total {time.perf_counter() - t_all:.1f} s (phases 1-4 on "
              f"{', '.join(sorted(only))} only)", flush=True)
        return 1 if failures else 0
    torch.cuda.empty_cache()
    pw_reports = {}
    for n, _ in DENSE_RUNS:
        pw_reports[n], fails = check_pairwise(n, parent_pw, ptxas)
        failures += fails
    report["plan_sizes"] = [plan_times(n, parent_pw) for n in PLAN_SIZES]
    # the kernels line carries the all-pairs kernels at the default
    # preset's size; the larger size rides along under its own key
    n_main, n_big = DENSE_RUNS[0][0], DENSE_RUNS[1][0]
    for name in ("pairwise_pass1", "pairwise_pass2"):
        kreports[name] = pw_reports[n_main][name]
    report["kernels"] = kreports
    report["pairwise_cases"] = [c for r in pw_reports.values()
                                for c in r["cases"]]
    probe_reports, fails = check_probes(parent_libs)
    failures += fails
    report["probes"] = probe_reports

    mark("5", t_all)
    # 5. main path
    e0 = diagnostics.measure(state, cfg)
    p0 = momentum(state)
    expect = dict.fromkeys(launch.LAUNCHES, 0)
    expect.update(expected_launches(cfg, STEPS))
    torch.cuda.synchronize()
    launch.reset_launches()
    t0 = time.perf_counter()
    out, info = planet.run_info(state, cfg, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    bf16_launches = dict(launch.BF16_LAUNCHES)
    overflow = {k: int(v) for k, v in info.items()}
    e1 = diagnostics.measure(out, cfg)
    p1 = momentum(out)
    bad_fields = all_finite(out)
    de = float((e1["total_energy"] - e0["total_energy"])
               / abs(e0["total_energy"]))
    main = dict(steps=STEPS, wall_s=wall, steps_per_s=STEPS / wall,
                overflow=overflow, launches=launches, expected=expect,
                non_finite=bad_fields, momentum_before=p0,
                momentum_after=p1, rel_energy_change=de,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    report["main_path"] = main
    print(f"main path: {STEPS} steps in {wall:.3f} s = "
          f"{STEPS / wall:.3f} steps/s", flush=True)
    print(f"  overflow {overflow}", flush=True)
    print(f"  launches {launches} (expected {expect})", flush=True)
    print(f"  non-finite fields {bad_fields}", flush=True)
    print(f"  |sum m v| {p0:.6e} -> {p1:.6e}", flush=True)
    print(f"  total energy {float(e0['total_energy']):.8e} -> "
          f"{float(e1['total_energy']):.8e} (rel change {de:.3e})",
          flush=True)
    if any(overflow.values()):
        failures.append(f"overflow counters not 0: {overflow}")
    if launches != expect:
        failures.append(f"launch counts {launches} != {expect}")
    if any(bf16_launches.values()):
        failures.append(f"bf16 launches on the f32 path: {bf16_launches}")
    if bad_fields:
        failures.append(f"non-finite fields: {bad_fields}")
    if not abs(de) < 1e-2:
        failures.append(f"total energy moved by {de:.3e} in {STEPS} steps")
    main_out, main_wall = out, wall
    # phase 9 holds the dp path against this run
    main_ref = dict(pos=out.pos.cpu(), rho=out.rho.cpu(), overflow=overflow,
                    launches=launches, steps_per_s=STEPS / wall)
    del out
    torch.cuda.empty_cache()

    mark("5b", t_all)
    # 5b. the dense main path from its initial conditions
    dense_reports = {}
    for n, steps in DENSE_RUNS:
        dense_reports[n], fails = dense_main(n, steps)
        failures += fails
    report["dense_main_path"] = list(dense_reports.values())

    mark("5c", t_all)
    # 5c. the general grid + tree step
    leg_reports, fails = grid_legs(cfg, sym_state, settle_state, settle_cfg)
    failures += fails
    report["grid_legs"] = leg_reports

    # 5c'. the bfloat16 gravity pair path beside its f32 twins
    b_reports, fails = bf16_legs(cfg, state, sym_state)
    failures += fails
    report["bf16_legs"] = b_reports
    leg_reports = leg_reports + b_reports
    del settle_state, sym_state
    torch.cuda.empty_cache()

    # 5d. the energy equation and the supergroup far tier
    (sym_de,) = [r["rel_energy_change"] for r in leg_reports
                 if r["leg"] == "sym100k"]
    e_reports, fails = energy_legs(cfg, adia_state, sg_state, basalt_cfg,
                                   basalt_state, sym_de)
    failures += fails
    report["energy_legs"] = e_reports
    leg_reports = leg_reports + e_reports
    del sg_state, basalt_state
    torch.cuda.empty_cache()

    mark("5e", t_all)
    # 5e. the roofline and microbench tools: the probes' main path
    tools, fails = tools_phase(state, cfg, main_wall, card)
    failures += fails
    report["tools"] = tools

    # 5f. particle-exact lists, the unsorted chunk, the cached dense step
    s5_reports, fails = slice5_legs(cfg, state, main_out, exact_state)
    failures += fails
    report["slice5_legs"] = s5_reports
    leg_reports = leg_reports + s5_reports
    del main_out, exact_state
    torch.cuda.empty_cache()

    mark("5g", t_all)
    # 5g. cli run --debug-nans: a clean run's bits and a planted NaN
    report["debug_nans"], fails = debug_nans_phase(card)
    failures += fails

    mark("6", t_all)
    # 6. small-input agreement, card against CPU
    small = small_agreement(state, cfg)
    report["small_input"] = small
    print(f"small input (n={small['n']}, {small['steps']} steps, card vs "
          f"CPU): pos err {small['pos_max_abs_err']:.3e} rho err "
          f"{small['rho_max_abs_err']:.3e} overflow {small['overflow_gpu']}"
          f"/{small['overflow_cpu']} {'ok' if small['ok'] else 'MISMATCH'}",
          flush=True)
    if not small["ok"]:
        failures.append("card and CPU disagree on the small input")
    ssmall = small_agreement(state, cfg.replace(**SYM_KW), prime=True)
    report["sym_small_input"] = ssmall
    print(f"symmetric unfused small input (n={ssmall['n']}, "
          f"{ssmall['steps']} steps, card vs CPU): pos err "
          f"{ssmall['pos_max_abs_err']:.3e} rho err "
          f"{ssmall['rho_max_abs_err']:.3e} overflow "
          f"{ssmall['overflow_gpu']}/{ssmall['overflow_cpu']} "
          f"{'ok' if ssmall['ok'] else 'MISMATCH'}", flush=True)
    if not ssmall["ok"]:
        failures.append("card and CPU disagree on the symmetric unfused "
                        "small input")
    asmall = small_agreement(adia_state, adia_cfg, prime=True,
                             fields=("pos", "rho", "u"))
    report["adiabatic_small_input"] = asmall
    print(f"adiabatic small input (n={asmall['n']}, {asmall['steps']} "
          f"steps, card vs CPU): pos err {asmall['pos_max_abs_err']:.3e} "
          f"rho err {asmall['rho_max_abs_err']:.3e} u err "
          f"{asmall['u_max_abs_err']:.3e} overflow "
          f"{asmall['overflow_gpu']}/{asmall['overflow_cpu']} "
          f"{'ok' if asmall['ok'] else 'MISMATCH'}", flush=True)
    if not asmall["ok"]:
        failures.append("card and CPU disagree on the adiabatic small "
                        "input")
    del adia_state
    csmall = small_agreement(state, cfg, carry=True)
    report["carry_small_input"] = csmall
    print(f"cached-step API small input (n={csmall['n']}, init_carry + "
          f"{csmall['steps']} step_carry, card vs CPU): pos err "
          f"{csmall['pos_max_abs_err']:.3e} rho err "
          f"{csmall['rho_max_abs_err']:.3e} overflow "
          f"{csmall['overflow_gpu']}/{csmall['overflow_cpu']} "
          f"{'ok' if csmall['ok'] else 'MISMATCH'}", flush=True)
    if not csmall["ok"]:
        failures.append("card and CPU disagree on the step_carry small "
                        "input")
    dsmall = dense_small_agreement()
    report["dense_small_input"] = dsmall
    print(f"dense small input (n={dsmall['n']}, {dsmall['steps']} steps, "
          f"card vs CPU): pos err {dsmall['pos_max_abs_err']:.3e} rho err "
          f"{dsmall['rho_max_abs_err']:.3e} first-step count mismatches "
          f"{dsmall['first_step_count_mismatches']} neighbors_avg "
          f"{dsmall['neighbors_avg']:.1f} "
          f"{'ok' if dsmall['ok'] else 'MISMATCH'}", flush=True)
    if not dsmall["ok"]:
        failures.append("card and CPU disagree on the dense small input")

    # 7. with --parent: the two checkouts' production steps
    if args.parent:
        report["parent"], fails = parent_phase(args.parent, state, cfg)
        failures += fails

    mark("8", t_all)
    # 8. the long horizon: the drift gate and the validation tools, the
    # bench lines, rendering and the live viewer (this checkout only)
    del state
    torch.cuda.empty_cache()
    report["long_horizon"], fails = long_horizon_phase(card)
    failures += fails

    # 9. the replicated data-parallel path: D = 1 over NCCL, D = 2 and 4
    # ranks sharing the card over gloo
    report["dp"], fails, dp_cases = dp_phase(card, main_ref, ptxas)
    failures += fails

    # 10. the halo layout through its tools: the 32k collision on 8 gloo
    # ranks sharing the card, halo_debug, the command line's refusal
    report["halo"], fails, halo_cases = halo_phase(card, ptxas)
    failures += fails

    # 11. the developer tools
    report["tools_a8"], fails = tools_a8_phase(card)
    failures += fails

    report["total_s"] = time.perf_counter() - t_all
    report["failures"] = failures
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"total {report['total_s']:.1f} s", flush=True)
    if failures:
        for m in failures:
            print(f"FAIL: {m}", file=sys.stderr, flush=True)
        return 1

    print(card, flush=True)
    kernels = []
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")
    # a bf16 case's entry also carries its twin's timings in turns
    bf16_keys = ("bf16_vs_f32", "f32_ms_in_turns", "bf16_ms_in_turns",
                 "f32_device_ms", "bf16_device_ms")
    legs = {r["leg"]: r["launches"] for r in leg_reports}
    legs_bf16 = {r["leg"]: r.get("bf16_launches", {}) for r in leg_reports}

    def leg_launches(case_report, name):
        # launches of the legs whose own inputs this case was recorded on
        # (0 for an extra that only the kernel phase drives); a bf16 case
        # counts its legs' launches of the bf16 instance
        src = legs_bf16 if case_report["case"].endswith("+bf16") else legs
        return sum(src[leg][name] for leg in case_report["legs"])

    halo_sum = report["halo"]["runs"]["halo_collision"]["summary"]

    def add_dp_legs(entry, name):
        # the dp legs: their launches, summed over the ranks, and at D > 1
        # the kernel held against its plain version on rank 0's inputs;
        # the same for the halo collision's legs (phase 10)
        for leg, *_ in DP_LEGS:
            entry[leg] = dict(
                launches=report["dp"]["legs"][leg]["launches"][name])
            for c in dp_cases:
                if c["name"] == name and c["legs"] == [leg]:
                    entry[leg].update(case=c["case"],
                                      **{k: c[k] for k in keys},
                                      library_ms=None)
        entry["halo"] = dict(launches={
            leg: n[name] for leg, n in halo_sum["launches"].items()})
        for c in halo_cases:
            if c["name"] == name:
                entry["halo"].update(case=c["case"],
                                     **{k: c[k] for k in keys},
                                     library_ms=None)
        return entry

    for name, (source, replaces) in KERNELS.items():
        if name in PROBES:
            kernels.append(add_dp_legs(probe_entry(
                name, source, replaces, probe_reports, tools["launches"]),
                name))
            continue
        own = [r for r in mode_reports if r["name"] == name]
        if name in kreports:
            # the production path's (or the dense n = 3000 path's) case
            r, n_launch = kreports[name], launches[name]
        else:
            # pass1_sym and p2p: `sym100k`'s legs are their main path
            r, n_launch = own[0], leg_launches(own[0], name)
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=n_launch,
                     **{k: r[k] for k in keys}, library_ms=None)
        if r.get("case"):
            entry["case"] = r["case"]
        for c in own:
            if c is not r:
                entry["case_" + c["case"]] = dict(
                    launches=leg_launches(c, name), legs=c["legs"],
                    **{k: c[k] for k in keys}, library_ms=None,
                    **{k: c[k] for k in bf16_keys if k in c})
        if name.startswith("pairwise"):
            # launches of the n = 3000 run; the n = 32768 run and that
            # size's kernel check under "at_n<n>"
            entry["launches"] = dense_reports[n_main]["launches"][name]
            entry["n"] = n_main
            entry[f"at_n{n_big}"] = dict(
                launches=dense_reports[n_big]["launches"][name],
                **{k: pw_reports[n_big][name][k] for k in keys},
                library_ms=None)
            (par,) = [c for c in pw_reports[n_main]["cases"]
                      if c["case"] == "parity3k" and c["name"] == name]
            entry["case_parity3k"] = dict(
                launches=legs["parity3k"][name], legs=["parity3k"],
                **{k: par[k] for k in keys}, library_ms=None)
        kernels.append(add_dp_legs(entry, name))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
