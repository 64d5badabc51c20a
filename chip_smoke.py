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
   Balsara inputs with the energy column. The two all-pairs kernels
   are held against theirs on primed ``ics.jupiter`` particles at n = 3000
   and n = 32768: pass 1 with both softenings, pass 2 symmetric, asymmetric
   with the sign bug, and symmetric with viscosity and the Balsara limiter
   on a rotating, contracting velocity field, each also with a NaN planted
   in one field of one particle at a time (x, m; for pass 2 the pressure
   and the velocity), the outputs NaN exactly where the plain version's
   are. For every case of the six redesigned kernels it also prints what
   the kernel visits (the three compacted sweeps ``pass1_gradh``,
   ``pass1_sym`` and ``pass2``: the share of slots below nv that are live
   and of live pairs inside the support, and the share ``pass1_sym``'s
   skip leaves out; ``p2p``: the live share, every live pair evaluated;
   ``gravity_fused``: the far entries accepted and live, the ring and blk
   slots live; ``filter_sph``: the live slots kept and pre-rejected whole
   by the bounding boxes, the boxes whose targets a live slot tests and
   its exact tests beside the tests the bound charges), the instance's
   registers, shared memory and spills from the build's ``-Xptxas -v``
   log (phase 2 prints every instance), and holds a second launch on the
   same inputs to the same bits. In every case of ``pass1_gradh``,
   ``pass1_sym``, ``pass2``, ``p2p``, ``gravity_fused`` and ``filter_sph``
   it plants NaNs, one field at a time (m, cc, a velocity row, ih; for
   ``pass1_sym`` and ``p2p`` also a dead slot, m = 0, with a NaN x or ih;
   for the filter x, sc, ssk and m of a slot it keeps, tc and tsk of its
   group's targets), where a kernel leaves out work: each output must be
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
   ``probe_pass1_tile`` at SG 1, 4 and 8) against theirs at the reference
   tools' shapes. Then (5e) the port's ``tools.roofline`` and
   ``tools.microbench``, the probes' main path: the card's dispatch
   latency, memory stream, f32 FMA rate and launch cost beside the
   published peaks, ``count_work`` at the settled state and the modeled
   floor against the main path's measured step, the five gather variants
   and the three tile widths; and (5f) `exact100k` (the settled state
   under particle-exact SPH lists, ``sph_exact_window=896``, unfused: 64
   steps of the cached grad-h Newton chunk, the h-solve's own exact lists
   included), `unsorted100k` (the production step with
   ``sorted_chunks=False``, 64 steps, held against the sorted main path's
   state at rtol 2e-5, atol 1e-6, counts equal) and `dense3k_k4`
   (``jupiter_3k`` at n = 3000 with rebuild_every=4, 200 steps);
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
   all-pairs kernels into DIR's own build directory, phase 4 times them
   and this checkout's in turns (parent, this, this, parent) on each
   case's inputs, and this phase times the two probes (``probe_launch`` in
   a chain beside ``torch.mul``, ``probe_gather`` beside ``packed[idx]``)
   and runs the production step, `sym100k` and `sg100k` (README's
   commands) from both checkouts, each in its own processes, in the same
   turns (``bench
   --repeat 3``), and each checkout's sorted and unsorted chunks against
   each other.

The second-to-last line of standard output is a JSON object with one entry
per kernel; the last line is ``{"ok": true, "device": {...}}``. A full
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import subprocess
import sys
import time

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

# The all-pairs kernels, per pair j != i of the n particles (the self test
# is charged to all n^2). Per-source and per-target factors (1/h^3, P/rho^2,
# the sound speed) are O(n) and not counted.
OPS_PW_SELF = 1           # j == i
OPS_PW_GEOM = 13          # dx(3) r2(5) sqrt q_i q_j; q_i<2 q_j<2
OPS_PW_W = dict(inner=8,  # q<1; q2 q3 poly(4) *c
                outer=7,  # q<1 q<2; t t^2 t^3 *0.25 *c
                none=2)   # q<1 q<2
OPS_PW_RHO = 9            # c_j(3); m/2 W_i+W_j * +=; q_i<2 count
OPS_PW_GRAV = 3           # fmax rsqrt; n_direct add (then OPS_DYER_IP,
#                           less its fmin under receiver softening)
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
#   exact (pairwise_pass1 is built with -fmad=false too), rho and phi rtol
#   1e-4, grad phi, grad P and the div/curl sums rtol 1e-4 plus the atol.
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


def plain_sliced(name, a, kw):
    """The plain version over every group, a slice of groups at a time
    (its [G, B, S] intermediates would not fit whole)."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    fn = getattr(gk2, name + "_plain")
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
    kernel's own time from the host's. A trace that holds no kernel is
    taken again, up to `tries` times; then the time is None (not
    measured), never 0."""
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
    for g0, g1 in _group_slices(g):
        tx, ty, tz, tc, tsk = (c[g0 * b:g1 * b].reshape(g1 - g0, b, 1)
                               for c in tgt)
        sx, sy, sz, sc, ssk, sm = (r[g0:g1, None, :] for r in src)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        cut = torch.maximum(tc, sc) + tsk + ssk
        hit = r2 < cut * cut
        first = torch.where(hit.any(dim=1),
                            hit.int().argmax(dim=1) + 1, b)
        live = _live(nv[g0:g1], sm)[:, 0, :]
        tests += int(torch.where(live, first, 0).sum())
    return OPS_FILTER * tests + OPS_SLOT_TEST * _slots_below_nv(nv, s)


def _pass1_ops(a):
    """Pass 1's operations, each live (target, slot) pair charged by the
    branch of q = sqrt(r2)/h_i it takes, as the plain version masks it."""
    import torch
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    ops = OPS_SLOT_TEST * _slots_below_nv(nv, s)
    for g0, g1 in _group_slices(g):
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
    for g0, g1 in _group_slices(g):
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


def _p2p_window_ops(nv, rows, tgt, receiver, g0, g1, b):
    """One P2P window's operations for groups [g0, g1): the geometry, the
    count and the Dyer-Ip branch on each live pair (no fmin under receiver
    softening)."""
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
    return ((OPS_GEOM + OPS_COUNT - (1 if receiver else 0)) * b * _n(live)
            + _dyer_ip_ops(live, r * inv_a))


def _p2p_ops(a, kw):
    nv, tgt, src = a
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    ops = OPS_SLOT_TEST * _slots_below_nv(nv, s)
    for g0, g1 in _group_slices(g):
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


def _gravity_ops(a, kw=None):
    """gravity_fused's operations: one multipole evaluation per target and
    live entry (ring and blk slots below their nv with m > 0, far entries
    with accept and m > 0), the windows' m test per (group, slot) and the
    far scan's accept
    test per (group, entry) plus its m test where accepted; with the near
    tier its window's pairs as p2p counts them."""
    import torch
    nv, tgt, ring, far, acc = a
    g, sr = ring[0].shape
    b = tgt[0].shape[0] // g
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
    per = OPS_MONO + (OPS_QUAD if len(ring) == 10 else 0)
    ops = b * per * n_eval + n_test
    p2p = (kw or {}).get("p2p_rows")
    if p2p is not None:
        nvp = kw["nv_p2p"]
        ops += OPS_SLOT_TEST * _slots_below_nv(nvp, p2p[0].shape[1])
        for g0, g1 in _group_slices(g):
            ops += _p2p_window_ops(nvp, p2p, tgt,
                                   kw.get("receiver_soft", False), g0, g1,
                                   b)
    return ops


def _row_blocks(n, block=512):
    return [(i0, min(n, i0 + block)) for i0 in range(0, n, block)]


def _pw_branches(pos, inv_h, i0, i1):
    """[block, n] masks and q of the pairs of target rows [i0, i1): not the
    self pair, q_i and q_j as the all-pairs kernels form them."""
    import torch
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dxx = x[i0:i1, None] - x[None, :]
    dxy = y[i0:i1, None] - y[None, :]
    dxz = z[i0:i1, None] - z[None, :]
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    idx = torch.arange(pos.shape[0], device=pos.device)
    pair = idx[i0:i1, None] != idx[None, :]
    r = torch.sqrt(r2)
    return pair, r2, r * inv_h[i0:i1, None], r * inv_h[None, :], \
        (dxx, dxy, dxz)


def _pairwise_pass1_ops(pos, h, mass, cfg):
    """Pass 1's operations on this data: every pair's geometry, the spline
    branches of q_i and q_j on pairs inside either support, and, with
    direct gravity, the Dyer-Ip branch of x = r / a on every pair."""
    import torch
    n = pos.shape[0]
    inv_h = 1.0 / torch.where(h > 0, h, 1.0)
    gravity = cfg.gravity_solver == "direct"
    receiver = cfg.softening_mode == "receiver_h"
    ops = OPS_PW_SELF * n * n + OPS_PW_GEOM * n * (n - 1)
    for i0, i1 in _row_blocks(n):
        pair, r2, qi, qj, _ = _pw_branches(pos, inv_h, i0, i1)
        sph = pair & ((qi < 2.0) | (qj < 2.0))
        ops += (OPS_PW_RHO * _n(sph) + _by_branch(OPS_PW_W, sph, qi)
                + _by_branch(OPS_PW_W, sph, qj))
        if gravity:
            inv_a = inv_h[i0:i1, None].expand_as(r2) if receiver \
                else torch.minimum(inv_h[i0:i1, None], inv_h[None, :])
            x = (r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))) * inv_a
            ops += ((OPS_PW_GRAV - (1 if receiver else 0)) * _n(pair)
                    + _dyer_ip_ops(pair, x))
    return ops


def _pairwise_pass2_ops(pos, h, mass, cfg, vel):
    """Pass 2's operations on this data: every pair's geometry; on pairs
    inside either support the gradient branches, the pressure coefficient
    and the sums; with viscosity v.x on those pairs, Pi_ij on the
    approaching ones, the correct-derivative gradient again under the sign
    bug and the div/curl sums under Balsara."""
    import torch
    n = pos.shape[0]
    inv_h = 1.0 / torch.where(h > 0, h, 1.0)
    av = cfg.av_alpha > 0.0 and vel is not None
    balsara = cfg.av_balsara and av
    mode = ("asymmetric" if cfg.grad_p_mode == "reference_asymmetric"
            else "symmetric")
    ops = OPS_PW_SELF * n * n + OPS_PW_GEOM * n * (n - 1)
    for i0, i1 in _row_blocks(n):
        pair, r2, qi, qj, (dxx, dxy, dxz) = _pw_branches(pos, inv_h, i0, i1)
        sup = pair & ((qi < 2.0) | (qj < 2.0))
        grad = (_by_branch(OPS_PW_GW, sup, qi) + _by_branch(OPS_PW_GW, sup, qj)
                + OPS_PW_GW_CJ * _n(sup & (qj < 2.0))
                + OPS_PW_GW_SYM * _n(sup))
        ops += grad + (OPS_PW_COEF[mode] + OPS_PW_GP_SUM) * _n(sup)
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


def pairwise_bound(name, args, kw, cfg, out):
    """(bound_ms, bound_by, bytes, ops) of one all-pairs call: every input
    array read once and every output written once over the HBM rate,
    against the f32 operations this data needs over the f32 peak."""
    out = list(out) if isinstance(out, tuple) else [out]
    tensors = [*args, *(v for v in kw.values() if v is not None), *out]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if name == "pairwise_pass1":
        ops = _pairwise_pass1_ops(*args, cfg)
    else:
        pos, h, mass = args[:3]
        ops = _pairwise_pass2_ops(pos, h, mass, cfg, kw.get("vel"))
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def bound(name, a, kw, out):
    """(bound_ms, bound_by, bytes, ops) for this call: the bytes the
    function must move over the HBM rate, against the f32 operations this
    data needs over the f32 peak."""
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
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


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
    written once (a tile's rows only below each instance's extent)."""
    from planetmodel_sph_tpu_torch.ops.cuda import probes
    if name == "probe_pass1_tile":
        nv, tgt, rows = a
        ext = probes.tile_extent(nv, rows[0].shape[1], kw.get("chunk", 512))
        nbytes = (_io_bytes(tgt, [], [nv], out)
                  + int(ext.sum()) * sum(r.element_size() for r in rows))
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


def instance_key(name, kw, a=None):
    """The template arguments of the instance a call launches (pass2: mode,
    sign bug, viscosity, Balsara, gravity 0/1/2, receiver softening,
    energy, as pass2.cu orders them; gravity_fused: its near tier 0/1/2
    and the moment fields of the ring rows `a[2]`; p2p: receiver softening
    0/1; pass1_gradh, pass1_sym and filter_sph have none)."""
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    if name == "gravity_fused":
        near = (2 if kw.get("receiver_soft") else 1) \
            if kw.get("p2p_rows") is not None else 0
        return (name, (near, len(a[2])))
    if name == "p2p":
        return (name, (int(bool(kw.get("receiver_soft"))),))
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
    for g0, g1 in _group_slices(g):
        gs = g1 - g0
        tx, ty, tz, tc, tsk = (c[g0 * b:g1 * b].reshape(gs, b, 1)
                               for c in tgt)
        sx, sy, sz, sc, ssk, sm = (r[g0:g1, None, :] for r in src)
        live = _live(nv[g0:g1], sm)[:, 0, :]
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
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    b = kw["b"]
    nv, tgt, src = a
    for g0, g1 in _group_slices(n_groups(a)):
        keep = gk2.filter_sph_plain(*slice_args(a, kw, g0, g1)[0])
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
    version forms NaN from it. `must_reach`: the plain version's outputs
    hold a NaN for this planting whatever the inputs (a NaN m of the ring
    and far tiers is masked out by m > 0, a NaN velocity meets no
    viscosity where no pair approaches, a dead slot's NaN x meets pass1_sym
    only inside a spline of a NaN q, which is 0).
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
        ref = getattr(gk2, name + "_plain")(*sa, **skw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        msg = non_finite_agree(out, ref)
        if msg:
            return f"{label}: {msg}", reached
        if rows_out:
            base = getattr(gk2, name + "_plain")(
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
    if parent_libs and name in parent_libs:
        # the parent's kernel and this one in turns: parent, this, this,
        # parent, on the same inputs through the same wrapper
        from planetmodel_sph_tpu_torch.ops.cuda import build
        turns = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            with (build.library(name, parent_libs[name]) if who == "parent"
                  else contextlib.nullcontext()):
                turns[who].append(cuda_ms(lambda: wrapper(*a, **kw),
                                          KERNEL_REPS))
        extra["parent_ms"], extra["ms_in_turns"] = turns["parent"], \
            turns["this"]
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
    if "parent_ms" in extra:
        p, t = extra["parent_ms"], extra["ms_in_turns"]
        print(f"  {label}: in turns, parent {p[0]:.4f}, this {t[0]:.4f}, "
              f"this {t[1]:.4f}, parent {p[1]:.4f} ms "
              f"({sum(p) / sum(t):.2f}x)", flush=True)
    for m in msgs:
        print(f"  {label}: {m}", flush=True)
    del out, ref
    torch.cuda.empty_cache()
    return dict(name=name, case=case, ok=ok, max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops, shapes=shapes,
                messages=msgs, **extra)


def visits_line(name, extra):
    """The per-case line of a redesigned kernel: what it visits (its
    window_shares), its instance's registers, shared memory and spills,
    and whether two launches gave the same bits."""
    sh, px = extra["shares"], extra["ptxas"] or {}
    if name == "gravity_fused":
        blk = (f", blk live {sh['blk_live_share']:.4f} of "
               f"{sh['blk_slots_below_nv']}" if "blk_live" in sh else "")
        what = (f"far accepted and live {sh['far_live_share']:.4f} of "
                f"{sh['far_entries']} (group, entry) slots, ring live "
                f"{sh['ring_live_share']:.4f} of {sh['ring_slots_below_nv']}"
                f" slots below nv{blk}")
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


def check_kernels(seen, ptxas=None, parent_libs=None):
    """Phase 4 on the production path's inputs: each kernel against its
    plain version, timed. Returns ({name: report}, failures)."""
    reports, failures = {}, []
    for name in ("filter_sph", "pass1_gradh", "pass2", "gravity_fused"):
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


def check_modes(cases, ptxas=None, parent_libs=None):
    """Phase 4 for every other mode of the windowed kernels. Returns
    ([report], failures)."""
    reports, failures = [], []
    for name, case, legs, a, kw in cases:
        rep = check_one(name, case, a, kw, ptxas, parent_libs)
        rep["legs"] = list(legs)
        reports.append(rep)
        if not rep["ok"]:
            failures.append(f"{name} [{case}]: disagrees with its plain "
                            "version")
        del a, kw
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
            ("pass2", "grad_h@exact100k")}
    missing = want - {(r["name"], r["case"]) for r in reports}
    if missing:
        failures.append(f"kernel cases not checked: {sorted(missing)}")
    return reports, failures


def pairwise_cases(n):
    """The all-pairs kernels' inputs at n particles: (name, case, cfg, args,
    kw, on_main_path) from primed ``ics.jupiter`` states. The viscosity
    case takes ``ics.rotating_planet`` with a homologous contraction added
    (v -= 0.02 x), so every pair approaches and the curl is not zero, and
    the Balsara factors its own priming pass leaves in the state."""
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    cfg = config_mod.jupiter_3k(n=n)
    st = planet.prime(ics.jupiter(cfg), cfg)
    base = (st.pos, st.h, st.mass)
    cases = [("pairwise_pass1", "symmetric_max", cfg, base, {}, True),
             ("pairwise_pass1", "receiver_h",
              cfg.replace(softening_mode="receiver_h"), base, {}, False)]
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
    return cases


def pairwise_plantings(name, args, kw, cfg):
    """The NaNs phase 4 plants in one all-pairs call, one planting a
    launch: [(label, args, keywords, must_reach)], each in one field of the
    last particle, which lies outside the supports of most targets: its x
    and m, and for pass 2 its pressure and (with viscosity) its velocity.
    `must_reach`: the plain version's outputs hold a NaN for it whatever
    the inputs (a NaN x meets pass 1 only inside a spline of a NaN q,
    which is 0, unless direct gravity reads it; a NaN velocity meets the
    viscosity of no pair that approaches, but the Balsara sums of
    every pair)."""
    j = args[0].shape[0] - 1
    grav = name == "pairwise_pass1" and cfg.gravity_solver == "direct"
    out = [("x", tuple(_with_nan(args, 0, (j, 0))), kw, grav or
            name == "pairwise_pass2"),
           ("m", tuple(_with_nan(args, 2, j)), kw, True)]
    if name == "pairwise_pass2":
        out.append(("P", tuple(_with_nan(args, 4, j)), kw, True))
        if kw.get("vel") is not None:
            vel = _with_nan([kw["vel"]], 0, (j, 0))[0]
            out.append(("velocity", args, dict(kw, vel=vel),
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


def check_pairwise(n, parent_libs=None):
    """Phase 4 for the all-pairs kernels at n particles, with planted NaNs;
    with `parent_libs` ({kernel: library} of another checkout's build)
    each case is also timed in turns with that build. Returns ({name:
    report of the main path's case, "cases": [...]}, failures)."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import build
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise as pw
    wrappers = {"pairwise_pass1": (pw.pass1, pw.pass1_plain),
                "pairwise_pass2": (pw.pass2, pw.pass2_plain)}
    reports, failures = {"cases": []}, []
    for name, case, cfg, args, kw, on_main in pairwise_cases(n):
        kernel, plain = wrappers[name]
        out = kernel(*args, cfg, **kw)
        torch.cuda.synchronize()
        ref = plain(*args, cfg, **kw)
        torch.cuda.synchronize()
        as_tuple = lambda o: tuple(o) if isinstance(o, tuple) else (o,)
        ok, err, msgs = compare(name, as_tuple(out), as_tuple(ref))
        nan_msg, reached = pairwise_nan_agreement(name, kernel, plain, args,
                                                  kw, cfg)
        if nan_msg:
            ok = False
            msgs.append(f"planted NaNs: {nan_msg}")
        ms = cuda_ms(lambda: kernel(*args, cfg, **kw), KERNEL_REPS)
        dev_ms = device_ms(lambda: kernel(*args, cfg, **kw))
        turns = None
        if parent_libs and name in parent_libs:
            # the parent's kernel and this one in turns, as check_one
            turns = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                with (build.library(name, parent_libs[name])
                      if who == "parent" else contextlib.nullcontext()):
                    turns[who].append(cuda_ms(
                        lambda: kernel(*args, cfg, **kw), KERNEL_REPS))
        plain_ms = cuda_ms(lambda: plain(*args, cfg, **kw), PLAIN_REPS)
        b_ms, b_by, nbytes, ops = pairwise_bound(name, args, kw, cfg,
                                                 as_tuple(out))
        rep = dict(name=name, case=case, n=n, ok=ok, max_abs_err=err, ms=ms,
                   device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by,
                   bytes=nbytes, ops=ops, splits=pw.splits_for(n),
                   nan_agrees=nan_msg is None, nan_reached=reached,
                   messages=msgs)
        if turns:
            rep["parent_ms"], rep["ms_in_turns"] = turns["parent"], \
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
        got = ", ".join(f"{k} {'reached' if v else 'masked'}"
                        for k, v in reached.items())
        print(f"  {label}: planted NaNs "
              f"{'agree' if nan_msg is None else 'DIFFER'} ({got})",
              flush=True)
        if turns:
            p, t = turns["parent"], turns["this"]
            print(f"  {label}: in turns, parent {p[0]:.4f}, this "
                  f"{t[0]:.4f}, this {t[1]:.4f}, parent {p[1]:.4f} ms "
                  f"({sum(p) / sum(t):.2f}x)", flush=True)
        for m in msgs:
            print(f"  {name} [{case}]: {m}", flush=True)
        if not ok:
            failures.append(f"{name} [{case}, n={n}]: disagrees with its "
                            "plain version")
        del out, ref
        torch.cuda.empty_cache()
    return reports, failures


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


def check_probe(name, case, a, kw):
    """One probe against its plain version (probe_gather and probe_launch
    exactly, probe_fma to FMA_RTOL, probe_pass1_tile to TILE_TOL of each
    target's sum of |m W|), timed: the report."""
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
    msgs = [] if ok else [f"{bad} entries outside tolerance, finite "
                          f"{finite}"]
    del out, ref
    torch.cuda.empty_cache()
    return dict(name=name, case=case, ok=ok, max_abs_err=max_err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=library_dev, graph_ms=graph_ms,
                bound_ms=b_ms,
                bound_by=b_by, bytes=nbytes, ops=ops, shapes=shapes,
                messages=msgs)


def check_probes():
    """Phase 4 for the tools' four probes. Returns ([report],
    failures)."""
    reports, failures = [], []
    for name, case, a, kw in probe_cases():
        rep = check_probe(name, case, a, kw)
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
    production step, `sym100k` and `sg100k` from DIR's checkout and from
    this one in turns, each whole (its kernels, its Python; bench_turns);
    then each
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
    for leg, extra in (("sym100k", SYM_BENCH), ("sg100k", SG_BENCH)):
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


def run_leg(label, state, cfg, steps, expect, energy, note=""):
    """One leg through ``planet.run_info``, the launch counts reset just
    before and read just after. `energy`: 'conserved' (|relative change| <
    1e-2), a number (|relative change| below it), 'not_growing' (damping
    and viscosity remove energy by design: the relative change must be <=
    0) or 'printed'. Under an evolved-u EOS the total energy holds the
    evolved u, which must stay finite with a rate that is not identically
    0. `note` is printed beside the launch counts. Returns (state, report,
    failures)."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    from planetmodel_sph_tpu_torch.utils import diagnostics
    e0 = diagnostics.measure(state, cfg)
    want = dict.fromkeys(launch.LAUNCHES, 0)
    want.update(expect)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch.reset_launches()
    t0 = time.perf_counter()
    out, info = planet.run_info(state, cfg, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(launch.LAUNCHES)
    overflow = {k: int(v) for k, v in info.items()}
    e1 = diagnostics.measure(out, cfg)
    de = float((e1["total_energy"] - e0["total_energy"])
               / abs(e0["total_energy"]))
    nbrs = float(e1["neighbors_avg"])
    bad_fields = all_finite(out)
    rep = dict(leg=label, n=state.n, steps=steps, wall_s=wall,
               steps_per_s=steps / wall, overflow=overflow,
               launches=launches, expected=want, non_finite=bad_fields,
               neighbors_avg=nbrs, momentum_mag=float(e1["momentum_mag"]),
               rel_energy_change=de,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"leg {label}: n={state.n} {steps} steps in {wall:.3f} s = "
          f"{steps / wall:.3f} steps/s, peak memory "
          f"{rep['peak_mem_gb']:.3f} GB", flush=True)
    print(f"  launches { {k: v for k, v in launches.items() if v} }"
          f"{' (' + note + ')' if note else ''}", flush=True)
    print(f"  overflow {overflow} non-finite {bad_fields} neighbors_avg "
          f"{nbrs:.2f} momentum_mag {rep['momentum_mag']:.3e} rel energy "
          f"change {de:.3e}", flush=True)
    failures = []
    if any(overflow.values()):
        failures.append(f"{label}: overflow counters not 0: {overflow}")
    if launches != want:
        failures.append(f"{label}: launch counts {launches} != {want}")
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
    expect.update(pairwise_pass1=steps, pairwise_pass2=steps)
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


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, metavar="DIR",
                    help="a checkout of another commit (e.g. unpacked with "
                    "git archive into a git-ignored directory): its "
                    "redesigned and all-pairs kernels are timed in turns "
                    "with this one's in phase 4, and phase 7 compares the "
                    "two checkouts' production, sym100k and sg100k steps")
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

    # 2. build
    t0 = time.perf_counter()
    try:
        logs = build.build_all(force=True)
    except RuntimeError as e:
        return fail(str(e))
    t_build = time.perf_counter() - t0
    report["build_s"] = t_build
    print(f"build: {len(logs)} kernels in {t_build:.2f} s", flush=True)
    if set(logs) != set(KERNELS):
        return fail(f"built {sorted(logs)}, expected {sorted(KERNELS)}")
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
    parent_libs = None
    if args.parent:
        # the other checkout's two sweeps, built into its own directory
        pkg = os.path.join(os.path.abspath(args.parent),
                           "planetmodel_sph_tpu_torch")
        pout = os.path.join(pkg, "build")
        t0 = time.perf_counter()
        in_turns = REDESIGNED + ALL_PAIRS
        try:
            build.build_all(in_turns, force=True,
                            src=os.path.join(pkg, "csrc"), out=pout)
        except RuntimeError as e:
            return fail(f"the parent's kernels: {e}")
        parent_libs = {n: build.lib_path(n, pout) for n in in_turns}
        print(f"build of the parent's {', '.join(in_turns)}: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = {}
    for n in REDESIGNED:
        # every instance of the redesigned kernels, by template arguments
        for inst in ptxas_instances(logs[n][1]):
            ptxas[(n, inst["args"])] = inst
            print(f"  ptxas {n}{list(inst['args']) if inst['args'] else ''}"
                  f": {inst['regs']} registers, {inst['smem']} B shared, "
                  f"{inst['stack']} B stack, spills {inst['spill_stores']}/"
                  f"{inst['spill_loads']} B", flush=True)
    report["ptxas"] = [dict(name=k[0], **v) for k, v in ptxas.items()]

    # 3. load
    t0 = time.perf_counter()
    state, cfg, step0 = snapshot.load(STATE, device="cuda")
    torch.cuda.synchronize()
    print(f"load: n={state.n} step={step0} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 4. kernels against their plain versions
    seen = capture_inputs(state, cfg)
    torch.cuda.synchronize()
    kreports, failures = check_kernels(seen, ptxas, parent_libs)
    report["stream_checks"], fails = stream_checks(seen)
    failures += fails
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
        mode_cases(state, cfg, sym_state, settle_state, settle_cfg),
        energy_cases(cfg, adia_state, sg_state, basalt_cfg, basalt_state),
        exact_cases(cfg, exact_state)), ptxas, parent_libs)
    failures += fails
    report["kernel_modes"] = mode_reports
    torch.cuda.empty_cache()
    pw_reports = {}
    for n, _ in DENSE_RUNS:
        pw_reports[n], fails = check_pairwise(n, parent_libs)
        failures += fails
    # the kernels line carries the all-pairs kernels at the default
    # preset's size; the larger size rides along under its own key
    n_main, n_big = DENSE_RUNS[0][0], DENSE_RUNS[1][0]
    for name in ("pairwise_pass1", "pairwise_pass2"):
        kreports[name] = pw_reports[n_main][name]
    report["kernels"] = kreports
    report["pairwise_cases"] = [c for r in pw_reports.values()
                                for c in r["cases"]]
    probe_reports, fails = check_probes()
    failures += fails
    report["probes"] = probe_reports

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
    if bad_fields:
        failures.append(f"non-finite fields: {bad_fields}")
    if not abs(de) < 1e-2:
        failures.append(f"total energy moved by {de:.3e} in {STEPS} steps")
    main_out, main_wall = out, wall
    del out
    torch.cuda.empty_cache()

    # 5b. the dense main path from its initial conditions
    dense_reports = {}
    for n, steps in DENSE_RUNS:
        dense_reports[n], fails = dense_main(n, steps)
        failures += fails
    report["dense_main_path"] = list(dense_reports.values())

    # 5c. the general grid + tree step
    leg_reports, fails = grid_legs(cfg, sym_state, settle_state, settle_cfg)
    failures += fails
    report["grid_legs"] = leg_reports
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
    legs = {r["leg"]: r["launches"] for r in leg_reports}

    def leg_launches(case_report, name):
        # launches of the legs whose own inputs this case was recorded on
        # (0 for an extra that only the kernel phase drives)
        return sum(legs[leg][name] for leg in case_report["legs"])

    for name, (source, replaces) in KERNELS.items():
        if name in PROBES:
            kernels.append(probe_entry(name, source, replaces,
                                       probe_reports, tools["launches"]))
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
                    **{k: c[k] for k in keys}, library_ms=None)
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
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
