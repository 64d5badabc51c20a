#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``planetmodel_sph_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It never imports JAX or the JAX package. Phases, any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the six CUDA kernels from ``planetmodel_sph_tpu_torch/csrc``;
3. load: the settled 100k state ``docs/results/drift100k_r5ship/state.psph``
   with the config in its header, onto the card;
4. kernels: each windowed kernel's inputs are recorded at the first rebuild
   of that state (one chunk set-up, one RESPA inner force evaluation, one
   far evaluation), then each kernel runs on them and is held against its
   plain PyTorch version (in slices of groups), and both are timed. The two
   all-pairs kernels are held against theirs on primed ``ics.jupiter``
   particles at n = 3000 and n = 32768: pass 1 with both softenings, pass 2
   symmetric, asymmetric with the sign bug, and symmetric with viscosity
   and the Balsara limiter on a rotating, contracting velocity field;
5. main paths, each with the launch counts reset just before and read just
   after: ``planet.run_info`` for 64 steps of the 100k state (two K=32
   chunks, one sort_every=64 period), then the dense ``jupiter_3k`` path
   from its initial conditions (``ics.jupiter`` -> ``planet.prime`` -> a
   warm-up run -> the timed ``planet.run_info``) at n = 3000 for 200 steps
   and at n = 32768 for 20; overflow counters, finiteness, neighbour
   counts, momentum and energy;
6. small input: the 2048 innermost particles run 8 steps of the cached
   pipeline, and 512 particles from ``ics.jupiter`` 8 steps of the dense
   one, on the card and on the CPU (plain versions, which the CPU tests
   hold against the JAX package), and the two results must agree.

The second-to-last line of standard output is a JSON object with one entry
per kernel; the last line is ``{"ok": true, "device": {...}}``. A full
report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
SMALL_N = 2048            # particles of the card-against-CPU agreement run
SMALL_STEPS = 8           # its steps: two chunks, RESPA, one sort reuse

DENSE_RUNS = ((3000, 200), (32768, 20))   # (n, steps) of the dense main path
DENSE_SMALL_N = 512       # particles of the dense card-against-CPU run

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

KERNELS = {
    "filter_sph": ("planetmodel_sph_tpu_torch/csrc/filter_sph.cu",
                   "planetmodel_sph_tpu/ops/pallas/groups2.py:382"),
    "pass1_gradh": ("planetmodel_sph_tpu_torch/csrc/pass1_gradh.cu",
                    "planetmodel_sph_tpu/ops/pallas/groups2.py:250"),
    "pass2": ("planetmodel_sph_tpu_torch/csrc/pass2.cu",
              "planetmodel_sph_tpu/ops/pallas/groups2.py:649"),
    "gravity_fused": ("planetmodel_sph_tpu_torch/csrc/gravity_fused.cu",
                      "planetmodel_sph_tpu/ops/pallas/groups2.py:969"),
    "pairwise_pass1": ("planetmodel_sph_tpu_torch/csrc/pairwise_pass1.cu",
                       "planetmodel_sph_tpu/ops/pallas/pairwise.py:255"),
    "pairwise_pass2": ("planetmodel_sph_tpu_torch/csrc/pairwise_pass2.cu",
                       "planetmodel_sph_tpu/ops/pallas/pairwise.py:284"),
}

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
TOL = {
    "filter_sph": [None],
    "pass1_gradh": [(1e-4, 0.0), None, (1e-4, 1e-4)],
    "pass2": [(1e-4, 1e-4)] * 3 + [(1e-4, 0.0)] + [(1e-4, 1e-4)] * 3
    + [None],
    "gravity_fused": [(1e-4, 0.0)] + [(1e-4, 1e-4)] * 3 + [None, None],
    # rho, n_neighbors, phi, grad_phi, n_direct
    "pairwise_pass1": [(1e-4, 0.0), None, (1e-4, 0.0), (1e-4, 1e-4), None],
    # grad_p[, dc]
    "pairwise_pass2": [(1e-4, 1e-4), (1e-4, 1e-4)],
}


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


# ---------------------------------------------------------------------------
# kernel inputs, slicing, comparison and timing
# ---------------------------------------------------------------------------

def capture_inputs(state, cfg):
    """Record the last call of each kernel wrapper over one chunk set-up
    (Newton h-solve + build), one RESPA inner force evaluation and one far
    evaluation: the shapes every step of the main path gives the kernels."""
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.ops import structure
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2

    seen = {}
    orig = {k: getattr(gk2, k) for k in gk2.KERNELS}

    def spy(name):
        def call(*a, **kw):
            seen[name] = (a, kw)
            return orig[name](*a, **kw)
        return call

    for k in orig:
        setattr(gk2, k, spy(k))
    try:
        run_state, st = planet.chunk_setup(state, cfg)
        planet._forces_block(run_state.pos, run_state.h, run_state.mass, cfg,
                             st, solve_h=False, sorted_io=True,
                             grav_tiers="near")
        structure.gravity_far(run_state.pos, run_state.h, run_state.mass,
                              cfg, st, sorted_io=True)
    finally:
        for k, f in orig.items():
            setattr(gk2, k, f)
    return seen


def slice_args(name, a, kw, g0, g1):
    """The arguments of one kernel call restricted to groups [g0, g1)."""
    b = kw["b"]
    rows = lambda rs: [r[g0:g1].contiguous() for r in rs]
    cols = lambda cs: [c[g0 * b:g1 * b].contiguous() for c in cs]
    if name in ("filter_sph", "pass1_gradh"):
        nv, tgt, src = a
        return (nv[g0:g1].contiguous(), cols(tgt), rows(src)), {}
    if name == "pass2":
        nv, tgt, src = a
        return ((nv[g0:g1].contiguous(), cols(tgt), rows(src)),
                dict(nv_p2p=kw["nv_p2p"][g0:g1].contiguous(),
                     p2p_rows=rows(kw["p2p_rows"]), g_const=kw["g_const"]))
    nv, tgt, ring, far, acc = a
    return ((nv[g0:g1].contiguous(), cols(tgt), rows(ring), far,
             acc[g0:g1].contiguous()), dict(g_const=kw["g_const"]))


def n_groups(a):
    """Target groups of a kernel call: the length of its nv argument."""
    return a[0].shape[0]


def plain_sliced(name, a, kw):
    """The plain version over every group, SLICE_GROUPS groups at a time
    (its [G, B, S] intermediates would not fit whole)."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    fn = getattr(gk2, name + "_plain")
    g = n_groups(a)
    parts = []
    for g0 in range(0, g, SLICE_GROUPS):
        sa, skw = slice_args(name, a, kw, g0, min(g, g0 + SLICE_GROUPS))
        out = fn(*sa, **skw)
        parts.append(out if isinstance(out, tuple) else (out,))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))


def compare(name, out, ref):
    """Hold kernel outputs against the plain version's. Returns
    (ok, max_abs_err, messages)."""
    out = out if isinstance(out, tuple) else (out,)
    worst, msgs, ok = 0.0, [], True
    for k, (o, r, tol) in enumerate(zip(out, ref, TOL[name])):
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


def _group_slices(g):
    for g0 in range(0, g, SLICE_GROUPS):
        yield g0, min(g, g0 + SLICE_GROUPS)


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
        ops += (OPS_P1["inner"] * _n(live & (q < 1.0))
                + OPS_P1["outer"] * _n(live & (q >= 1.0) & (q < 2.0))
                + OPS_P1["none"] * _n(live & (q >= 2.0)))
    return ops


def _dyer_ip_ops(live, x):
    return (OPS_DYER_IP["near"] * _n(live & (x < 1.0))
            + OPS_DYER_IP["far"] * _n(live & (x >= 1.0)))


def _gw_ops(live, q):
    return (OPS_GW["inner"] * _n(live & (q < 1.0))
            + OPS_GW["outer"] * _n(live & (q >= 1.0) & (q < 2.0))
            + OPS_GW["none"] * _n(live & (q >= 2.0)))


def _pass2_ops(a, kw):
    """Pass 2's operations: on each live SPH pair the geometry, the count,
    the Dyer-Ip branch of x = r/min(h_i, h_j) and the gw branch of q_i and
    q_j (the pressure sums only where a gw is not 0); on each live P2P
    pair the geometry, the count and the Dyer-Ip branch."""
    import torch
    nv, tgt, src = a
    nv2, p2p = kw["nv_p2p"], kw["p2p_rows"]
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    ops = OPS_SLOT_TEST * (_slots_below_nv(nv, s)
                           + _slots_below_nv(nv2, p2p[0].shape[1]))
    for g0, g1 in _group_slices(g):
        tx, ty, tz, tih, _ = (c[g0 * b:g1 * b].reshape(g1 - g0, b, 1)
                              for c in tgt)
        sx, sy, sz, sih, sm, _ = (r[g0:g1, None, :] for r in src)
        live = _live(nv[g0:g1], sm)
        dxx, dxy, dxz = tx - sx, ty - sy, tz - sz
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))
        qi, qj = r * tih, r * sih
        ops += ((OPS_GEOM + OPS_COUNT + OPS_GW_PAIR) * b * _n(live)
                + _dyer_ip_ops(live, r * torch.minimum(tih, sih))
                + _gw_ops(live, qi) + _gw_ops(live, qj)
                + OPS_GW_JH4 * _n(live & (qj < 2.0))
                + OPS_GP_SUM * _n(live & ((qi < 2.0) | (qj < 2.0))))
        del live, dxx, dxy, dxz, r2, r, qi, qj
        px, py, pz, pih, pm = (r_[g0:g1, None, :] for r_ in p2p)
        live = _live(nv2[g0:g1], pm)
        dxx, dxy, dxz = tx - px, ty - py, tz - pz
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        r = r2 * torch.rsqrt(torch.clamp(r2, min=1e-30))
        ops += ((OPS_GEOM + OPS_COUNT) * b * _n(live)
                + _dyer_ip_ops(live, r * torch.minimum(tih, pih)))
    return ops


def _gravity_ops(a):
    """gravity_fused's operations: one multipole evaluation per target and
    live entry (ring slots below nv with m > 0, far entries with accept and
    m > 0), the ring's m test per (group, slot) and the far scan's accept
    test per (group, entry) plus its m test where accepted."""
    import torch
    nv, tgt, ring, far, acc = a
    g, sr = ring[0].shape
    b = tgt[0].shape[0] // g
    slot = torch.arange(sr, device=nv.device)[None, :] < nv[:, None]
    took = acc > 0.5
    n_eval = _n(slot & (ring[0] > 0.0)) + _n(took & (far[0] > 0.0))
    per = OPS_MONO + (OPS_QUAD if len(ring) == 10 else 0)
    return b * per * n_eval + _n(slot) + acc.numel() + _n(took)


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


def _by_branch(table, live, q):
    return (table["inner"] * _n(live & (q < 1.0))
            + table["outer"] * _n(live & (q >= 1.0) & (q < 2.0))
            + table["none"] * _n(live & (q >= 2.0)))


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
    if name == "filter_sph":
        nv, tgt, src = a
        nbytes = _io_bytes(tgt, [(nv, src)], [], out)
        ops = _filter_ops(a)
    elif name == "pass1_gradh":
        nv, tgt, src = a
        nbytes = _io_bytes(tgt, [(nv, src)], [], out)
        ops = _pass1_ops(a)
    elif name == "pass2":
        nv, tgt, src = a
        nbytes = _io_bytes(tgt, [(nv, src), (kw["nv_p2p"], kw["p2p_rows"])],
                           [], out)
        ops = _pass2_ops(a, kw)
    else:
        nv, tgt, ring, far, acc = a
        # the softening column is not read: no P2P tier here
        nbytes = _io_bytes(tgt[:3], [(nv, ring)], [*far, acc], out)
        ops = _gravity_ops(a)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_kernels(seen):
    """Phase 4: each kernel against its plain version, timed. Returns
    ({name: report}, failures)."""
    import torch
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    reports, failures = {}, []
    for name in gk2.KERNELS:
        if name not in seen:
            failures.append(f"{name}: not called while recording inputs")
            continue
        a, kw = seen[name]
        wrapper = getattr(gk2, name)
        out = wrapper(*a, **kw)
        torch.cuda.synchronize()
        ref = plain_sliced(name, a, kw)
        torch.cuda.synchronize()
        ok, err, msgs = compare(name, out, ref)
        ms = cuda_ms(lambda: wrapper(*a, **kw), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain_sliced(name, a, kw), PLAIN_REPS)
        b_ms, b_by, nbytes, ops = bound(name, a, kw, out)
        shapes = {"groups": n_groups(a), "b": kw["b"],
                  "window": list(a[2][0].shape)}
        if name == "pass2":
            shapes["p2p_window"] = list(kw["p2p_rows"][0].shape)
        if name == "gravity_fused":
            shapes["far"] = list(a[4].shape)
        reports[name] = dict(ok=ok, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=nbytes, ops=ops,
                             shapes=shapes, messages=msgs)
        print(f"kernel {name}: {'ok' if ok else 'MISMATCH'} "
              f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) shapes={shapes}", flush=True)
        for m in msgs:
            print(f"  {name}: {m}", flush=True)
        if not ok:
            failures.append(f"{name}: disagrees with its plain version")
        del out, ref
        torch.cuda.empty_cache()
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
    return cases


def check_pairwise(n):
    """Phase 4 for the all-pairs kernels at n particles. Returns ({name:
    report of the main path's case, "cases": [...]}, failures)."""
    import torch
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
        ms = cuda_ms(lambda: kernel(*args, cfg, **kw), KERNEL_REPS)
        plain_ms = cuda_ms(lambda: plain(*args, cfg, **kw), PLAIN_REPS)
        b_ms, b_by, nbytes, ops = pairwise_bound(name, args, kw, cfg,
                                                 as_tuple(out))
        rep = dict(name=name, case=case, n=n, ok=ok, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, ops=ops, splits=pw.splits_for(n),
                   messages=msgs)
        reports["cases"].append(rep)
        if on_main:
            reports[name] = rep
        print(f"kernel {name} [{case}, n={n}]: "
              f"{'ok' if ok else 'MISMATCH'} max_abs_err={err:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.5f} "
              f"({b_by})", flush=True)
        for m in msgs:
            print(f"  {name} [{case}]: {m}", flush=True)
        if not ok:
            failures.append(f"{name} [{case}, n={n}]: disagrees with its "
                            "plain version")
        del out, ref
        torch.cuda.empty_cache()
    return reports, failures


# ---------------------------------------------------------------------------
# main path and the small-input agreement
# ---------------------------------------------------------------------------

def expected_launches(cfg, steps):
    """Launches per kernel of `steps` cached RESPA steps: per chunk, one
    filter at the Newton solve's build and one at the cached build,
    h_newton_iters-1 warm-started density sweeps plus one per inner step,
    one pass 2 per inner step, and one far evaluation per RESPA period plus
    the seed."""
    k = cfg.rebuild_every
    chunks = steps // k
    return {"filter_sph": 2 * chunks,
            "pass1_gradh": chunks * (max(1, cfg.h_newton_iters - 1) + k),
            "pass2": chunks * k,
            "gravity_fused": chunks * (1 + k // cfg.respa_every)}


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


def small_agreement(state, cfg):
    """Phase 6: the same pipeline on the card and on the CPU from one small
    input. pos and rho must agree within rtol 1e-4, atol 1e-4 (the bound
    tests/test_structure.py holds the fused cached run to), overflow
    counters exactly."""
    import torch
    from planetmodel_sph_tpu_torch.models import planet
    from planetmodel_sph_tpu_torch.state import FIELDS, ParticleState
    small = inner_ball(state, SMALL_N)
    scfg = cfg.replace(n=small.n, rebuild_every=SMALL_STEPS // 2,
                       respa_every=SMALL_STEPS // 4, sort_every=SMALL_STEPS)
    out_g, info_g = planet.run_info(small, scfg, SMALL_STEPS)
    cpu = ParticleState(**{k: getattr(small, k).cpu() for k in FIELDS})
    out_c, info_c = planet.run_info(cpu, scfg, SMALL_STEPS)
    res = {}
    ok = True
    for k in ("pos", "rho"):
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


def dense_main(n, steps):
    """Phase 5 for the dense path: the cold-start bench's sequence through
    the entry points (initial conditions, priming pass, a warm-up run of
    the same length, the timed run), the launch counts reset just before
    the timed run and read just after. Returns (report, failures)."""
    import torch
    from planetmodel_sph_tpu_torch import config as config_mod
    from planetmodel_sph_tpu_torch.models import ics, planet
    from planetmodel_sph_tpu_torch.ops.cuda import launch
    from planetmodel_sph_tpu_torch.utils import diagnostics
    cfg = config_mod.jupiter_3k(n=n)
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
    rep = dict(n=n, steps=steps, wall_s=wall, steps_per_s=steps / wall,
               particle_steps_per_s=n * steps / wall, overflow=overflow,
               launches=launches, expected=expect, non_finite=bad_fields,
               neighbors_avg=nbrs, momentum_mag=mom, rel_energy_change=de,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"dense main path n={n}: {steps} steps in {wall:.3f} s = "
          f"{steps / wall:.2f} steps/s = {n * steps / wall:.4g} "
          f"particle-steps/s, peak memory {rep['peak_mem_gb']:.3f} GB",
          flush=True)
    print(f"  launches {launches}", flush=True)
    print(f"  overflow {overflow} non-finite {bad_fields} neighbors_avg "
          f"{nbrs:.2f} momentum_mag {mom:.3e} rel energy change {de:.3e}",
          flush=True)
    failures = []
    if any(overflow.values()):
        failures.append(f"dense n={n}: overflow counters not 0: {overflow}")
    if launches != expect:
        failures.append(f"dense n={n}: launch counts {launches} != {expect}")
    if bad_fields:
        failures.append(f"dense n={n}: non-finite fields: {bad_fields}")
    if not 30.0 <= nbrs <= 80.0:
        failures.append(f"dense n={n}: neighbors_avg {nbrs:.2f} outside "
                        "30-80")
    if not mom < 1e-4:
        failures.append(f"dense n={n}: momentum_mag {mom:.3e} >= 1e-4")
    if not abs(de) < 1e-2 * max(1.0, steps / 100.0):
        failures.append(f"dense n={n}: total energy moved by {de:.3e} in "
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


def main() -> int:
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}", flush=True)

    # 3. load
    t0 = time.perf_counter()
    state, cfg, step0 = snapshot.load(STATE, device="cuda")
    torch.cuda.synchronize()
    print(f"load: n={state.n} step={step0} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 4. kernels against their plain versions
    seen = capture_inputs(state, cfg)
    torch.cuda.synchronize()
    kreports, failures = check_kernels(seen)
    del seen
    torch.cuda.empty_cache()
    pw_reports = {}
    for n, _ in DENSE_RUNS:
        pw_reports[n], fails = check_pairwise(n)
        failures += fails
    # the kernels line carries the all-pairs kernels at the default
    # preset's size; the larger size rides along under its own key
    n_main, n_big = DENSE_RUNS[0][0], DENSE_RUNS[1][0]
    for name in ("pairwise_pass1", "pairwise_pass2"):
        kreports[name] = pw_reports[n_main][name]
    report["kernels"] = kreports
    report["pairwise_cases"] = [c for r in pw_reports.values()
                                for c in r["cases"]]

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
    del out
    torch.cuda.empty_cache()

    # 5b. the dense main path from its initial conditions
    dense_reports = {}
    for n, steps in DENSE_RUNS:
        dense_reports[n], fails = dense_main(n, steps)
        failures += fails
    report["dense_main_path"] = list(dense_reports.values())

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
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for name, (source, replaces) in KERNELS.items():
        r = kreports[name]
        entry = dict(name=name, route="cuda", source=source,
                     replaces=replaces, launches=launches[name],
                     **{k: r[k] for k in keys}, library_ms=None)
        if name.startswith("pairwise"):
            # launches of the n = 3000 run; the n = 32768 run and that
            # size's kernel check under "at_n<n>"
            entry["launches"] = dense_reports[n_main]["launches"][name]
            entry["n"] = n_main
            entry[f"at_n{n_big}"] = dict(
                launches=dense_reports[n_big]["launches"][name],
                **{k: pw_reports[n_big][name][k] for k in keys})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
