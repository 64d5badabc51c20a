"""All-pairs kernels of the dense step (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/pallas/pairwise.py``. Two kernels,
``pairwise_pass1`` (density, neighbour count and direct gravity in one
sweep) and ``pairwise_pass2`` (pressure gradient, with the optional fused
Monaghan viscosity and Balsara div/curl sums), each with

- a wrapper (:func:`pass1`, :func:`pass2`) with the reference's signature.
  It applies the guards that live outside the kernel (h <= 0 -> 1,
  rho <= 0 -> 1, the sound speed of the guarded rho, fbal=None -> ones),
  checks device, dtype, shape and contiguity, and then, for CPU tensors,
  runs the plain version; for CUDA tensors it launches the hand-written
  kernel (``csrc/pairwise_pass*.cu``) on the current stream or raises. It
  never falls back;
- a plain PyTorch version (:func:`pass1_plain`, :func:`pass2_plain`): the
  expressions of the Pallas bodies (q = sqrt(r2) * (1/h), 1/a = min of the
  1/h, one rsqrt) as a [block, n] broadcast over blocks of target rows;
- a launch counter, ``LAUNCHES['pairwise_pass1']`` / ``['pairwise_pass2']``;
- a span, ``psph.kernel.pairwise_pass1`` / ``pairwise_pass2``, around the
  wrapper's CUDA path while a profiler records (``launch.spanned``).

The self pair is masked by index (unlike the windowed kernels) and the
self-density term m_i/(pi h_i^3) is added once. Nothing is padded: the
loops run over the n particles directly. Counts (n_neighbors: q_i < 2;
n_direct: every j != i) are exact between kernel and plain version;
``ops/dense.py`` computes q = r/h with a division instead and can differ
from both by one count at a knife edge.

The plan (:func:`plan`, :func:`plan_for`): a force evaluation on the card
from ``PLAN_MIN_N`` particles on sweeps both passes in one Morton order of
its particles (its keys from one hand kernel, ``pairwise_plan``, then one
stable sort; no host read), so that each warp's 64 targets and each
64-source sub-tile are compact boxes, and a sub-tile whose box is out of
reach of a warp's is culled: pass 2 skips it, pass 1 sweeps it for
gravity's outer branch alone (``csrc/pairwise_pass1.cu``'s note). The
outputs stay in the particles' own order. What bounds the kernels then is
pass 1's far sweep, some 15 instructions a pair, and the near sub-tiles'
pairs. Below a size the plan's launches and host work cost more than the
cull saves: ``PLAN_MIN_N`` is the least of the sizes measured at which
both sweeps with a plan, its build included, took less wall than without
(``chip_smoke.py``'s ``plan n=`` lines, the cold ball, in turns, H100
80GB HBM3 at 700 W; wrapper ms, host work to the last kernel's end, device
ms in brackets): n = 3000 0.51–0.69 (0.156–0.158) against 0.27–0.34 (0.080);
8192 0.52–0.63 (0.285) against 0.38–0.53 (0.190); 16,384 0.84–0.91
(0.525) against 0.76–0.78 (0.539–0.560); 32,768 1.69–1.78 (1.33) against
2.25–2.29 (1.93–1.95). At 16,384 the plan saves a little device time but
adds some 0.1 ms of host work a step, and a step there waits on the host.
The plan's ``counts`` (near and tested (warp, sub-tile) pairs, on the
card) are read only by tools (:func:`near_share`); its span is
``psph.kernel.pairwise_plan``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import eos as eos_ops
from .. import morton
from ..dense import Pass1Out
from .launch import (LAUNCHES, is_cuda, launch, need,  # noqa: F401
                     reset_launches, spanned)

INV_PI = 1.0 / 3.14159265358979323846
KERNELS = ("pairwise_pass1", "pairwise_pass2", "pairwise_plan")
PLAIN_BLOCK = 512         # target rows per [block, n] broadcast
_TARGETS = 256            # targets a block of the kernels (PW_TARGETS)
_TARGET_BLOCKS = 4224     # four waves of 8 blocks on each of the 132 SMs
_MAX_SPLITS = 96
SUB = 64                  # particles a box: a warp's targets, a sub-tile
PLAN_SLOTS = 64           # slots of each of a plan's two counters
# the least n at which a force evaluation sweeps in a plan's order (the
# module's note has its measurement)
PLAN_MIN_N = 32768


def splits_for(n: int) -> int:
    """Source-range splits (blockIdx.y) that give the card enough blocks:
    the targets alone are only n/256 blocks. Four waves of blocks keep the
    last one's share of the time small; at most 96 splits (n = 3000 then
    runs 1152 blocks of some 32 sources each). Under a plan a split takes
    every splits-th sub-tile of SUB sources instead of one range."""
    iblocks = max(1, -(-n // _TARGETS))
    return max(1, min(_MAX_SPLITS, -(-_TARGET_BLOCKS // iblocks)))


# ---------------------------------------------------------------------------
# the plan: a Morton order of the particles for both sweeps
# ---------------------------------------------------------------------------

class Plan(NamedTuple):
    """One force evaluation's order of its particles for the sweeps:
    position p is particle perm[p] (int64 [n]); `counts` (int32 [2,
    PLAN_SLOTS], on the card) the (warp, sub-tile) pairs its sweeps found
    near and tested, each spread over slots (:func:`near_share`)."""
    perm: torch.Tensor
    counts: torch.Tensor


def plan_for(pos):
    """The plan of a force evaluation on the card from PLAN_MIN_N
    particles on, else None (the sweeps in the particles' own order)."""
    if pos.is_cuda and pos.shape[0] >= PLAN_MIN_N:
        return plan(pos)
    return None


def plan_keys_plain(pos):
    """The plan's Morton keys: ``morton.encode`` over the positions' own
    bounds."""
    return morton.encode(pos, pos.amin(dim=0), pos.amax(dim=0))


@spanned("pairwise_plan")
def plan(pos) -> Plan:
    """The Morton order of pos [n,3] (f32 contiguous): 30-bit keys over
    the positions' own bounds (on the card one hand kernel, which also
    zeroes the counters), then one stable sort, so equal keys keep their
    index order and the same positions give the same permutation. Nothing
    is read back to the host."""
    name = "pairwise_plan"
    n = _check_particles(name, pos, [])
    if not is_cuda(name, [pos]):
        keys = plan_keys_plain(pos)
        counts = torch.zeros((2, PLAN_SLOTS), dtype=torch.int32)
    else:
        keys = torch.empty(n, dtype=torch.int32, device=pos.device)
        counts = torch.empty((2, PLAN_SLOTS), dtype=torch.int32,
                             device=pos.device)
        launch(name, [pos, keys, counts, n])
    return Plan(torch.sort(keys, stable=True).indices, counts)


def near_share(plan: Plan):
    """The share of (warp, sub-tile) pairs the sweeps run with `plan` found
    near (swept, not culled), over every pair they tested; None before any
    test. One read from the card: for tools, not for a timed path."""
    near, tested = (int(v) for v in plan.counts.sum(dim=1).tolist())
    return near / tested if tested else None


def _guard(x):
    return torch.where(x > 0, x, 1.0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _spline_w(r2, inv_h):
    r = torch.sqrt(r2)
    q = r * inv_h
    c = INV_PI * (inv_h * inv_h * inv_h)
    q2 = q * q
    inner = (1.0 - 1.5 * q2 + 0.75 * q2 * q) * c
    t = 2.0 - q
    outer = 0.25 * t * t * t * c
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0)), q


def _spline_dw_over_r(r2, inv_h, sign_bug: bool):
    r = torch.sqrt(r2)
    q = r * inv_h
    c = INV_PI * (inv_h * inv_h * inv_h * inv_h)
    lin = 3.0 if sign_bug else -3.0
    inner = (lin + 2.25 * q) * c * inv_h
    r_safe = torch.where(r > 0.0, r, 1.0)
    t = 2.0 - q
    outer = (-0.75 * t * t) * c / r_safe
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def _dyer_ip(dxx, dxy, dxz, r2, m, inv_a):
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    x = (r2 * inv_r) * inv_a
    x2 = x * x
    x3 = x2 * x
    inv_a3 = inv_a * inv_a * inv_a
    inner_mag = (m * inv_a3) * (8.0 - 9.0 * x + 2.0 * x3)
    inner_phi = -(m * inv_a) * (2.4 - 4.0 * x2 + 3.0 * x3 - 0.4 * x2 * x3)
    mr = m * inv_r
    near = x < 1.0
    mag = torch.where(near, inner_mag, mr * inv_r * inv_r)
    phi = torch.where(near, inner_phi, -mr)
    return dxx * mag, dxy * mag, dxz * mag, phi


def _geometry(pos, i0, i1):
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dxx = x[i0:i1, None] - x[None, :]
    dxy = y[i0:i1, None] - y[None, :]
    dxz = z[i0:i1, None] - z[None, :]
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    n = pos.shape[0]
    idx = torch.arange(n, device=pos.device)
    pair = idx[i0:i1, None] != idx[None, :]
    return dxx, dxy, dxz, r2, pair


def _blocks(n, block):
    return [(i0, min(n, i0 + block)) for i0 in range(0, n, block)]


def pass1_plain(pos, h, mass, cfg, block: int = PLAIN_BLOCK) -> Pass1Out:
    """Plain version of :func:`pass1`."""
    n = pos.shape[0]
    inv_h = 1.0 / _guard(h)
    do_gravity = cfg.gravity_solver == "direct"
    receiver = cfg.softening_mode == "receiver_h"
    outs = []
    for i0, i1 in _blocks(n, block):
        dxx, dxy, dxz, r2, pair = _geometry(pos, i0, i1)
        m_eff = torch.where(pair, mass[None, :], 0.0)
        ih_i, ih_j = inv_h[i0:i1, None], inv_h[None, :]
        w_i, q_i = _spline_w(r2, ih_i)
        w_j, _ = _spline_w(r2, ih_j)
        ih = inv_h[i0:i1]
        rho = mass[i0:i1] * INV_PI * ih * ih * ih \
            + (m_eff * 0.5 * (w_i + w_j)).sum(dim=1)
        # W(r, h_i) > 0 exactly where q_i < 2
        nn = (pair & (q_i < 2.0)).sum(dim=1).to(torch.int32)
        if do_gravity:
            inv_a = ih_i.expand_as(r2) if receiver \
                else torch.minimum(ih_i, ih_j)
            gx, gy, gz, phi = _dyer_ip(dxx, dxy, dxz, r2, m_eff, inv_a)
            phi = cfg.g_const * phi.sum(dim=1)
            gphi = cfg.g_const * torch.stack(
                [gx.sum(dim=1), gy.sum(dim=1), gz.sum(dim=1)], dim=-1)
            nd = pair.sum(dim=1).to(torch.int32)
        else:
            phi = torch.zeros_like(rho)
            gphi = torch.zeros((i1 - i0, 3), dtype=rho.dtype,
                               device=rho.device)
            nd = torch.zeros_like(nn)
        outs.append((rho, nn, phi, gphi, nd))
    return Pass1Out(*(torch.cat(p, dim=0) for p in zip(*outs)))


def _pass2_inputs(h, rho, cfg, vel, fbal):
    """The guarded per-particle inputs both versions read."""
    av = cfg.av_alpha > 0.0 and vel is not None
    balsara = cfg.av_balsara and av
    hh = _guard(h)
    rr = _guard(rho)
    cs = eos_ops.sound_speed(rr, cfg.eos_k, cfg.eos_gamma) if av else None
    fb = None
    if balsara:
        fb = fbal if fbal is not None else torch.ones_like(rho)
    return av, balsara, hh, 1.0 / hh, rr, cs, fb


def pass2_plain(pos, h, mass, rho, pressure, cfg, vel=None, fbal=None,
                block: int = PLAIN_BLOCK):
    """Plain version of :func:`pass2`."""
    n = pos.shape[0]
    av, balsara, hh, inv_h, rr, cs, fb = _pass2_inputs(
        h, rho, cfg, vel, fbal)
    asymmetric = cfg.grad_p_mode == "reference_asymmetric"
    sign_bug = cfg.kernel_deriv_sign_bug
    outs = []
    for i0, i1 in _blocks(n, block):
        dxx, dxy, dxz, r2, pair = _geometry(pos, i0, i1)
        m_eff = torch.where(pair, mass[None, :], 0.0)
        ih_i, ih_j = inv_h[i0:i1, None], inv_h[None, :]
        rho_i, rho_j = rr[i0:i1, None], rr[None, :]
        prs_i, prs_j = pressure[i0:i1, None], pressure[None, :]
        gw = 0.5 * (_spline_dw_over_r(r2, ih_i, sign_bug)
                    + _spline_dw_over_r(r2, ih_j, sign_bug))
        if asymmetric:
            coef = m_eff * prs_j / rho_j * gw
        else:
            coef = m_eff * (prs_i / (rho_i * rho_i)
                            + prs_j / (rho_j * rho_j)) * rho_i * gw
        dc = None
        if av:
            dvx = vel[i0:i1, 0, None] - vel[None, :, 0]
            dvy = vel[i0:i1, 1, None] - vel[None, :, 1]
            dvz = vel[i0:i1, 2, None] - vel[None, :, 2]
            vdotr = dvx * dxx + dvy * dxy + dvz * dxz
            hbar = 0.5 * (hh[i0:i1, None] + hh[None, :])
            mu = hbar * vdotr / (r2 + 0.01 * hbar * hbar)
            cbar = 0.5 * (cs[i0:i1, None] + cs[None, :])
            rhobar = 0.5 * (rho_i + rho_j)
            pi_ij = torch.where(
                pair & (vdotr < 0.0),
                (-cfg.av_alpha * cbar * mu + cfg.av_beta * mu * mu) / rhobar,
                0.0)
            if balsara:
                pi_ij = pi_ij * (0.5 * (fb[i0:i1, None] + fb[None, :]))
            if sign_bug:
                gs_av = 0.5 * (_spline_dw_over_r(r2, ih_i, False)
                               + _spline_dw_over_r(r2, ih_j, False))
            else:
                gs_av = gw
            coef = coef + m_eff * pi_ij * gs_av * rho_i
            if balsara:
                g_dc = m_eff * gs_av
                dc = torch.stack(
                    [(g_dc * vdotr).sum(dim=1),
                     (g_dc * (dvy * dxz - dvz * dxy)).sum(dim=1),
                     (g_dc * (dvz * dxx - dvx * dxz)).sum(dim=1),
                     (g_dc * (dvx * dxy - dvy * dxx)).sum(dim=1)], dim=-1)
        gp = torch.stack([(dxx * coef).sum(dim=1), (dxy * coef).sum(dim=1),
                          (dxz * coef).sum(dim=1)], dim=-1)
        outs.append((gp, dc))
    grad_p = torch.cat([o[0] for o in outs], dim=0)
    if balsara:
        return grad_p, torch.cat([o[1] for o in outs], dim=0)
    return grad_p


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_particles(name, pos, fields):
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"{name}: pos has shape {tuple(pos.shape)}, "
                         "expected (n, 3)")
    n = pos.shape[0]
    need(name, "pos", pos, (n, 3))
    for what, t, shape in fields:
        need(name, what, t, shape if shape else (n,))
    return n


def _plan_args(name, plan, pos, words):
    """A launch's plan arguments: perm, work (`words` floats of staged
    copies, then the boxes) and counts; None each without a plan."""
    if plan is None:
        return [None, None, None]
    n = pos.shape[0]
    need(name, "plan.perm", plan.perm, (n,), torch.int64)
    need(name, "plan.counts", plan.counts, (2, PLAN_SLOTS), torch.int32)
    is_cuda(name, [pos, plan.perm, plan.counts])
    work = torch.empty(-(-words // 4) * 4 + 8 * -(-n // SUB),
                       dtype=torch.float32, device=pos.device)
    return [plan.perm, work, plan.counts]


@spanned("pairwise_pass1")
def pass1(pos, h, mass, cfg, plan: Plan | None = None) -> Pass1Out:
    """Density, neighbour count and (gravity_solver='direct') Dyer-Ip
    gravity over all pairs. pos [n,3], h [n], mass [n], f32 contiguous on
    one device. Returns ``dense.Pass1Out`` (rho, n_neighbors, phi,
    grad_phi, n_direct); with another gravity solver phi, grad_phi and
    n_direct are zero. With a `plan` (:func:`plan`) the kernel sweeps in
    its order and culls far sub-tiles; the outputs are in the particles'
    own order either way (the plain version ignores it)."""
    name = "pairwise_pass1"
    cuda = is_cuda(name, [pos, h, mass])
    n = _check_particles(name, pos, [("h", h, None), ("mass", mass, None)])
    if not cuda:
        return pass1_plain(pos, h, mass, cfg)
    dev = pos.device
    inv_h = 1.0 / _guard(h)
    splits = splits_for(n)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    rho, phi, gphi = f32(n), f32(n), f32(n, 3)
    nn, nd = i32(n), i32(n)
    launch(name, [pos, inv_h, mass, *_plan_args(name, plan, pos, 5 * n),
                  rho, nn, phi, gphi, nd,
                  f32(splits, 5, n), i32(splits, 2, n), n, splits,
                  int(cfg.gravity_solver == "direct"),
                  int(cfg.softening_mode == "receiver_h"),
                  float(cfg.g_const)])
    return Pass1Out(rho, nn, phi, gphi, nd)


@spanned("pairwise_pass2")
def pass2(pos, h, mass, rho, pressure, cfg, vel=None, fbal=None,
          plan: Plan | None = None):
    """Pressure gradient grad P [n,3] over all pairs
    (cfg.grad_p_mode 'symmetric' or 'reference_asymmetric', with
    cfg.kernel_deriv_sign_bug).

    With `vel` and cfg.av_alpha > 0 the Monaghan viscosity is fused into
    the sweep as -rho_i a_AV. Under cfg.av_balsara `fbal` (the lagged
    limiter factors, default 1) scales Pi_ij by 0.5 (f_i + f_j) and the
    raw div/curl sums dc [n,4] are returned second. `plan`: as in
    :func:`pass1`; a far sub-tile is neither staged nor swept."""
    name = "pairwise_pass2"
    if cfg.grad_p_mode not in ("symmetric", "reference_asymmetric"):
        raise ValueError(f"{name}: grad_p_mode={cfg.grad_p_mode!r}")
    tensors = [pos, h, mass, rho, pressure]
    fields = [("h", h, None), ("mass", mass, None), ("rho", rho, None),
              ("pressure", pressure, None)]
    if vel is not None:
        tensors.append(vel)
        fields.append(("vel", vel, tuple(pos.shape)))
    if fbal is not None:
        tensors.append(fbal)
        fields.append(("fbal", fbal, None))
    cuda = is_cuda(name, tensors)
    n = _check_particles(name, pos, fields)
    if not cuda:
        return pass2_plain(pos, h, mass, rho, pressure, cfg, vel=vel,
                           fbal=fbal)
    dev = pos.device
    av, balsara, hh, inv_h, rr, cs, fb = _pass2_inputs(
        h, rho, cfg, vel, fbal)
    splits = splits_for(n)
    f32 = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    gp = f32(n, 3)
    dc = f32(n, 4) if balsara else None
    launch(name, [pos, inv_h, mass, rr, pressure,
                  vel if av else None, hh if av else None, cs, fb,
                  *_plan_args(name, plan, pos, 13 * n), gp, dc,
                  f32(splits, 7 if balsara else 3, n), n, splits,
                  int(cfg.grad_p_mode == "reference_asymmetric"),
                  int(cfg.kernel_deriv_sign_bug), int(av), int(balsara),
                  float(cfg.av_alpha), float(cfg.av_beta)])
    return (gp, dc) if balsara else gp
