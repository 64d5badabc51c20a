"""Windowed block-pair kernels of the production step (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/pallas/groups2.py`` (the Pallas
sweeps) and ``ops/pallas/fallback.py`` (their CPU forms). Four kernels,
each with

- a wrapper (:func:`filter_sph`, :func:`pass1_gradh`, :func:`pass2`,
  :func:`gravity_fused`) that checks device, dtype, shape and contiguity.
  For CPU tensors it runs the plain version; for CUDA tensors it launches
  the hand-written CUDA kernel (``csrc/<name>.cu``) on the current stream
  or raises — it never falls back;
- a plain PyTorch version (``*_plain``): the same math as one masked
  [G, B, S] broadcast contraction, the counterpart of ``fallback.py``;
- a launch counter, ``LAUNCHES[name]`` (shared by every kernel module, see
  ``launch.py``), incremented only where the wrapper launches its kernel.

The shared contract (``groups2.py:6-40`` of the reference): targets are
[G*B, 1] sorted-layout columns, sources [G, S] window rows of which the
first nv[g] slots are valid, padding slots carry m = 0, outputs are
[G*B, 1] columns. Self pairs are included: counts include them and the
fused gravity potential includes the -2.4 m/a self term; callers correct.
"""

from __future__ import annotations

import torch

from .launch import (LAUNCHES, is_cuda as _is_cuda, launch as _launch,
                     need as _need, reset_launches)

INV_PI = 1.0 / 3.14159265358979323846
KERNELS = ("filter_sph", "pass1_gradh", "pass2", "gravity_fused")


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check_window(name, nv, tgt, rows, b):
    g, s = rows[0].shape
    _need(name, "nv", nv, (g,), torch.int32)
    for k, t in enumerate(tgt):
        _need(name, f"target column {k}", t, (g * b, 1))
    for k, r in enumerate(rows):
        _need(name, f"source row {k}", r, (g, s))
    return g, s


def _out(like, g, b, n, dtype=torch.float32):
    return [torch.empty((g * b, 1), dtype=dtype, device=like.device)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# plain versions (the fallback.py counterparts)
# ---------------------------------------------------------------------------

def _shape(tgt, src):
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    return (g, b, s, [x.reshape(g, b, 1) for x in tgt],
            [r[:, None, :] for r in src])


def _slot_mask(nv, g, s):
    return (torch.arange(s, device=nv.device)[None, None, :]
            < nv.reshape(g, 1, 1))


def _col(x, dtype=torch.float32):
    return x.reshape(-1, 1).to(dtype)


def _dyer_ip(m, dxx, dxy, dxz, r2, inv_a):
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
    return phi, dxx * mag, dxy * mag, dxz * mag


def filter_sph_plain(nv, tgt, src):
    g, b, s, (tx, ty, tz, tc, tsk), (sx, sy, sz, sc, ssk, sm) = \
        _shape(tgt, src)
    valid = _slot_mask(nv, g, s)
    dxx = tx - sx
    dxy = ty - sy
    dxz = tz - sz
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    cut = torch.maximum(tc, sc) + tsk + ssk
    pred = (r2 < cut * cut) & valid & (sm > 0.0)
    return pred.any(dim=1).to(torch.float32)


def pass1_gradh_plain(nv, tgt, src):
    g, b, s, (tx, ty, tz, tih), (sx, sy, sz, sm) = _shape(tgt, src)
    valid = _slot_mask(nv, g, s)
    dxx = tx - sx
    dxy = ty - sy
    dxz = tz - sz
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    m = torch.where(valid, sm, 0.0)
    q = torch.sqrt(r2) * tih
    q2 = q * q
    q3 = q2 * q
    inner = 1.0 - 1.5 * q2 + 0.75 * q3
    t = 2.0 - q
    tsq = t * t
    wpoly = torch.where(q < 1.0, inner,
                        torch.where(q < 2.0, 0.25 * tsq * t, 0.0))
    dhpoly = torch.where(q < 1.0, 3.0 * inner - 3.0 * q2 + 2.25 * q3,
                         torch.where(q < 2.0, 0.75 * tsq * (t - q), 0.0))
    s_rho = (m * wpoly).sum(dim=2)
    s_xi = (m * dhpoly).sum(dim=2)
    s_nn = ((q < 2.0) & (m > 0.0)).sum(dim=2)
    ih = tih[:, :, 0]
    ci3 = INV_PI * (ih * ih * ih)
    return (_col(ci3 * s_rho), _col(s_nn, torch.int32),
            _col(-(ci3 * ih) * s_xi))


def _gw_from(q, inv_h, inv_h4, inv_r):
    inner = -3.0 + 2.25 * q
    t = 2.0 - q
    outer = -0.75 * t * t
    val = torch.where(q < 1.0, inner * inv_h,
                      torch.where(q < 2.0, outer * inv_r, 0.0))
    return (INV_PI * inv_h4) * val


def pass2_plain(nv, tgt, src, *, nv_p2p, p2p_rows, g_const=1.0):
    g, b, s, (tx, ty, tz, tih, tc), (sx, sy, sz, sih, sm, scc) = \
        _shape(tgt, src)
    valid = _slot_mask(nv, g, s)
    dxx = tx - sx
    dxy = ty - sy
    dxz = tz - sz
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    m = torch.where(valid, sm, 0.0)
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    r = r2 * inv_r
    tih4 = tih * tih
    tih4 = tih4 * tih4
    sih4 = sih * sih
    sih4 = sih4 * sih4
    gw_i = _gw_from(r * tih, tih, tih4, inv_r)
    gw_j = _gw_from(r * sih, sih, sih4, inv_r)
    coef = m * (tc * gw_i + scc * gw_j)
    red = lambda v: v.sum(dim=2)
    gp = [red(dxx * coef), red(dxy * coef), red(dxz * coef)]
    grav = [red(v) for v in _dyer_ip(m, dxx, dxy, dxz, r2,
                                     torch.minimum(tih, sih))]
    nd = (m > 0.0).sum(dim=2).expand(g, b)
    # residual-P2P merge: the second window into the same gravity sums
    s2 = p2p_rows[0].shape[1]
    px, py, pz, pih, pm = (r_[:, None, :] for r_ in p2p_rows)
    pmv = torch.where(_slot_mask(nv_p2p, g, s2), pm, 0.0)
    ddx = tx - px
    ddy = ty - py
    ddz = tz - pz
    rr2 = ddx * ddx + ddy * ddy + ddz * ddz
    grav2 = _dyer_ip(pmv, ddx, ddy, ddz, rr2, torch.minimum(tih, pih))
    grav = [a + red(v) for a, v in zip(grav, grav2)]
    nd = nd + (pmv > 0.0).sum(dim=2).expand(g, b)
    return tuple([_col(v) for v in gp]
                 + [_col(g_const * v) for v in grav]
                 + [_col(nd, torch.int32)])


def _mono_quad(m, dxx, dxy, dxz, quad):
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    mag = m * inv_r * inv_r * inv_r
    phi = -m * inv_r
    gx, gy, gz = dxx * mag, dxy * mag, dxz * mag
    if quad is not None:
        qxx, qxy, qxz, qyy, qyz, qzz = quad
        # the live mask multiplies FIRST: a masked entry at r ~ 0 has
        # ir2*ir2 = inf, and inf * 0 would be NaN
        live = torch.where(m > 0.0, 1.0, 0.0)
        qdx = qxx * dxx + qxy * dxy + qxz * dxz
        qdy = qxy * dxx + qyy * dxy + qyz * dxz
        qdz = qxz * dxx + qyz * dxy + qzz * dxz
        dqd = dxx * qdx + dxy * qdy + dxz * qdz
        ir2 = inv_r * inv_r
        ir5 = live * ir2 * ir2 * inv_r
        ir7dqd = 2.5 * dqd * ir5 * ir2
        phi = phi - 0.5 * dqd * ir5
        gx = gx - qdx * ir5 + dxx * ir7dqd
        gy = gy - qdy * ir5 + dxy * ir7dqd
        gz = gz - qdz * ir5 + dxz * ir7dqd
    return phi, gx, gy, gz


def gravity_fused_plain(nv_ring, tgt, ring_rows, far_rows, accept, *,
                        g_const=1.0):
    nm = len(ring_rows)
    g = ring_rows[0].shape[0]
    b = tgt[0].shape[0] // g
    tx, ty, tz, _ = (x.reshape(g, b, 1) for x in tgt)

    def tier(rows, valid):
        cm, cx, cy, cz = (r[:, None, :] for r in rows[:4])
        m = torch.where(valid & (cm > 0.0), cm, 0.0)
        quad = (tuple(r[:, None, :] for r in rows[4:10]) if nm == 10
                else None)
        parts = _mono_quad(m, tx - cx, ty - cy, tz - cz, quad)
        return [v.sum(dim=2) for v in parts] + [(m > 0.0).sum(dim=2)]

    ring = tier(ring_rows, _slot_mask(nv_ring, g, ring_rows[0].shape[1]))
    # far tier: [1, NBpad] moments broadcast under the [G, NBpad] mask
    far = [r.expand(g, r.shape[1]) for r in far_rows]
    far = [torch.where(accept > 0.5, far[0], 0.0)] + far[1:]
    far_t = tier(far, torch.ones((g, 1, far[0].shape[1]), dtype=torch.bool,
                                 device=accept.device))
    tot = [a + c for a, c in zip(ring, far_t)]
    na = tot[4].expand(g, b)
    return (_col(g_const * tot[0]), _col(g_const * tot[1]),
            _col(g_const * tot[2]), _col(g_const * tot[3]),
            _col(torch.zeros_like(na), torch.int32), _col(na, torch.int32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def filter_sph(nv, tgt, src, *, b):
    """Per-candidate true-interaction mask over the group's window.

    tgt cols ([G*B,1]): x, y, z, kappa_eff*h, skin. src rows ([G,S]): x,
    y, z, kappa_eff*h, skin, m. Returns f32 [G, S] (1.0 = some target of
    the group interacts)."""
    name = "filter_sph"
    if len(tgt) != 5 or len(src) != 6:
        raise ValueError(f"{name}: 5 target columns and 6 source rows")
    cuda = _is_cuda(name, [nv, *tgt, *src])
    g, s = _check_window(name, nv, tgt, src, b)
    if not cuda:
        return filter_sph_plain(nv, tgt, src)
    keep = torch.empty((g, s), dtype=torch.float32, device=nv.device)
    _launch(name, [*tgt, *src, nv, keep, g, b, s])
    return keep


def pass1_gradh(nv, tgt, src, *, b):
    """Grad-h density sweep: tgt = (x, y, z, ih) cols, src = (x, y, z, m)
    rows. Returns (rho, nn, xi) [G*B,1]; nn INCLUDES the self pair."""
    name = "pass1_gradh"
    if len(tgt) != 4 or len(src) != 4:
        raise ValueError(f"{name}: 4 target columns and 4 source rows")
    cuda = _is_cuda(name, [nv, *tgt, *src])
    g, s = _check_window(name, nv, tgt, src, b)
    if not cuda:
        return pass1_gradh_plain(nv, tgt, src)
    rho, xi = _out(nv, g, b, 2)
    (nn,) = _out(nv, g, b, 1, torch.int32)
    _launch(name, [*tgt, *src, nv, rho, nn, xi, g, b, s])
    return rho, nn, xi


def pass2(nv, tgt, src, *, b, nv_p2p, p2p_rows, g_const=1.0):
    """Grad-h pressure-gradient sweep with fused near-field gravity and the
    merged residual-P2P window (mode 'grad_h', grav=True, min-h softening).

    tgt cols: x, y, z, ih, tc (tc = P/(Omega rho^2)). src rows: x, y, z,
    ih, m, cc. p2p_rows: x, y, z, ih, m of the residual-P2P window, valid
    to nv_p2p. Returns (gpx, gpy, gpz) — the caller applies the target rho
    scale — and (phi, gx, gy, gz) scaled by g_const, then n_direct; phi
    includes the self term and n_direct the self pair."""
    name = "pass2"
    if len(tgt) != 5 or len(src) != 6 or len(p2p_rows) != 5:
        raise ValueError(f"{name}: 5 target columns, 6 SPH rows and 5 "
                         "P2P rows")
    cuda = _is_cuda(name, [nv, nv_p2p, *tgt, *src, *p2p_rows])
    g, s = _check_window(name, nv, tgt, src, b)
    g2, s2 = _check_window(name, nv_p2p, tgt, p2p_rows, b)
    if not cuda:
        return pass2_plain(nv, tgt, src, nv_p2p=nv_p2p, p2p_rows=p2p_rows,
                           g_const=g_const)
    outs = _out(nv, g, b, 7)
    (nd,) = _out(nv, g, b, 1, torch.int32)
    _launch(name, [*tgt, *src, *p2p_rows, nv, nv_p2p, *outs, nd, g, b, s,
                   s2, float(g_const)])
    return (*outs, nd)


def gravity_fused(nv_ring, tgt, ring_rows, far_rows, accept, *, b,
                  g_const=1.0):
    """Far-tier gravity in one launch: windowed ring multipoles plus the
    dense far scan (has_p2p=False and no block tier, the RESPA outer force).

    tgt cols: x, y, z, ih. ring_rows: 4 (m, cmx, cmy, cmz) or 10 (+ Qxx,
    Qxy, Qxz, Qyy, Qyz, Qzz) [G, Sr] rows valid to nv_ring. far_rows: the
    same fields as [1, NBpad] rows. accept: [G, NBpad] f32 frozen MAC mask.
    Returns (phi, gx, gy, gz, n_direct (= 0), n_approx)."""
    name = "gravity_fused"
    nm = len(ring_rows)
    if nm not in (4, 10) or len(far_rows) != nm or len(tgt) != 4:
        raise ValueError(f"{name}: 4 target columns and 4 or 10 moment "
                         "fields for both tiers")
    cuda = _is_cuda(name, [nv_ring, *tgt, *ring_rows, *far_rows, accept])
    g, sr = _check_window(name, nv_ring, tgt, ring_rows, b)
    nbpad = far_rows[0].shape[1]
    for k, r in enumerate(far_rows):
        _need(name, f"far row {k}", r, (1, nbpad))
    _need(name, "accept", accept, (g, nbpad))
    if not cuda:
        return gravity_fused_plain(nv_ring, tgt, ring_rows, far_rows,
                                   accept, g_const=g_const)
    outs = _out(nv_ring, g, b, 4)
    nd, na = _out(nv_ring, g, b, 2, torch.int32)
    none = [0] * (10 - nm)
    _launch(name, [*tgt, *ring_rows, *none, nv_ring, *far_rows, *none,
                   accept, *outs, nd, na, g, b, sr, nbpad, nm,
                   float(g_const)])
    return (*outs, nd, na)
