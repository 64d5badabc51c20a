"""Windowed block-pair kernels of the production step (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/pallas/groups2.py`` (the Pallas
sweeps) and ``ops/pallas/fallback.py`` (their CPU forms). Six kernels,
each with

- a wrapper (:func:`filter_sph`, :func:`pass1_gradh`, :func:`pass1_sym`,
  :func:`pass2`, :func:`p2p`, :func:`gravity_fused`) that checks device,
  dtype, shape and contiguity.
  For CPU tensors it runs the plain version; for CUDA tensors it launches
  the hand-written CUDA kernel (``csrc/<name>.cu``) on the current stream
  or raises — it never falls back;
- a plain PyTorch version (``*_plain``): the same math as one masked
  [G, B, S] broadcast contraction, the counterpart of ``fallback.py``;
- a launch counter, ``LAUNCHES[name]`` (shared by every kernel module, see
  ``launch.py``), incremented only where the wrapper launches its kernel;
  ``p2p`` and ``gravity_fused`` also count their bfloat16 instances'
  launches (``bf16=True``) in ``BF16_LAUNCHES[name]``.

The shared contract (``groups2.py:6-40`` of the reference): targets are
[G*B, 1] sorted-layout columns, sources [G, S] window rows of which the
first nv[g] slots are valid, padding slots carry m = 0, outputs are
[G*B, 1] columns. Self pairs are included: counts include them and the
fused gravity potential includes the -2.4 m/a self term; callers correct.
"""

from __future__ import annotations

import torch

from .launch import (BF16_LAUNCHES, LAUNCHES,  # noqa: F401
                     is_cuda as _is_cuda, launch as _launch, need as _need,
                     need_all as _need_all, reset_launches)

INV_PI = 1.0 / 3.14159265358979323846
KERNELS = ("filter_sph", "pass1_gradh", "pass1_sym", "pass2", "p2p",
           "gravity_fused")
MODES = ("grad_h", "reference_asymmetric", "symmetric")   # the C interface's


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check_window(name, nv, tgt, rows, b, g=None):
    """Check one window (nv, its rows) and the target columns `tgt` (none
    where the caller has checked them already; then `g` is the groups the
    rows must have). Returns (groups, slots)."""
    g0, s = rows[0].shape
    if g is not None and g0 != g:
        raise ValueError(f"{name}: a window of {g0} groups, expected {g}")
    _need(name, "nv", nv, (g0,), torch.int32)
    _need_all(name, "target column", tgt, (g0 * b, 1))
    _need_all(name, "source row", rows, (g0, s))
    return g0, s


def _out(like, g, b, n, dtype=torch.float32):
    return [torch.empty((g * b, 1), dtype=dtype, device=like.device)
            for _ in range(n)]


def _out_block(like, g, b, n_f, n_i):
    """n_f float32 and then n_i int32 [G*B, 1] outputs as views of one
    allocation (one allocation costs less host time than n_f + n_i)."""
    outs = torch.empty((n_f + n_i, g * b, 1), dtype=torch.float32,
                       device=like.device).unbind(0)
    return list(outs[:n_f]), [o.view(torch.int32) for o in outs[n_f:]]


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


# bfloat16 pair math (``grav_pair_dtype="bfloat16"``) follows the
# reference's rounding points, as its branch runs on the CPU: the
# separations, r2, 1/r, x, the x < 1 test and the m > 0 count stay f32;
# dx, x, m, 1/a and 1/r are rounded to bf16, every bf16 operation rounds
# its result, the constants are bf16 (JAX rounds its weak-typed scalars:
# 2.4 -> 2.40625, 0.4 -> 0.400390625), the last product before each cast
# back to f32 is exact (a bf16 x bf16 product fits f32) and the sums are
# f32.
_BF16 = torch.bfloat16


def _bf(v):
    return v.to(_BF16)


def _bk(v, like):
    """The constant v as a bf16 scalar tensor (a Python float would enter
    a bf16 operation unrounded)."""
    return torch.tensor(v, dtype=_BF16, device=like.device)


def _dyer_ip_bf16(m, dxx, dxy, dxz, x, inv_a, inv_r, near):
    dxb, dyb, dzb = _bf(dxx), _bf(dxy), _bf(dxz)
    xb, mb, iab, irb = _bf(x), _bf(m), _bf(inv_a), _bf(inv_r)
    k = lambda v: _bk(v, x)  # noqa: E731
    x2 = xb * xb
    x3 = x2 * xb
    inv_a3 = iab * iab * iab
    inner_mag = (mb * inv_a3) * (k(8.0) - k(9.0) * xb + k(2.0) * x3)
    inner_phi = -(mb * iab) * (k(2.4) - k(4.0) * x2 + k(3.0) * x3
                               - k(0.4) * x2 * x3)
    mr = mb * irb
    mag = torch.where(near, inner_mag, mr * irb * irb).float()
    # phi passes the select as a rounded bf16 value
    phi = torch.where(near, inner_phi, -mr).float()
    return phi, dxb.float() * mag, dyb.float() * mag, dzb.float() * mag


def _dyer_ip(m, dxx, dxy, dxz, r2, inv_a, bf16=False):
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    x = (r2 * inv_r) * inv_a
    if bf16:
        return _dyer_ip_bf16(m, dxx, dxy, dxz, x, inv_a, inv_r, x < 1.0)
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


def _w_poly(q):
    q2 = q * q
    inner = 1.0 - 1.5 * q2 + 0.75 * q2 * q
    t = 2.0 - q
    outer = 0.25 * t * t * t
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def pass1_sym_plain(nv, tgt, src):
    g, b, s, (tx, ty, tz, tih), (sx, sy, sz, sih, sm) = _shape(tgt, src)
    valid = _slot_mask(nv, g, s)
    dxx = tx - sx
    dxy = ty - sy
    dxz = tz - sz
    r = torch.sqrt(dxx * dxx + dxy * dxy + dxz * dxz)
    m = torch.where(valid, sm, 0.0)
    q = r * tih
    cj3 = sih * sih * sih
    s_rho = (m * _w_poly(q)).sum(dim=2)
    s_rhoj = (m * _w_poly(r * sih) * cj3).sum(dim=2)
    s_nn = ((q < 2.0) & (m > 0.0)).sum(dim=2)
    ih = tih[:, :, 0]
    ci3 = ih * ih * ih
    return (_col((0.5 * INV_PI) * (ci3 * s_rho + s_rhoj)),
            _col(s_nn, torch.int32))


def _gw_from(q, inv_h, inv_h4, inv_r, sign_bug=False):
    inner = (3.0 if sign_bug else -3.0) + 2.25 * q
    t = 2.0 - q
    outer = -0.75 * t * t
    val = torch.where(q < 1.0, inner * inv_h,
                      torch.where(q < 2.0, outer * inv_r, 0.0))
    return (INV_PI * inv_h4) * val


def _p2p_window(nv, rows, g, b, tx, ty, tz, tih, receiver_soft,
                bf16=False):
    """Dyer-Ip sums over one P2P window: ([phi, gx, gy, gz] as [g, b], the
    per-target count of slots with m > 0); `bf16`: the pair polynomial in
    bfloat16."""
    s = rows[0].shape[1]
    r3 = [r[:, None, :] for r in rows]
    if receiver_soft:
        px, py, pz, pm = r3
        inv_a = tih
    else:
        px, py, pz, pih, pm = r3
        inv_a = torch.minimum(tih, pih)
    m = torch.where(_slot_mask(nv, g, s), pm, 0.0)
    dxx = tx - px
    dxy = ty - py
    dxz = tz - pz
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    sums = [v.sum(dim=2)
            for v in _dyer_ip(m, dxx, dxy, dxz, r2, inv_a, bf16)]
    return sums, (m > 0.0).sum(dim=2).expand(g, b)


def p2p_plain(nv, tgt, src, *, receiver_soft, g_const=1.0, bf16=False):
    g = src[0].shape[0]
    b = tgt[0].shape[0] // g
    tx, ty, tz, tih = (x.reshape(g, b, 1) for x in tgt)
    sums, nd = _p2p_window(nv, src, g, b, tx, ty, tz, tih, receiver_soft,
                           bf16)
    return tuple([_col(g_const * v) for v in sums]
                 + [_col(nd, torch.int32)])


def pass2_plain(nv, tgt, src, *, mode="grad_h", av=False, sign_bug=False,
                av_alpha=0.0, av_beta=0.0, balsara=False, energy=False,
                grav=False, receiver_soft=False, g_const=1.0, nv_p2p=None,
                p2p_rows=None):
    g, s = src[0].shape
    b = tgt[0].shape[0] // g
    it = iter(x.reshape(g, b, 1) for x in tgt)
    sit = iter(r[:, None, :] for r in src)
    tx, ty, tz, tih = (next(it) for _ in range(4))
    tc = next(it) if mode != "reference_asymmetric" else None
    sx, sy, sz, sih, sm, scc = (next(sit) for _ in range(6))
    valid = _slot_mask(nv, g, s)
    dxx = tx - sx
    dxy = ty - sy
    dxz = tz - sz
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    m = torch.where(valid, sm, 0.0)
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    r = r2 * inv_r
    q = r * tih
    qj = r * sih
    tih4 = tih * tih
    tih4 = tih4 * tih4
    sih4 = sih * sih
    sih4 = sih4 * sih4
    gw_i = _gw_from(q, tih, tih4, inv_r, sign_bug)
    gw_j = _gw_from(qj, sih, sih4, inv_r, sign_bug)
    if mode == "grad_h":
        coef = m * (tc * gw_i + scc * gw_j)
    elif mode == "reference_asymmetric":
        coef = m * scc * (0.5 * (gw_i + gw_j))
    else:
        coef = m * (tc + scc) * (0.5 * (gw_i + gw_j))
    red = lambda v: _col(v.sum(dim=2))
    outs = [red(dxx * coef), red(dxy * coef), red(dxz * coef)]
    if av or energy:
        tvx, tvy, tvz = (next(it) for _ in range(3))
        svx, svy, svz = (next(sit) for _ in range(3))
        dvx = tvx - svx
        dvy = tvy - svy
        dvz = tvz - svz
        vdotr = dvx * dxx + dvy * dxy + dvz * dxz
    if av:
        th, tcs, trho = (next(it) for _ in range(3))
        sh, scs, srho = (next(sit) for _ in range(3))
        hbar = 0.5 * (th + sh)
        # slots past nv hold whatever the gather left there (zeros in the
        # padding): they are selected out BEFORE the divisions, as the
        # kernel never visits them
        den = torch.where(valid, r2 + 0.01 * hbar * hbar, 1.0)
        mu = hbar * vdotr / den
        cbar = 0.5 * (tcs + scs)
        rhobar = torch.where(valid, 0.5 * (trho + srho), 1.0)
        pi_ij = torch.where(valid & (vdotr < 0.0),
                            (-av_alpha * cbar * mu + av_beta * mu * mu)
                            / rhobar, 0.0)
        if balsara:
            pi_ij = pi_ij * (0.5 * (next(it) + next(sit)))
        if sign_bug:
            # the viscosity always takes the correct derivative
            gs_av = 0.5 * (_gw_from(q, tih, tih4, inv_r)
                           + _gw_from(qj, sih, sih4, inv_r))
        else:
            gs_av = 0.5 * (gw_i + gw_j)
        cav = m * pi_ij * gs_av
        outs += [red(dxx * cav), red(dxy * cav), red(dxz * cav)]
        if balsara:
            g_dc = m * gs_av
            outs += [red(g_dc * vdotr),
                     red(g_dc * (dvy * dxz - dvz * dxy)),
                     red(g_dc * (dvz * dxx - dvx * dxz)),
                     red(g_dc * (dvx * dxy - dvy * dxx))]
    if energy:
        # conjugate energy equation on the same pair quantities: pressure
        # work plus half the viscous dissipation, complete as summed
        if mode == "grad_h":
            du = tc * (m * gw_i) * vdotr
        else:
            du = 0.5 * coef * vdotr
        if av:
            du = du + 0.5 * cav * vdotr
        outs.append(red(du))
    if grav:
        inv_a = tih if receiver_soft else torch.minimum(tih, sih)
        sums = [v.sum(dim=2)
                for v in _dyer_ip(m, dxx, dxy, dxz, r2, inv_a)]
        nd = (m > 0.0).sum(dim=2).expand(g, b)
        if p2p_rows is not None:
            # residual-P2P merge: the second window into the same sums
            sums2, nd2 = _p2p_window(nv_p2p, p2p_rows, g, b, tx, ty, tz,
                                     tih, receiver_soft)
            sums = [a + c for a, c in zip(sums, sums2)]
            nd = nd + nd2
        outs += [_col(g_const * v) for v in sums] + [_col(nd, torch.int32)]
    return tuple(outs)


def _mono_quad(m, dxx, dxy, dxz, quad, bf16=False):
    r2 = dxx * dxx + dxy * dxy + dxz * dxz
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    if bf16:
        # the monopole in bf16 (phi and g the exact products of their last
        # two factors); the quadrupole stays f32, on the f32 separations
        mb, irb = _bf(m), _bf(inv_r)
        mag = (mb * irb * irb * irb).float()
        phi = -(mb.float() * irb.float())
        gx, gy, gz = (_bf(d).float() * mag for d in (dxx, dxy, dxz))
    else:
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
                        g_const=1.0, nv_p2p=None, p2p_rows=None,
                        receiver_soft=False, nv_blk=None, blk_rows=None,
                        bf16=False):
    nm = len(ring_rows)
    g = ring_rows[0].shape[0]
    b = tgt[0].shape[0] // g
    tx, ty, tz, tih = (x.reshape(g, b, 1) for x in tgt)

    def tier(rows, valid):
        cm, cx, cy, cz = (r[:, None, :] for r in rows[:4])
        m = torch.where(valid & (cm > 0.0), cm, 0.0)
        quad = (tuple(r[:, None, :] for r in rows[4:10]) if nm == 10
                else None)
        parts = _mono_quad(m, tx - cx, ty - cy, tz - cz, quad, bf16)
        return [v.sum(dim=2) for v in parts] + [(m > 0.0).sum(dim=2)]

    # the TPU kernel's order: near tier, ring, blk, far scan
    tot = [0.0] * 4
    nd = None
    if p2p_rows is not None:
        # near tier: its count is n_direct, its sums open the totals
        tot, nd = _p2p_window(nv_p2p, p2p_rows, g, b, tx, ty, tz, tih,
                              receiver_soft, bf16)
    ring = tier(ring_rows, _slot_mask(nv_ring, g, ring_rows[0].shape[1]))
    if blk_rows is not None:
        # supergroup partition: windowed block moments, same pair body
        blk = tier(blk_rows, _slot_mask(nv_blk, g, blk_rows[0].shape[1]))
        ring = [a + c for a, c in zip(ring, blk)]
    # far tier: [1, NBpad] moments broadcast under the [G, NBpad] mask
    far = [r.expand(g, r.shape[1]) for r in far_rows]
    far = [torch.where(accept > 0.5, far[0], 0.0)] + far[1:]
    far_t = tier(far, torch.ones((g, 1, far[0].shape[1]), dtype=torch.bool,
                                 device=accept.device))
    tot = [a + r + f for a, r, f in zip(tot, ring[:4], far_t[:4])]
    na = (ring[4] + far_t[4]).expand(g, b)
    if nd is None:
        nd = torch.zeros_like(na)
    return (_col(g_const * tot[0]), _col(g_const * tot[1]),
            _col(g_const * tot[2]), _col(g_const * tot[3]),
            _col(nd, torch.int32), _col(na, torch.int32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

# targets of a group filter_sph holds in one block's shared memory (the
# H100's 227 KB a block: FILTER_MAX_DYNAMIC, csrc/filter_sph.cu); a larger
# group is cut into tiles of at most this many targets
FILTER_MAX_GROUP = 9820
# targets of one pre-reject box (PSPH_FILTER_BOX, csrc/filter_sph.cu)
FILTER_BOX = 16
# blocks of the tiled path's grid a multiprocessor, at the least: the
# groups past FILTER_MAX_GROUP are few (8 at b = 16,384 and n = 100,000),
# so they are cut into more tiles than shared memory asks for
FILTER_BLOCKS_PER_SM = 2


def filter_tiles(b, g=1, blocks=1):
    """(T, tile): the tiles of `tile` targets a group of `b` takes on the
    tiled path: as few as fit one block and give the `g` groups `blocks`
    blocks in all (no tile below one box), as even as they can be, and a
    whole number of boxes where that fits (then each tile's boxes are
    the one-block path's). The mask is the same whatever the tiles."""
    tiles = max(-(-b // FILTER_MAX_GROUP),
                min(-(-blocks // g), -(-b // FILTER_BOX)))
    tile = -(-b // tiles)
    boxed = -(-tile // FILTER_BOX) * FILTER_BOX
    tile = boxed if boxed <= FILTER_MAX_GROUP else tile
    return -(-b // tile), tile


def filter_sph(nv, tgt, src, *, b):
    """Per-candidate true-interaction mask over the group's window.

    tgt cols ([G*B,1]): x, y, z, kappa_eff*h, skin. src rows ([G,S]): x,
    y, z, kappa_eff*h, skin, m. Returns f32 [G, S] (1.0 = some target of
    the group interacts). A group of more than FILTER_MAX_GROUP targets
    takes the kernel's tiled path (filter_tiles, FILTER_BLOCKS_PER_SM
    blocks a multiprocessor): one block a (group, tile), the tiles' masks
    ORed; the same mask."""
    name = "filter_sph"
    if len(tgt) != 5 or len(src) != 6:
        raise ValueError(f"{name}: 5 target columns and 6 source rows")
    cuda = _is_cuda(name, [nv, *tgt, *src])
    g, s = _check_window(name, nv, tgt, src, b)
    if not cuda:
        return filter_sph_plain(nv, tgt, src)
    keep = torch.empty((g, s), dtype=torch.float32, device=nv.device)
    if b <= FILTER_MAX_GROUP:
        _launch(name, [*tgt, *src, nv, keep, None, g, b, s, 0])
    else:
        # the tiles' masks [T, g, s], then their targets [5, T, g, tile]
        sms = torch.cuda.get_device_properties(
            nv.device).multi_processor_count
        tiles, tile = filter_tiles(b, g, FILTER_BLOCKS_PER_SM * sms)
        scratch = torch.empty(tiles * g * (s + 5 * tile),
                              dtype=torch.float32, device=nv.device)
        _launch(name, [*tgt, *src, nv, keep, scratch, g, b, s, tile])
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


def pass1_sym(nv, tgt, src, *, b):
    """Symmetric-density sweep: tgt = (x, y, z, ih) cols, src = (x, y, z,
    ih, m) rows. rho_i = sum m_j (W(h_i) + W(h_j)) / 2. Returns (rho, nn)
    [G*B,1]; nn INCLUDES the self pair."""
    name = "pass1_sym"
    if len(tgt) != 4 or len(src) != 5:
        raise ValueError(f"{name}: 4 target columns and 5 source rows")
    cuda = _is_cuda(name, [nv, *tgt, *src])
    g, s = _check_window(name, nv, tgt, src, b)
    if not cuda:
        return pass1_sym_plain(nv, tgt, src)
    (rho,) = _out(nv, g, b, 1)
    (nn,) = _out(nv, g, b, 1, torch.int32)
    _launch(name, [*tgt, *src, nv, rho, nn, g, b, s])
    return rho, nn


def _pass2_layout(mode, av, balsara, energy=False):
    """(target columns, source rows) pass 2 takes under these flags."""
    if mode not in MODES:
        raise ValueError(f"pass2: mode={mode!r}, one of {MODES}")
    if balsara and not av:
        raise ValueError("pass2: balsara needs av")
    if energy and mode == "reference_asymmetric":
        raise ValueError("pass2: energy needs a momentum-conserving pressure "
                         "form (grad_h or symmetric)")
    # viscosity brings its six fields (seven with balsara); the energy
    # equation without it only the three velocities
    extra = (7 if balsara else 6) if av else (3 if energy else 0)
    return (4 if mode == "reference_asymmetric" else 5) + extra, 6 + extra


def pass2(nv, tgt, src, *, b, mode="grad_h", av=False, sign_bug=False,
          av_alpha=0.0, av_beta=0.0, balsara=False, energy=False,
          grav=False, receiver_soft=False, g_const=1.0, nv_p2p=None,
          p2p_rows=None):
    """Pressure-gradient sweep with precomputed per-particle coefficients.

    tgt cols: x, y, z, ih, then tc (absent for reference_asymmetric), then
    with av: vx, vy, vz, h, cs, rho, then with balsara: f; with energy and
    no av just vx, vy, vz. src rows: x, y, z, ih, m, cc, then the matching
    AV or velocity rows. Per pair:
      grad_h:    coef = m (tc gw_i + cc gw_j)      tc = cc = P/(Omega rho^2)
      symmetric: coef = m (tc + cc) gsym           tc = cc = P/rho^2
      reference_asymmetric: coef = m cc gsym       cc = P/rho
    Returns (gpx, gpy, gpz) — the caller applies the target's rho — then
    (avx, avy, avz) with av (the caller scales by rho too), then the raw
    div/curl sums (4) with balsara, then with energy (not under
    reference_asymmetric) the specific-internal-energy rate du, complete as
    summed (no caller scale): tc m gw_i v.d under grad_h, else coef v.d / 2,
    plus m Pi gsym v.d / 2 with av; then with grav the fused Dyer-Ip near
    gravity over the same rows, (phi, gx, gy, gz) scaled by g_const and
    n_direct; phi includes the self term and n_direct the self pair.

    `nv_p2p`/`p2p_rows` (needs grav): also sweep this second window (x, y,
    z, [ih,] m; ih absent under receiver softening) into the same gravity
    sums, the residual-P2P merge."""
    name = "pass2"
    n_t, n_s = _pass2_layout(mode, av, balsara, energy)
    merged = p2p_rows is not None
    if merged and not grav:
        raise ValueError(f"{name}: the residual-P2P merge needs grav=True")
    n_p = (4 if receiver_soft else 5) if merged else 0
    if len(tgt) != n_t or len(src) != n_s or len(p2p_rows or ()) != n_p:
        raise ValueError(f"{name}: {n_t} target columns, {n_s} SPH rows "
                         f"and {n_p} P2P rows under these flags")
    p2p_rows = list(p2p_rows or ())
    cuda = _is_cuda(name, [nv, *tgt, *src, *p2p_rows]
                    + ([nv_p2p] if merged else []))
    g, s = _check_window(name, nv, tgt, src, b)
    s2 = _check_window(name, nv_p2p, (), p2p_rows, b, g)[1] if merged \
        else 0
    if not cuda:
        return pass2_plain(nv, tgt, src, nv_p2p=nv_p2p if merged else None,
                           p2p_rows=p2p_rows if merged else None, mode=mode,
                           av=av, sign_bug=sign_bug, av_alpha=av_alpha,
                           av_beta=av_beta, balsara=balsara, energy=energy,
                           grav=grav, receiver_soft=receiver_soft,
                           g_const=g_const)
    # the C interface takes every pointer by name; None is a null pointer
    tcols = list(tgt[:4]) + ([None] if mode == "reference_asymmetric"
                             else [tgt[4]])
    t_av = list(tgt[len(tgt) - (n_s - 6):])
    t_av += [None] * (7 - len(t_av))
    rows = list(src) + [None] * (13 - len(src))
    prow = [None] * 5
    if merged:
        prow = (p2p_rows[:3] + [None, p2p_rows[3]] if receiver_soft
                else p2p_rows)
    # every output of the call in one allocation, views in the return
    # order; a block the flags switch off passes null pointers
    full = (3, 3, 4, 1, 4)          # gp, av, div/curl, du, gravity
    on = (True, av, balsara, energy, grav)
    f32, i32 = _out_block(nv, g, b, sum(w for w, o in zip(full, on) if o),
                          1 if grav else 0)
    blocks, at = [], 0
    for w, o in zip(full, on):
        blocks.append(f32[at:at + w] if o else [None] * w)
        at += w if o else 0
    gp, avo, dco, duo, gro = blocks
    nd = i32 or [None]
    _launch(name, [*tcols, *t_av, *rows, *prow, nv,
                   nv_p2p if merged else None, *gp, *avo, *dco, *duo, *gro,
                   *nd, g, b, s, s2, MODES.index(mode), int(sign_bug),
                   int(av), int(balsara), int(energy),
                   (2 if merged else 1) if grav else 0,
                   int(receiver_soft), float(av_alpha), float(av_beta),
                   float(g_const)])
    return tuple(o for o in (*gp, *avo, *dco, *duo, *gro, *nd)
                 if o is not None)


def p2p(nv, tgt, src, *, b, receiver_soft, g_const=1.0, bf16=False):
    """Near-field gravity sweep over the P2P window.

    tgt cols: x, y, z, ih. src rows: x, y, z, m under receiver softening,
    x, y, z, ih, m under min-h softening. Returns (phi, gx, gy, gz)
    scaled by g_const and n_direct; phi INCLUDES the self term -2.4 m_i/a_i
    and n_direct the self pair — callers correct both. `bf16`: the pair
    polynomial in bfloat16 (``grav_pair_dtype="bfloat16"``; on a CUDA
    tensor the kernel's bf16 instance)."""
    name = "p2p"
    n_s = 4 if receiver_soft else 5
    if len(tgt) != 4 or len(src) != n_s:
        raise ValueError(f"{name}: 4 target columns and {n_s} source rows "
                         f"(receiver_soft={receiver_soft})")
    cuda = _is_cuda(name, [nv, *tgt, *src])
    g, s = _check_window(name, nv, tgt, src, b)
    if not cuda:
        return p2p_plain(nv, tgt, src, receiver_soft=receiver_soft,
                         g_const=g_const, bf16=bf16)
    outs = _out(nv, g, b, 4)
    (nd,) = _out(nv, g, b, 1, torch.int32)
    rows = [*src[:3], None, src[3]] if receiver_soft else src
    _launch(name, [*tgt, *rows, nv, *outs, nd, g, b, s, int(receiver_soft),
                   int(bf16), float(g_const)], bf16)
    return (*outs, nd)


def gravity_fused(nv_ring, tgt, ring_rows, far_rows, accept, *, b,
                  g_const=1.0, nv_p2p=None, p2p_rows=None,
                  receiver_soft=False, nv_blk=None, blk_rows=None,
                  bf16=False):
    """Tree gravity in one launch: the near P2P window (when `p2p_rows` is
    given), windowed ring multipoles, the windowed block multipoles of the
    supergroup partition (when `blk_rows` is given) and the dense far scan.

    tgt cols: x, y, z, ih. ring_rows: 4 (m, cmx, cmy, cmz) or 10 (+ Qxx,
    Qxy, Qxz, Qyy, Qyz, Qzz) [G, Sr] rows valid to nv_ring. far_rows: the
    same fields as [1, NBpad] rows. accept: [G, NBpad] f32 frozen MAC mask.
    p2p_rows: x, y, z, [ih,] m [G, Sp] rows valid to nv_p2p (ih absent
    under receiver softening); without them this is the far-only launch of
    the RESPA outer force. blk_rows: the ring's fields as [G, Sb] rows valid
    to nv_blk, blocks that pass the acceptance test while their supergroup
    does not; far_rows and accept then hold supergroups. Returns (phi, gx,
    gy, gz, n_direct, n_approx); with the near tier phi includes the self
    term and n_direct the self pair, without it n_direct is 0. `bf16`: the
    near tier's pair polynomial and each entry's monopole in bfloat16, the
    quadrupole in f32 (``grav_pair_dtype="bfloat16"``; on a CUDA tensor the
    kernel's bf16 instance)."""
    name = "gravity_fused"
    nm = len(ring_rows)
    has_p2p = p2p_rows is not None
    has_blk = blk_rows is not None
    blk_rows = list(blk_rows or ())
    n_p = (4 if receiver_soft else 5) if has_p2p else 0
    p2p_rows = list(p2p_rows or ())
    if nm not in (4, 10) or len(far_rows) != nm or len(tgt) != 4 \
            or len(p2p_rows) != n_p or (has_blk and len(blk_rows) != nm):
        raise ValueError(f"{name}: 4 target columns, 4 or 10 moment "
                         f"fields for every tier and {n_p} P2P rows")
    cuda = _is_cuda(name, [nv_ring, *tgt, *ring_rows, *far_rows, accept,
                           *p2p_rows, *blk_rows]
                    + ([nv_p2p] if has_p2p else [])
                    + ([nv_blk] if has_blk else []))
    g, sr = _check_window(name, nv_ring, tgt, ring_rows, b)
    sb = _check_window(name, nv_blk, (), blk_rows, b, g)[1] if has_blk \
        else 0
    sp = _check_window(name, nv_p2p, (), p2p_rows, b, g)[1] if has_p2p \
        else 0
    nbpad = far_rows[0].shape[1]
    for k, r in enumerate(far_rows):
        _need(name, f"far row {k}", r, (1, nbpad))
    _need(name, "accept", accept, (g, nbpad))
    if not cuda:
        return gravity_fused_plain(
            nv_ring, tgt, ring_rows, far_rows, accept, g_const=g_const,
            nv_p2p=nv_p2p if has_p2p else None,
            p2p_rows=p2p_rows if has_p2p else None,
            receiver_soft=receiver_soft,
            nv_blk=nv_blk if has_blk else None,
            blk_rows=blk_rows if has_blk else None, bf16=bf16)
    outs = _out(nv_ring, g, b, 4)
    nd, na = _out(nv_ring, g, b, 2, torch.int32)
    none = [None] * (10 - nm)
    prow = [None] * 5
    if has_p2p:
        prow = (p2p_rows[:3] + [None, p2p_rows[3]] if receiver_soft
                else p2p_rows)
    brow = blk_rows + none if has_blk else [None] * 10
    _launch(name, [*tgt, *prow, nv_p2p if has_p2p else None, *ring_rows,
                   *none, nv_ring, *brow, nv_blk if has_blk else None,
                   *far_rows, *none, accept, *outs, nd, na,
                   g, b, sp, sr, sb, nbpad, nm, int(has_p2p),
                   int(receiver_soft), int(bf16), float(g_const)], bf16)
    return (*outs, nd, na)
