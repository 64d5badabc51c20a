"""Unified Morton-block structure: neighbor windows + block-level tree
gravity (PyTorch port, production-step subset).

Counterpart of ``planetmodel_sph_tpu/ops/structure.py`` (see its module
docstring for the design): particles are Morton-sorted into cell-bounded
blocks; one [G, NSUB] geometry pass gives the SPH adjacency and one MAC
pass the three-tier gravity partition; adjacency rows are compacted into
fixed windows (overflow dropped AND counted); the sweeps run in the
kernels of ``ops/cuda/groups2.py``.

Ported here: single-set builds with sub-block SPH windows, the true-pair
sub-block refine, the fused residual-P2P pass 2 and the dense block far
scan — what ``jupiter_100k`` runs. Everything else is refused by name in
``config.check_slice``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig, check_slice
from . import eos as eos_ops
from . import grouping
from .cuda import groups2 as gk2
from .gravity import accept_bmax


class BlockStructure(NamedTuple):
    """Frozen interaction structure (sub-block granularity windows)."""
    groups: grouping.Groups
    sph_idx: torch.Tensor        # [G, Ws] SPH-window sub-block ids (-1 pad)
    n_sph: torch.Tensor          # [G]
    p2p_idx: torch.Tensor        # [G, Wp] residual near-field sub-blocks
    n_p2p: torch.Tensor          # [G]
    m2p_idx: torch.Tensor        # [G, Wm] ring sub-blocks (multipoles)
    n_m2p: torch.Tensor          # [G]
    accept: torch.Tensor         # [G, NBpad] f32 dense far-scan mask
    sph_overflow: torch.Tensor   # [] dropped SPH window entries
    p2p_overflow: torch.Tensor   # [] dropped P2P window entries
    m2p_overflow: torch.Tensor   # [] dropped ring window entries


def _nbpad(nb: int, chunk: int) -> int:
    return -(-nb // chunk) * chunk


def _i32(x):
    return x.to(torch.int32)


def _sum3(v):
    """Sum over a trailing axis of 3, left to right (the reference's order:
    the comparisons built on it must agree bit for bit)."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def fuse_active(cfg: SimConfig) -> bool:
    """Whether the pass-2 P2P fusion is in effect (always, in the port's
    slice: check_slice refuses the unfused configurations)."""
    if cfg.fuse_p2p_residual and not cfg.fuse_p2p_sph:
        raise ValueError("fuse_p2p_residual extends fuse_p2p_sph — "
                         "enable both")
    return cfg.fuse_p2p_sph


def packed_permute(arrays, idx):
    """Gather a list of [N] / [N, k] tensors by `idx` through ONE packed
    row gather (one gather kernel instead of one per field).

    Integer fields round-trip through the float dtype: the shared contract
    is values < 2^24. Returns tensors of shape idx.shape (+ (k,)) with the
    original dtypes."""
    fdt = next((a.dtype for a in arrays if a.is_floating_point()),
               torch.float32)
    cols, spans = [], []
    for a in arrays:
        cols.append(a.to(fdt)[:, None] if a.ndim == 1 else a.to(fdt))
        spans.append(0 if a.ndim == 1 else a.shape[1])
    gat = torch.cat(cols, dim=1)[idx.long()]
    out, off = [], 0
    for s, a in zip(spans, arrays):
        w = max(s, 1)
        v = gat[..., off:off + w]
        out.append((v[..., 0] if s == 0 else v).to(a.dtype).contiguous())
        off += w
    return out


def _compact_rows(adj, w):
    """Compact boolean rows [G, NB] to index windows [G, w] (+counts,
    dropped count): set columns keep their index as the sort key, clear
    ones get NB, so a row sort moves the set columns to the front."""
    g, nb = adj.shape
    col = torch.arange(nb, dtype=torch.int32, device=adj.device)
    keys = torch.where(adj, col[None, :], nb)
    if nb < w:
        keys = torch.nn.functional.pad(keys, (0, w - nb), value=nb)
    idx = torch.sort(keys, dim=1).values[:, :w]
    n = _i32(adj.sum(dim=1))
    jw = torch.arange(w, dtype=torch.int32, device=adj.device)
    idx = torch.where(jw[None, :] < n[:, None], idx, -1)
    overflow = _i32(torch.clamp(n - w, min=0).sum())
    return idx, n, overflow


def _refine_subblock(sph_idx, n_sph, sph_over, pos_sb, h_sb, m_sb, sk_sb,
                     live_sb, pos_t, h_t, sk_t, cfg, h_margin, nsub, sub,
                     chunk):
    """Refine the sub-block SPH window with the TRUE pair predicate at
    sub-block granularity: one filter_sph sweep marks every candidate that
    interacts with some target of the group under the skin- and margin-
    inflated cutoff; sub-blocks with no survivor leave the window, which is
    recompacted and optionally truncated to cfg.sph_refined_window
    (truncation is counted as overflow)."""
    g, w = sph_idx.shape
    keff = cfg.kappa * (1.0 + h_margin)
    xs = pos_sb[..., 0].reshape(-1)
    ys = pos_sb[..., 1].reshape(-1)
    zs = pos_sb[..., 2].reshape(-1)
    cs = keff * h_sb.reshape(-1)
    ms = torch.where(live_sb, m_sb, 0.0).reshape(-1)
    sks = sk_sb.reshape(-1)
    cand = _window_gather([xs, ys, zs, cs, sks, ms], sph_idx, nsub, sub,
                          chunk)
    tgt = _cols(pos_t[..., 0].reshape(-1), pos_t[..., 1].reshape(-1),
                pos_t[..., 2].reshape(-1), keff * h_t.reshape(-1),
                sk_t.reshape(-1))
    nv = _i32(torch.clamp(n_sph, max=w) * sub)
    keep = gk2.filter_sph(nv, tgt, cand, b=cfg.nbr_group_size)
    hit = keep[:, :w * sub].reshape(g, w, sub).amax(dim=2) > 0.0
    jw = torch.arange(w, dtype=torch.int32, device=hit.device)
    hit &= jw[None, :] < torch.clamp(n_sph, max=w)[:, None]
    keys = torch.where(hit, torch.clamp(sph_idx, 0, nsub - 1), nsub)
    srt = torch.sort(keys, dim=1).values
    n2 = _i32(hit.sum(dim=1))
    w2 = min(cfg.sph_refined_window or w, w)
    srt = srt[:, :w2]
    j2 = torch.arange(w2, dtype=torch.int32, device=hit.device)
    idx = torch.where(j2[None, :] < torch.clamp(n2, max=w2)[:, None], srt,
                      -1)
    over = sph_over + _i32(torch.clamp(n2 - w2, min=0).sum())
    return _i32(idx), torch.clamp(n2, max=w2), over


def _block_stats(pos_b, h_b, m_b, live):
    """Per-block summaries from sorted [NB, B] fields (live-masked)."""
    big = 3e30
    m_live = torch.where(live, m_b, 0.0)
    mass = m_live.sum(dim=1)
    mpos = (m_live[..., None] * pos_b).sum(dim=1)
    cm = mpos / torch.clamp(mass, min=1e-30)[:, None]
    lv3 = live[..., None]
    amin = torch.where(lv3, pos_b, big).amin(dim=1)
    amax = torch.where(lv3, pos_b, -big).amax(dim=1)
    b = torch.clamp(torch.maximum(amax - cm, cm - amin), min=0.0)
    bmax2 = torch.where(mass > 0, _sum3(b * b), 0.0)
    hmax = torch.where(live, h_b, 0.0).amax(dim=1)
    return mass, cm, amin, amax, bmax2, hmax


def build(pos, h, mass, cfg: SimConfig, skin=0.0, h_margin: float = 0.0,
          groups=None, sph_only: bool = False) -> BlockStructure:
    """Build windows + MAC mask for the current positions/smoothing lengths.

    `skin`: per-particle motion bound [N] (or a scalar) reduced to per-block
    and per-sub-block maxima; adjacency cutoffs widen by both sides' skins
    and the MAC stays conservative over the rebuild period. `h_margin`:
    cutoffs widened by (1+h_margin) on h. `groups`: a frozen grouping to
    reuse instead of re-sorting (cfg.sort_every). `sph_only`: skip the
    gravity partition (throwaway structures of the Newton h-solve)."""
    check_slice(cfg)
    dev, fdt = pos.device, pos.dtype
    n = pos.shape[0]
    bsz = cfg.nbr_group_size
    chunk = cfg.block_chunk
    do_grav = not sph_only

    if groups is None:
        big = 3e30
        live_s = mass > 0.0
        lo = torch.minimum(torch.where(live_s[:, None], pos, big).amin(0),
                           pos.amin(0))
        hi = torch.maximum(torch.where(live_s[:, None], pos, -big).amax(0),
                           pos.amax(0))
        groups = grouping.cell_groups(pos, lo, hi, bsz, cfg.nbr_group_level)
    grp = groups
    g = grp.live.shape[0]
    nb = g
    sub = cfg.nbr_sub
    if bsz % sub:
        raise ValueError("nbr_sub must divide nbr_group_size")
    spb = bsz // sub
    nsub = nb * spb

    skin = torch.as_tensor(skin, dtype=fdt, device=dev)
    if skin.ndim == 0:
        skin = skin.expand(n)
    tix = grp.tgt_idx.long()

    # target-block AABBs + max h (duplicate slots replicate real members)
    pos_t = pos[tix].reshape(g, bsz, 3)
    h_t = h[tix].reshape(g, bsz)
    tlo = pos_t.amin(dim=1)
    thi = pos_t.amax(dim=1)
    t_hmax = torch.where(grp.live, h_t, 0.0).amax(dim=1)
    tvalid = grp.live.any(dim=1)
    sk_t = skin[tix].reshape(g, bsz)
    d_t = torch.where(grp.live, sk_t, 0.0).amax(dim=1)

    # source summaries at block (far MAC) and sub-block granularity
    pos_sb, h_sb = pos_t, h_t
    m_sb = mass[tix].reshape(nb, bsz)
    b_mass, b_cm, _, _, b_bmax2, _ = _block_stats(pos_sb, h_sb, m_sb,
                                                  grp.live)
    bvalid = b_mass > 0.0
    s_mass, s_cm, s_amin, s_amax, s_bmax2, s_hmax = _block_stats(
        pos_sb.reshape(nsub, sub, 3), h_sb.reshape(nsub, sub),
        m_sb.reshape(nsub, sub), grp.live.reshape(nsub, sub))
    svalid = s_mass > 0.0
    sk_sb = torch.where(grp.live, sk_t, 0.0)
    d_b = sk_sb.amax(dim=1)
    d_s = sk_sb.reshape(nsub, sub).amax(dim=1)

    # ---- [G, NSUB] geometry pass: SPH adjacency ----
    gap = torch.clamp(torch.maximum(tlo[:, None, :] - s_amax[None, :, :],
                                    s_amin[None, :, :] - thi[:, None, :]),
                      min=0.0)
    gap2 = _sum3(gap * gap)
    del gap
    cut = (cfg.kappa * (1.0 + h_margin)
           * torch.maximum(t_hmax[:, None], s_hmax[None, :])
           + d_t[:, None] + d_s[None, :])
    sph_adj = (gap2 < cut * cut) & tvalid[:, None] & svalid[None, :]
    del gap2, cut
    sph_idx, n_sph, sph_over = _compact_rows(sph_adj, cfg.nbr_window)
    del sph_adj
    if cfg.sph_refine_subblock:
        sph_idx, n_sph, sph_over = _refine_subblock(
            sph_idx, n_sph, sph_over, pos_sb, h_sb, m_sb, sk_sb, grp.live,
            pos_t, h_t, sk_t, cfg, h_margin, nsub, sub, chunk)

    if not do_grav:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return BlockStructure(
            grp, sph_idx, n_sph,
            torch.full((g, cfg.p2p_window), -1, dtype=torch.int32,
                       device=dev), torch.zeros(g, dtype=torch.int32,
                                                device=dev),
            torch.full((g, cfg.m2p_window), -1, dtype=torch.int32,
                       device=dev), torch.zeros(g, dtype=torch.int32,
                                                device=dev),
            torch.zeros((g, _nbpad(nb, chunk)), dtype=torch.float32,
                        device=dev), sph_over, zero, zero)

    tlo_p = tlo[:, None, :] - d_t[:, None, None]
    thi_p = thi[:, None, :] + d_t[:, None, None]

    def mac(cm, bmax2, d_src):
        """Motion-conservative MAC: box-to-CM distance reduced by the
        source bound, bmax grown by twice it."""
        dd = torch.clamp(torch.maximum(tlo_p - cm[None, :, :],
                                       cm[None, :, :] - thi_p), min=0.0)
        d_eff = torch.clamp(torch.sqrt(_sum3(dd * dd)) - d_src[None, :],
                            min=0.0)
        b_eff = (torch.sqrt(torch.clamp(bmax2, min=0.0))[None, :]
                 + 2.0 * d_src[None, :])
        return accept_bmax(d_eff * d_eff, b_eff * b_eff, cfg.theta)

    mac_blk = mac(b_cm, b_bmax2, d_b)
    mac_sub = mac(s_cm, s_bmax2, d_s)
    covered = mac_blk & bvalid[None, :]
    # pass-2 fusion: SPH-window sub-blocks get their near gravity inside
    # pass 2, so they leave every tier here; blocks holding any leave the
    # dense far scan and re-partition at sub granularity
    in_sph = torch.zeros((g, nsub), dtype=torch.int32, device=dev)
    in_sph.scatter_reduce_(1, torch.clamp(sph_idx, 0, nsub - 1).long(),
                           _i32(sph_idx >= 0), reduce="amax")
    in_sph = in_sph > 0
    covered = covered & ~in_sph.reshape(g, nb, spb).any(dim=2)
    blk_exp = covered.repeat_interleave(spb, dim=1)
    rest = (~blk_exp) & tvalid[:, None] & svalid[None, :]
    ring = rest & mac_sub & ~in_sph
    near = rest & (~mac_sub) & ~in_sph
    # ONE sort compacts both tiers: near keys first, ring keys next
    col = torch.arange(nsub, dtype=torch.int32, device=dev)[None, :]
    keys = torch.where(near, col, torch.where(ring, col + nsub, 2 * nsub))
    srt = torch.sort(keys, dim=1).values
    n_p2p = _i32(near.sum(dim=1))
    n_m2p = _i32(ring.sum(dim=1))
    wp, wm = cfg.p2p_window, cfg.m2p_window
    if nsub < wp:
        srt_p = torch.nn.functional.pad(srt, (0, wp - nsub),
                                        value=2 * nsub)[:, :wp]
    else:
        srt_p = srt[:, :wp]
    jp = torch.arange(wp, dtype=torch.int32, device=dev)[None, :]
    p2p_idx = torch.where(jp < n_p2p[:, None], srt_p, -1)
    jm = torch.arange(wm, dtype=torch.int32, device=dev)[None, :]
    at = torch.clamp(n_p2p[:, None] + jm, 0, srt.shape[1] - 1)
    ring_vals = torch.gather(srt, 1, at.long()) - nsub
    m2p_idx = torch.where(jm < n_m2p[:, None], ring_vals, -1)
    p2p_over = _i32(torch.clamp(n_p2p - wp, min=0).sum())
    m2p_over = _i32(torch.clamp(n_m2p - wm, min=0).sum())
    accept = torch.nn.functional.pad(covered.to(torch.float32),
                                     (0, _nbpad(nb, chunk) - nb))
    return BlockStructure(grp, sph_idx, n_sph, _i32(p2p_idx), n_p2p,
                          _i32(m2p_idx), n_m2p, accept.contiguous(),
                          sph_over, p2p_over, m2p_over)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

class BlockForces(NamedTuple):
    rho: torch.Tensor
    pressure: torch.Tensor
    grad_p: torch.Tensor
    phi: torch.Tensor
    grad_phi: torch.Tensor
    n_neighbors: torch.Tensor
    n_direct: torch.Tensor
    n_approx: torch.Tensor
    du_dt: torch.Tensor


class _Ctx(NamedTuple):
    """Sorted-layout fields shared by the sweeps of one evaluation (one
    particle set: targets and sources alias)."""
    t: dict
    s: dict
    g: int
    nb: int


def _prep_ctx(pos, h, mass, cfg: SimConfig, st: BlockStructure,
              sorted_io=False) -> _Ctx:
    grp = st.groups
    g = grp.live.shape[0]
    if sorted_io:
        t = dict(x=pos[:, 0].contiguous(), y=pos[:, 1].contiguous(),
                 z=pos[:, 2].contiguous(), h=h, m=mass)
    else:
        x, y, z, hh, m = packed_permute(
            [pos[:, 0], pos[:, 1], pos[:, 2], h, mass], grp.tgt_idx)
        t = dict(x=x, y=y, z=z, h=hh, m=m)
    t["ih"] = 1.0 / torch.where(t["h"] > 0, t["h"], 1.0)
    s = dict(t)
    s["live"] = grp.live.reshape(-1).to(pos.dtype)
    # replica/padding slots carry zero SOURCE mass; the TARGET mass keeps
    # the real value (h-solve and the self-phi correction)
    s["m"] = s["m"] * s["live"]
    return _Ctx(t, s, g, g)


def _window_gather(sorted_cols, idx, nb, bsz, chunk):
    """Gather per-field [G, W*bsz] rows (zero-padded to a multiple of
    `chunk`) through block-id windows [G, W] (-1 padding): one packed
    gather of contiguous block rows, then per-field slices."""
    c = len(sorted_cols)
    g, w = idx.shape
    packed = torch.cat([x.reshape(nb, bsz) for x in sorted_cols], dim=1)
    gat = packed[torch.clamp(idx, 0, nb - 1).long()]        # [G, W, c*B]
    pad = _nbpad(w * bsz, chunk) - w * bsz
    return [torch.nn.functional.pad(
        gat[:, :, k * bsz:(k + 1) * bsz].reshape(g, w * bsz), (0, pad))
        for k in range(c)]


def _entry_gather(cols, idx, chunk):
    """Per-entry gathers (one value per window slot), padded to chunk."""
    w = idx.shape[1]
    safe = torch.clamp(idx, 0, cols[0].shape[0] - 1)
    pad = _nbpad(w, chunk) - w
    return [torch.nn.functional.pad(v, (0, pad))
            for v in packed_permute(cols, safe)]


def _cols(*xs):
    return [x.reshape(-1, 1).contiguous() for x in xs]


def _sph_nv(st: BlockStructure, cfg: SimConfig):
    """Valid pair-slot count per target group for the SPH window (the
    capacity is the window's actual, possibly truncated, width)."""
    return _i32(torch.clamp(st.n_sph, max=st.sph_idx.shape[1])
                * cfg.nbr_sub)


def _sph_rows(cols, st: BlockStructure, cfg: SimConfig, nb):
    sub = cfg.nbr_sub
    return _window_gather(cols, st.sph_idx, nb * (cfg.nbr_group_size // sub),
                          sub, cfg.block_chunk)


def _geom(s):
    return [s["x"], s["y"], s["z"], s["ih"], s["m"]]


def _density_sweep(ctx: _Ctx, cfg: SimConfig, st: BlockStructure,
                   t_ih=None, t_h=None, src1=None):
    """Grad-h pass 1 against current fields: (rho, nn, omega), target-
    sorted. `t_ih`/`t_h` override the target smoothing length (the Newton
    h-solve); `src1` reuses pre-gathered geometry rows."""
    t = ctx.t
    tih = t["ih"] if t_ih is None else t_ih
    th = t["h"] if t_h is None else t_h
    if src1 is None:
        src1 = _sph_rows(_geom(ctx.s), st, cfg, ctx.nb)
    rho_c, nn_c, xi_c = gk2.pass1_gradh(
        _sph_nv(st, cfg), _cols(t["x"], t["y"], t["z"], tih),
        [src1[0], src1[1], src1[2], src1[4]], b=cfg.nbr_group_size)
    rho = torch.clamp(rho_c[:, 0], min=1e-30)
    omega = 1.0 + th * xi_c[:, 0] / (3.0 * rho)
    return rho, nn_c[:, 0] - 1, omega


def _gravity_far(ctx: _Ctx, cfg: SimConfig, st: BlockStructure):
    """Far tiers (the reference's _gravity_sweeps(tiers='far')): windowed
    ring sub-block multipoles + the dense block far scan under the frozen
    mask, from CURRENT moments. Returns (phi, grad_phi, n_approx)."""
    bsz = cfg.nbr_group_size
    sub = cfg.nbr_sub
    chunk = cfg.block_chunk
    s = ctx.s
    nb = ctx.nb
    nsub = nb * (bsz // sub)
    live = st.groups.live
    quad = cfg.multipole_order >= 2

    def moments(n_units, usz):
        m_live = torch.where(live.reshape(n_units, usz),
                             s["m"].reshape(n_units, usz), 0.0)
        um = m_live.sum(dim=1)
        inv = 1.0 / torch.clamp(um, min=1e-30)
        xs = s["x"].reshape(n_units, usz)
        ys = s["y"].reshape(n_units, usz)
        zs = s["z"].reshape(n_units, usz)
        cx = (m_live * xs).sum(dim=1) * inv
        cy = (m_live * ys).sum(dim=1) * inv
        cz = (m_live * zs).sum(dim=1) * inv
        out = [um, cx, cy, cz]
        if quad:
            # traceless quadrupole Q_ab = sum m (3 x_a x_b - |x|^2 d_ab)
            # about the unit's own CM
            dx = xs - cx[:, None]
            dy = ys - cy[:, None]
            dz = zs - cz[:, None]
            r2 = dx * dx + dy * dy + dz * dz
            q = lambda a, b, diag: (m_live * (3.0 * a * b - (
                r2 if diag else 0.0))).sum(dim=1)
            out += [q(dx, dx, True), q(dx, dy, False), q(dx, dz, False),
                    q(dy, dy, True), q(dy, dz, False), q(dz, dz, True)]
        return out

    npad = st.accept.shape[1]
    far_rows = [torch.nn.functional.pad(v, (0, npad - nb))[None, :]
                for v in moments(nb, bsz)]
    ring_rows = _entry_gather(moments(nsub, sub), st.m2p_idx, chunk)
    nv_ring = _i32(torch.clamp(st.n_m2p, max=cfg.m2p_window))
    t = ctx.t
    phi_c, gx, gy, gz, _, na_c = gk2.gravity_fused(
        nv_ring, _cols(t["x"], t["y"], t["z"], t["ih"]), ring_rows,
        far_rows, st.accept, b=bsz, g_const=cfg.g_const)
    return phi_c[:, 0], torch.cat([gx, gy, gz], dim=-1), na_c[:, 0]


def _unsort(st: BlockStructure, fields):
    """Sorted [G*B] fields back to original order (one packed gather
    through the grouping's inverse permutation)."""
    return packed_permute(fields, st.groups.unsort_idx)


def forces(pos, h, mass, cfg: SimConfig, st: BlockStructure, vel=None,
           sorted_io=False, grav_tiers: str = "all") -> BlockForces:
    """Field evaluation against current fields: pass 1 (grad-h density),
    the polytropic EOS, the merged pass 2 (grad-h pressure gradient + near
    gravity over the SPH and residual-P2P windows) and, unless
    grav_tiers='near', the far tiers.

    `sorted_io`: inputs are in the padded sorted [G*B] layout and outputs
    stay in it (the cached runner's chunk format). `vel` is unused on the
    polytropic, inviscid path and accepted for the reference's signature.
    """
    check_slice(cfg)
    if grav_tiers not in ("all", "near"):
        raise ValueError(f"grav_tiers={grav_tiers!r}: 'all' or 'near' "
                         "(the far tiers alone are gravity_far)")
    fuse_active(cfg)
    bsz = cfg.nbr_group_size
    sub = cfg.nbr_sub
    ctx = _prep_ctx(pos, h, mass, cfg, st, sorted_io=sorted_io)
    t, s = ctx.t, ctx.s

    # geometry rows gathered ONCE; pass 1 and pass 2 reuse them
    geom_rows = _sph_rows(_geom(s), st, cfg, ctx.nb)
    rho_t, nn_t, omega = _density_sweep(ctx, cfg, st, src1=geom_rows)
    prs_t = eos_ops.pressure_cfg(rho_t, cfg)

    # fully-dead groups sit at the rho floor where P/rho^2 is 0/0: zero it
    rho_ok = rho_t > 1e-20
    om_safe = torch.clamp(omega, min=0.1)
    coef_t = torch.where(rho_ok, prs_t / (om_safe * rho_t * rho_t), 0.0)
    extra_rows = _sph_rows([coef_t], st, cfg, ctx.nb)
    nsub = ctx.nb * (bsz // sub)
    srcp = _window_gather(_geom(s), st.p2p_idx, nsub, sub, cfg.block_chunk)
    outs = gk2.pass2(
        _sph_nv(st, cfg), _cols(t["x"], t["y"], t["z"], t["ih"], coef_t),
        geom_rows + extra_rows, b=bsz,
        nv_p2p=_i32(torch.clamp(st.n_p2p, max=cfg.p2p_window) * sub),
        p2p_rows=srcp, g_const=cfg.g_const)
    grad_p_t = torch.cat(outs[:3], dim=-1) * rho_t[:, None]

    # gravity: pass 2 swept both near windows; the far tiers come from
    # _gravity_far unless this is a RESPA inner ('near') evaluation.
    # +self_phi offsets the Dyer-Ip self potential the SPH rows include,
    # -1 the self pair in n_direct.
    self_phi = 2.4 * cfg.g_const * t["m"] * t["ih"]
    if grav_tiers == "near":
        phi_t = self_phi
        grad_phi_t = torch.zeros_like(grad_p_t)
        na_t = torch.zeros_like(nn_t)
    else:
        phi_f, grad_phi_t, na_t = _gravity_far(ctx, cfg, st)
        phi_t = phi_f + self_phi
    phi_t = phi_t + outs[3][:, 0]
    grad_phi_t = grad_phi_t + torch.cat(outs[4:7], dim=-1)
    nd_t = outs[7][:, 0] - 1
    du_t = torch.zeros_like(rho_t)

    if sorted_io:
        return BlockForces(rho_t, prs_t, grad_p_t, phi_t, grad_phi_t, nn_t,
                           nd_t, na_t, du_t)
    return BlockForces(*_unsort(st, [rho_t, prs_t, grad_p_t, phi_t,
                                     grad_phi_t, nn_t, nd_t, na_t, du_t]))


def gravity_far(pos, h, mass, cfg: SimConfig, st: BlockStructure,
                sorted_io=False):
    """Far-tier tree gravity only (ring sub-block multipoles + dense block
    scan): (phi_far, grad_phi_far, n_approx) — the RESPA outer force."""
    check_slice(cfg)
    ctx = _prep_ctx(pos, h, mass, cfg, st, sorted_io=sorted_io)
    phi_t, grad_phi_t, na_t = _gravity_far(ctx, cfg, st)
    if sorted_io:
        return phi_t, grad_phi_t, na_t
    return tuple(_unsort(st, [phi_t, grad_phi_t, na_t]))


def solve_h_newton(pos, h, mass, cfg: SimConfig, eta: float, groups=None,
                   rho0=None):
    """Fixed-point solve of h = eta (m/rho(h))^(1/3) on the block pipeline.

    Builds a throwaway structure whose cutoffs are widened by the clamp
    margin c (capacities scaled by (1+c)^3), then iterates the gather-form
    density with h clamped to [h/(1+c), h*(1+c)]. `rho0` warm-starts with
    one fixed-point step from the state's density before the build (and
    one fewer sweep). Returns the new h in original order."""
    c = cfg.h_newton_clamp
    if cfg.h_max > 0.0:
        h = torch.clamp(h, max=cfg.h_max)
    if rho0 is not None:
        hw = eta * torch.pow(mass / torch.clamp(rho0, min=1e-30), 1.0 / 3.0)
        h = torch.minimum(torch.maximum(hw, h / (1.0 + c)), h * (1.0 + c))
        if cfg.h_max > 0.0:
            h = torch.clamp(h, max=cfg.h_max)
    factor = (1.0 + c) ** 3
    scale = lambda w, q: int(-(-int(w * factor) // q) * q)
    cfg = cfg.replace(nbr_window=scale(cfg.nbr_window, 16),
                      sph_refined_window=(scale(cfg.sph_refined_window, 16)
                                          if cfg.sph_refined_window else 0))
    st = build(pos, h, mass, cfg, h_margin=c, groups=groups, sph_only=True)
    ctx = _prep_ctx(pos, h, mass, cfg, st)
    h0 = ctx.t["h"]
    lo, hi = h0 / (1.0 + c), h0 * (1.0 + c)
    if cfg.h_max > 0.0:
        hi = torch.clamp(hi, max=cfg.h_max)
    h_t = h0
    m_t = ctx.t["m"]
    rows = _sph_rows(_geom(ctx.s), st, cfg, ctx.nb)
    iters = max(1, cfg.h_newton_iters - (1 if rho0 is not None else 0))
    for _ in range(iters):
        ih = 1.0 / torch.where(h_t > 0, h_t, 1.0)
        rho_t, _, _ = _density_sweep(ctx, cfg, st, t_ih=ih, t_h=h_t,
                                     src1=rows)
        h_t = torch.minimum(torch.maximum(
            eta * torch.pow(m_t / rho_t, 1.0 / 3.0), lo), hi)
    return _unsort(st, [h_t])[0]


def overflow_info(st: BlockStructure) -> dict:
    """Structure overflow counters (the 'dropped AND counted' contract)."""
    return {"nbr_overflow": st.sph_overflow,
            "tree_overflow": st.p2p_overflow + st.m2p_overflow}
