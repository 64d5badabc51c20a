"""Unified Morton-block structure: neighbor windows + block-level tree
gravity (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/structure.py`` (see its module
docstring for the design): particles are Morton-sorted into cell-bounded
blocks; one [G, NSUB] geometry pass gives the SPH adjacency and one MAC
pass the three-tier gravity partition; adjacency rows are compacted into
fixed windows (overflow dropped AND counted); the sweeps run in the
kernels of ``ops/cuda/groups2.py``.

Ported here: single-set builds with sub-block SPH windows, the true-pair
sub-block refine or particle-exact SPH lists (``cfg.sph_exact_window``);
the density sweep in its grad-h and symmetric forms; the polytropic,
adiabatic and Tillotson EOS; pass 2 in every pressure form, with viscosity
and the Balsara limiter, the conjugate energy equation, with near gravity
fused into it (and the residual-P2P window merged) or swept on its own; the
gravity tiers in one launch, near only or far only, with or without the
supergroup far tier; and the standalone gravity sweep of dense-SPH runs.

Two particle sets (`src=`, the replicated data-parallel layout of
``parallel/dp.py``): the targets are a rank's shard, the sources the
all-gathered global set, each with its own Morton grouping in a shared
bounding box. The windows then index the SOURCE blocks (NB of them) from
the TARGET groups (G of them, G != NB), and the far-scan mask is [G, NBpad]
over the source blocks; the kernels take both as they are.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SimConfig, check_slice, fuse_active  # noqa: F401
from . import eos as eos_ops
from . import grouping
from .cuda import groups2 as gk2
from .gravity import accept_bmax


class BlockStructure(NamedTuple):
    """Frozen interaction structure (sub-block granularity windows)."""
    groups: grouping.Groups      # target grouping
    src_groups: grouping.Groups  # source grouping (the same object for a
                                 # single-set build)
    sph_idx: torch.Tensor        # [G, Ws] SPH-window sub-block ids, or
                                 # sorted-layout particle ids under exact
                                 # lists (-1 pad)
    n_sph: torch.Tensor          # [G]
    p2p_idx: torch.Tensor        # [G, Wp] residual near-field sub-blocks
    n_p2p: torch.Tensor          # [G]
    m2p_idx: torch.Tensor        # [G, Wm] ring sub-blocks (multipoles)
    n_m2p: torch.Tensor          # [G]
    accept: torch.Tensor         # f32 dense far-scan mask: [G, NBpad] over
                                 # blocks, [G, NSGpad] over supergroups
                                 # when cfg.sg_blocks > 1
    blk_idx: torch.Tensor        # [G, Wb] block-multipole tier ids: blocks
                                 # that pass the MAC while their supergroup
                                 # does not ([G, 1] of -1 without the tier)
    n_blk: torch.Tensor          # [G]
    sph_overflow: torch.Tensor   # [] dropped SPH window entries
    p2p_overflow: torch.Tensor   # [] dropped P2P window entries
    m2p_overflow: torch.Tensor   # [] dropped ring window entries
    blk_overflow: torch.Tensor   # [] dropped block-tier window entries


def _nbpad(nb: int, chunk: int) -> int:
    return -(-nb // chunk) * chunk


def _i32(x):
    return x.to(torch.int32)


def _sum3(v):
    """Sum over a trailing axis of 3, left to right (the reference's order:
    the comparisons built on it must agree bit for bit)."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def packed_permute(arrays, idx, pad_to=0):
    """Gather a list of [N] / [N, k] tensors by `idx` through ONE packed
    row gather (one gather kernel instead of one per field).

    Integer fields round-trip through the float dtype: the shared contract
    is values < 2^24. `pad_to` zero-pads the packed rows to that many
    values before the gather (the reference's gather-row width; no value
    changes). Returns tensors of shape idx.shape (+ (k,)) with the original
    dtypes."""
    fdt = next((a.dtype for a in arrays if a.is_floating_point()),
               torch.float32)
    cols, spans = [], []
    for a in arrays:
        cols.append(a.to(fdt)[:, None] if a.ndim == 1 else a.to(fdt))
        spans.append(0 if a.ndim == 1 else a.shape[1])
    packed = torch.cat(cols, dim=1)
    if pad_to > packed.shape[1]:
        packed = torch.nn.functional.pad(packed,
                                         (0, pad_to - packed.shape[1]))
    gat = packed[idx.long()]
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


def _filter_candidates(sph_idx, n_sph, pos_sb, h_sb, m_sb, sk_sb, live_sb,
                       pos_t, h_t, sk_t, cfg, h_margin, nsub, sub, chunk):
    """The rebuild-time true-pair mask over a sub-block window's candidate
    slots: one filter_sph sweep marks every candidate that interacts with
    some target of the group under the skin- and margin-inflated cutoff
    r < kappa (1 + margin) max(h_i, h_j) + skin_i + skin_j. Returns the
    [G, W*sub] keep mask (padded to `chunk`)."""
    w = sph_idx.shape[1]
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
    return gk2.filter_sph(nv, tgt, cand, b=cfg.nbr_group_size)


def _refine_exact(sph_idx, n_sph, sph_over, pos_sb, h_sb, m_sb, sk_sb,
                  live_sb, pos_t, h_t, sk_t, cfg, h_margin, nsub, sub,
                  chunk):
    """Refine the sub-block SPH window to PARTICLE-granularity candidate
    lists (cfg.sph_exact_window): the surviving candidates of the true-pair
    mask are compacted by the sort trick of :func:`_compact_rows` into a
    [G, Wx] window of sorted-layout particle ids (more than Wx survivors
    are dropped and counted as overflow)."""
    g, w = sph_idx.shape
    wx = cfg.sph_exact_window
    keep = _filter_candidates(sph_idx, n_sph, pos_sb, h_sb, m_sb, sk_sb,
                              live_sb, pos_t, h_t, sk_t, cfg, h_margin,
                              nsub, sub, chunk)
    wc = w * sub
    mask = keep[:, :wc] > 0.0
    cid = (torch.clamp(sph_idx, 0, nsub - 1)[:, :, None] * sub
           + torch.arange(sub, dtype=torch.int32,
                          device=mask.device)[None, None, :]).reshape(g, wc)
    big = nsub * sub
    keys = torch.where(mask, cid, big)
    if wc < wx:
        keys = torch.nn.functional.pad(keys, (0, wx - wc), value=big)
    # surviving slots carry distinct particle ids, the rest one sentinel:
    # the sorted values are the reference's rows (stable, as its sort)
    srt = torch.sort(keys, dim=1, stable=True).values[:, :wx]
    n_x = _i32(mask.sum(dim=1))
    jx = torch.arange(wx, dtype=torch.int32, device=mask.device)
    idx = torch.where(jx[None, :] < n_x[:, None], srt, -1)
    over = sph_over + _i32(torch.clamp(n_x - wx, min=0).sum())
    return _i32(idx), n_x, over


def _refine_subblock(sph_idx, n_sph, sph_over, pos_sb, h_sb, m_sb, sk_sb,
                     live_sb, pos_t, h_t, sk_t, cfg, h_margin, nsub, sub,
                     chunk):
    """Refine the sub-block SPH window with the TRUE pair predicate at
    sub-block granularity (:func:`_filter_candidates`): sub-blocks with no
    survivor leave the window, which is recompacted and optionally
    truncated to cfg.sph_refined_window (truncation is counted as
    overflow)."""
    g, w = sph_idx.shape
    keep = _filter_candidates(sph_idx, n_sph, pos_sb, h_sb, m_sb, sk_sb,
                              live_sb, pos_t, h_t, sk_t, cfg, h_margin,
                              nsub, sub, chunk)
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


def build(pos, h, mass, cfg: SimConfig, skin=0.0, src=None,
          target_offset: int = 0, h_margin: float = 0.0, groups=None,
          sph_only: bool = False, skin_src=None) -> BlockStructure:
    """Build windows + MAC mask for the current positions/smoothing lengths.

    `skin`: per-particle motion bound [N] (or a scalar) reduced to per-block
    and per-sub-block maxima; adjacency cutoffs widen by both sides' skins
    and the MAC stays conservative over the rebuild period. `src`: an
    optional (pos, h, mass) source set (data parallelism: the targets are
    the local shard, the sources the all-gathered global set); a tensor
    `skin` then covers the targets only, and `skin_src` (the gathered
    skins) the sources, zero without it. `target_offset`: the targets'
    first index in the source set, carried as the reference carries it
    (the windows do not need it: self pairs are included and corrected).
    `h_margin`: cutoffs widened by (1+h_margin) on h. `groups`: a frozen
    grouping to reuse instead of re-sorting (cfg.sort_every): one Groups
    for a single-set build, a (target, source) pair under `src`.
    `sph_only`: skip the gravity partition (throwaway structures of the
    Newton h-solve)."""
    check_slice(cfg)
    single = src is None
    dev, fdt = pos.device, pos.dtype
    pos_s, h_s, mass_s = (pos, h, mass) if single else src[:3]
    bsz = cfg.nbr_group_size
    chunk = cfg.block_chunk
    do_grav = cfg.gravity_solver == "tree" and not sph_only

    if groups is not None:
        if isinstance(groups, grouping.Groups):
            if not single:
                raise ValueError("dp builds need a (target, source) "
                                 "groups pair")
            tgrp = sgrp = groups
        else:
            if single:
                raise ValueError("single-set builds take one Groups")
            tgrp, sgrp = groups
    else:
        # one Morton box for both sets: the live sources' and every
        # target's (the targets are a subset of the sources under dp; the
        # union is taken all the same, as the reference does)
        big = 3e30
        live_s = mass_s > 0.0
        lo = torch.minimum(torch.where(live_s[:, None], pos_s, big).amin(0),
                           pos.amin(0))
        hi = torch.maximum(torch.where(live_s[:, None], pos_s, -big).amax(0),
                           pos.amax(0))
        tgrp = grouping.cell_groups(pos, lo, hi, bsz, cfg.nbr_group_level)
        # the source grouping takes the same stable sort
        sgrp = tgrp if single else grouping.cell_groups(
            pos_s, lo, hi, bsz, cfg.nbr_group_level)
    g = tgrp.live.shape[0]
    nb = sgrp.live.shape[0]
    sub = cfg.nbr_sub
    if bsz % sub:
        raise ValueError("nbr_sub must divide nbr_group_size")
    spb = bsz // sub
    nsub = nb * spb

    # per-particle motion bounds of both sets (a scalar broadcasts)
    skin = torch.as_tensor(skin, dtype=fdt, device=dev)
    if skin.ndim == 0:
        skin_t = skin.expand(pos.shape[0])
        skin_s = skin.expand(pos_s.shape[0])
    else:
        skin_t = skin
        if single:
            skin_s = skin
        elif skin_src is not None:
            skin_s = skin_src           # dp cached: the gathered skins
        else:
            skin_s = torch.zeros(pos_s.shape[0], dtype=fdt, device=dev)
    tix = tgrp.tgt_idx.long()

    # target-block AABBs + max h (duplicate slots replicate real members)
    pos_t = pos[tix].reshape(g, bsz, 3)
    h_t = h[tix].reshape(g, bsz)
    tlo = pos_t.amin(dim=1)
    thi = pos_t.amax(dim=1)
    t_hmax = torch.where(tgrp.live, h_t, 0.0).amax(dim=1)
    tvalid = tgrp.live.any(dim=1)
    sk_t = skin_t[tix].reshape(g, bsz)
    d_t = torch.where(tgrp.live, sk_t, 0.0).amax(dim=1)

    # source summaries at block (far MAC) and sub-block granularity
    if single:
        pos_sb, h_sb, sk_s = pos_t, h_t, sk_t
    else:
        six = sgrp.tgt_idx.long()
        pos_sb = pos_s[six].reshape(nb, bsz, 3)
        h_sb = h_s[six].reshape(nb, bsz)
        sk_s = skin_s[six].reshape(nb, bsz)
    m_sb = mass_s[sgrp.tgt_idx.long()].reshape(nb, bsz)
    b_mass, b_cm, _, _, b_bmax2, _ = _block_stats(pos_sb, h_sb, m_sb,
                                                  sgrp.live)
    bvalid = b_mass > 0.0
    s_mass, s_cm, s_amin, s_amax, s_bmax2, s_hmax = _block_stats(
        pos_sb.reshape(nsub, sub, 3), h_sb.reshape(nsub, sub),
        m_sb.reshape(nsub, sub), sgrp.live.reshape(nsub, sub))
    svalid = s_mass > 0.0
    sk_sb = torch.where(sgrp.live, sk_s, 0.0)
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
    if cfg.sph_exact_window > 0:
        sph_idx, n_sph, sph_over = _refine_exact(
            sph_idx, n_sph, sph_over, pos_sb, h_sb, m_sb, sk_sb, sgrp.live,
            pos_t, h_t, sk_t, cfg, h_margin, nsub, sub, chunk)
    elif cfg.sph_refine_subblock:
        sph_idx, n_sph, sph_over = _refine_subblock(
            sph_idx, n_sph, sph_over, pos_sb, h_sb, m_sb, sk_sb, sgrp.live,
            pos_t, h_t, sk_t, cfg, h_margin, nsub, sub, chunk)

    zero = torch.zeros((), dtype=torch.int32, device=dev)
    none_n = torch.zeros(g, dtype=torch.int32, device=dev)
    no_idx = lambda w: torch.full((g, w), -1, dtype=torch.int32, device=dev)
    if not do_grav:
        return BlockStructure(
            tgrp, sgrp, sph_idx, n_sph, no_idx(cfg.p2p_window), none_n,
            no_idx(cfg.m2p_window), none_n,
            torch.zeros((g, _nbpad(nb, chunk)), dtype=torch.float32,
                        device=dev), no_idx(1), none_n, sph_over, zero, zero,
            zero)

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
    blk_idx, n_blk, blk_over = no_idx(1), none_n, zero
    accept_sg = None
    if cfg.sg_blocks > 1:
        # ---- supergroup far tier: sg_blocks Morton-consecutive blocks ----
        sgf = cfg.sg_blocks
        nsg = -(-nb // sgf)
        padb = nsg * sgf - nb
        pad1 = lambda v: torch.nn.functional.pad(v, (0, padb)).reshape(
            nsg, sgf)
        bm_p = pad1(b_mass)        # padded members have mass 0
        cm_p = torch.nn.functional.pad(b_cm, (0, 0, 0, padb)).reshape(
            nsg, sgf, 3)
        sg_mass = bm_p.sum(dim=1)
        sg_cm = ((bm_p[..., None] * cm_p).sum(dim=1)
                 / torch.clamp(sg_mass, min=1e-30)[:, None])
        # tight bmax: max over members of |cm_b - cm_sg| + bmax_b; members
        # without mass (the padding too) do not enter
        dc = cm_p - sg_cm[:, None, :]
        dcm = torch.sqrt(_sum3(dc * dc))
        reach = torch.where(
            bm_p > 0.0,
            dcm + torch.sqrt(torch.clamp(pad1(b_bmax2), min=0.0)), 0.0)
        sg_bmax = reach.amax(dim=1)
        d_sg = pad1(d_b).amax(dim=1)
        mac_sg = mac(sg_cm, sg_bmax * sg_bmax, d_sg) \
            & (sg_mass > 0.0)[None, :]
        sg_cover = mac_sg.repeat_interleave(sgf, dim=1)[:, :nb]
        # block-multipole tier: the block passes the MAC, its supergroup
        # does not: windowed entries instead of a dense scan
        blk_far = covered & ~sg_cover
        blk_idx, n_blk, blk_over = _compact_rows(blk_far, cfg.blk_window)
        covered = (sg_cover & bvalid[None, :]) | blk_far
        accept_sg = torch.nn.functional.pad(
            mac_sg.to(torch.float32), (0, _nbpad(nsg, chunk) - nsg))
    fused = fuse_active(cfg)
    if fused:
        # pass-2 fusion: SPH-window sub-blocks get their near gravity
        # inside pass 2, so they leave every tier here; blocks holding any
        # leave the dense far scan and re-partition at sub granularity
        in_sph = torch.zeros((g, nsub), dtype=torch.int32, device=dev)
        in_sph.scatter_reduce_(1, torch.clamp(sph_idx, 0, nsub - 1).long(),
                               _i32(sph_idx >= 0), reduce="amax")
        in_sph = in_sph > 0
        covered = covered & ~in_sph.reshape(g, nb, spb).any(dim=2)
    blk_exp = covered.repeat_interleave(spb, dim=1)
    rest = (~blk_exp) & tvalid[:, None] & svalid[None, :]
    ring = rest & mac_sub          # sub-block multipole tier
    near = rest & (~mac_sub)       # P2P tier
    if fused:
        ring = ring & ~in_sph
        near = near & ~in_sph
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
    accept = accept_sg if accept_sg is not None else \
        torch.nn.functional.pad(covered.to(torch.float32),
                                (0, _nbpad(nb, chunk) - nb))
    return BlockStructure(tgrp, sgrp, sph_idx, n_sph, _i32(p2p_idx), n_p2p,
                          _i32(m2p_idx), n_m2p, accept.contiguous(),
                          _i32(blk_idx), n_blk, sph_over, p2p_over,
                          m2p_over, blk_over)


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
    # next step's Balsara limiter factor (None unless cfg.av_balsara with
    # viscosity on)
    balsara: Optional[torch.Tensor] = None


class _Ctx(NamedTuple):
    """Sorted-layout fields shared by the sweeps of one evaluation. Under
    data parallelism the targets are the local shard and the sources the
    all-gathered global set, each sorted by its own grouping; a single set
    aliases the two."""
    t: dict                  # target-sorted fields [G*B]
    s: dict                  # source-sorted fields [NB*B]
    single: bool
    g: int
    nb: int


def _sort_set(grp, arrs):
    """A list of [N] fields in the sorted [G*B] layout of `grp` (one
    packed gather)."""
    return packed_permute(arrs, grp.tgt_idx)


def _prep_ctx(pos, h, mass, cfg: SimConfig, st: BlockStructure,
              vel=None, src=None, target_offset=0, sorted_io=False, u=None,
              matid=None, fbal=None) -> _Ctx:
    """The sorted target and source fields. `src`: (pos, h, mass[, vel])
    of the source set, sorted by ``st.src_groups`` (its velocities with
    them when given); None for a single set."""
    single = src is None
    tgrp = st.groups
    g = tgrp.live.shape[0]
    names = ["x", "y", "z", "h", "m"]
    fields = [pos[:, 0], pos[:, 1], pos[:, 2], h, mass]
    if vel is not None:
        names += ["vx", "vy", "vz"]
        fields += [vel[:, 0], vel[:, 1], vel[:, 2]]
    # optional per-particle target channels, sorted beside the geometry
    # (matid rides the packed gather as a float and comes back an integer:
    # ids are < 2^24)
    for k, v in (("mid", matid), ("u", u), ("fb", fbal)):
        if v is not None:
            names.append(k)
            fields.append(v)
    if sorted_io:
        # inputs are already in the padded sorted [G*B] layout
        t = {k: v.contiguous() for k, v in zip(names, fields)}
    else:
        t = dict(zip(names, _sort_set(tgrp, fields)))
    t["ih"] = 1.0 / torch.where(t["h"] > 0, t["h"], 1.0)
    if single:
        s = dict(t)
        s["live"] = tgrp.live.reshape(-1).to(pos.dtype)
        nb = g
    else:
        pos_s, h_s, mass_s = src[:3]
        sgrp = st.src_groups
        nb = sgrp.live.shape[0]
        names = ["x", "y", "z", "h", "m"]
        fields = [pos_s[:, 0], pos_s[:, 1], pos_s[:, 2], h_s, mass_s]
        if len(src) > 3:
            names += ["vx", "vy", "vz"]
            fields += [src[3][:, 0], src[3][:, 1], src[3][:, 2]]
        s = dict(zip(names, _sort_set(sgrp, fields)))
        s["ih"] = 1.0 / torch.where(s["h"] > 0, s["h"], 1.0)
        s["live"] = sgrp.live.reshape(-1).to(pos.dtype)
    # replica/padding slots carry zero SOURCE mass; the TARGET mass keeps
    # the real value (h-solve and the self-phi correction)
    s["m"] = s["m"] * s["live"]
    return _Ctx(t, s, single, g, nb)


def _to_source_layout(x, st: BlockStructure, gather_fn):
    """A target-sorted [G*B] per-particle field in the source-sorted
    [NB*B] layout: the identity for a single set; under dp unsorted to the
    local order, all-gathered (`gather_fn`), sorted by the source
    grouping."""
    if gather_fn is None:
        return x
    local = x[st.groups.unsort_idx.long()]
    return gather_fn(local)[st.src_groups.tgt_idx.long()]


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


def _entry_gather(cols, idx, chunk, pad_rows=0):
    """Per-entry gathers (one value per window slot), padded to chunk.

    `pad_rows` (cfg.gather_pad_rows) is the width, in values, of the packed
    table's rows for the gather: on the TPU rows of 16 bytes or less gather
    at a pathological row rate, and padding them to 128 bytes trades bytes
    for rows. It changes no value; the port pads as the reference does
    where the reference passes it (the exact SPH lists' rows)."""
    w = idx.shape[1]
    safe = torch.clamp(idx, 0, cols[0].shape[0] - 1)
    pad = _nbpad(w, chunk) - w
    return [torch.nn.functional.pad(v, (0, pad))
            for v in packed_permute(cols, safe, pad_to=pad_rows)]


def _cols(*xs):
    return [x.reshape(-1, 1).contiguous() for x in xs]


def _sph_nv(st: BlockStructure, cfg: SimConfig):
    """Valid pair-slot count per target group for the SPH window: the
    particle count of an exact list, else the sub-block count (capped at
    the window's actual, possibly truncated, width) times their size."""
    if cfg.sph_exact_window > 0:
        return _i32(torch.clamp(st.n_sph, max=cfg.sph_exact_window))
    return _i32(torch.clamp(st.n_sph, max=st.sph_idx.shape[1])
                * cfg.nbr_sub)


def _sph_rows(cols, st: BlockStructure, cfg: SimConfig, nb):
    """SPH source rows through the window: contiguous sub-block rows, or
    one packed per-particle gather for exact lists."""
    if cfg.sph_exact_window > 0:
        return _entry_gather(cols, st.sph_idx, cfg.block_chunk,
                             pad_rows=cfg.gather_pad_rows)
    sub = cfg.nbr_sub
    return _window_gather(cols, st.sph_idx, nb * (cfg.nbr_group_size // sub),
                          sub, cfg.block_chunk)


def _geom(s):
    return [s["x"], s["y"], s["z"], s["ih"], s["m"]]


def _near_rows(ctx: _Ctx, cfg: SimConfig, st: BlockStructure):
    """(nv, rows) of the P2P window: x, y, z, [ih,] m of its sub-blocks (no
    ih row under receiver softening)."""
    sub = cfg.nbr_sub
    nsub = ctx.nb * (cfg.nbr_group_size // sub)
    rows = _window_gather(_geom(ctx.s), st.p2p_idx, nsub, sub,
                          cfg.block_chunk)
    if cfg.softening_mode == "receiver_h":
        rows = [rows[0], rows[1], rows[2], rows[4]]
    return _i32(torch.clamp(st.n_p2p, max=cfg.p2p_window) * sub), rows


def _density_sweep(ctx: _Ctx, cfg: SimConfig, st: BlockStructure,
                   t_ih=None, t_h=None, src1=None):
    """Pass 1 against current fields: (rho, nn, omega), target-sorted;
    omega is None outside grad-h. `t_ih`/`t_h` override the target
    smoothing length (the Newton h-solve); `src1` reuses pre-gathered
    geometry rows."""
    t = ctx.t
    bsz = cfg.nbr_group_size
    tih = t["ih"] if t_ih is None else t_ih
    th = t["h"] if t_h is None else t_h
    if src1 is None:
        src1 = _sph_rows(_geom(ctx.s), st, cfg, ctx.nb)
    nv = _sph_nv(st, cfg)
    tgt1 = _cols(t["x"], t["y"], t["z"], tih)
    if cfg.grad_p_mode == "grad_h":
        # the grad-h pass needs no source h: rows = (x, y, z, m)
        rho_c, nn_c, xi_c = gk2.pass1_gradh(
            nv, tgt1, [src1[0], src1[1], src1[2], src1[4]], b=bsz)
        rho = torch.clamp(rho_c[:, 0], min=1e-30)
        omega = 1.0 + th * xi_c[:, 0] / (3.0 * rho)
        return rho, nn_c[:, 0] - 1, omega
    rho_c, nn_c = gk2.pass1_sym(nv, tgt1, src1, b=bsz)
    return torch.clamp(rho_c[:, 0], min=1e-30), nn_c[:, 0] - 1, None


def _gravity_sweeps(ctx: _Ctx, cfg: SimConfig, st: BlockStructure,
                    tiers: str = "all"):
    """Three-tier gravity: windowed sub-granular P2P + windowed ring
    sub-block multipoles + the dense block far scan under the frozen mask
    (current moments); with cfg.sg_blocks > 1 the far scan runs over
    supergroup moments and a fourth, windowed block tier fills the gap.
    Returns (phi, grad_phi, n_direct, n_approx), target-sorted.

    `tiers`: 'all' (one fused launch), 'near' (P2P only, the RESPA inner
    force: no moment reductions, no ring/far gathers), 'far' (ring + blk +
    far scan, the RESPA outer force)."""
    if tiers not in ("all", "near", "far"):
        raise ValueError(f"tiers={tiers!r}: 'all', 'near' or 'far'")
    bsz = cfg.nbr_group_size
    sub = cfg.nbr_sub
    chunk = cfg.block_chunk
    t, s = ctx.t, ctx.s
    nb = ctx.nb
    nsub = nb * (bsz // sub)
    # moments and far rows over the source blocks
    live = st.groups.live if ctx.single else st.src_groups.live
    receiver = cfg.softening_mode == "receiver_h"
    bf16 = cfg.grav_pair_dtype == "bfloat16"
    tgt = _cols(t["x"], t["y"], t["z"], t["ih"])

    # the kernels include the self pair (dx = 0 kills the force, the
    # Dyer-Ip inner branch adds -2.4 m_i/a_i, and it lands in n_direct):
    # both are corrected below
    if tiers != "far":
        self_phi = 2.4 * cfg.g_const * t["m"] * t["ih"]
    if tiers == "near":
        nv_p2p, srcp = _near_rows(ctx, cfg, st)
        phi_c, gx, gy, gz, nd_c = gk2.p2p(
            nv_p2p, tgt, srcp, b=bsz, receiver_soft=receiver,
            g_const=cfg.g_const, bf16=bf16)
        return (phi_c[:, 0] + self_phi, torch.cat([gx, gy, gz], dim=-1),
                nd_c[:, 0] - 1, torch.zeros_like(nd_c[:, 0]))

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

    bmom = moments(nb, bsz)
    npad = st.accept.shape[1]
    blk_kw = {}
    if cfg.sg_blocks > 1:
        # supergroup moments aggregated from the current block moments;
        # blocks whose supergroup failed the MAC while they pass it come in
        # as windowed blk entries
        sgf = cfg.sg_blocks
        nsg = -(-nb // sgf)
        p1 = lambda v: torch.nn.functional.pad(
            v, (0, nsg * sgf - nb)).reshape(nsg, sgf)
        bm_p = p1(bmom[0])
        sgm = bm_p.sum(dim=1)
        inv = 1.0 / torch.clamp(sgm, min=1e-30)
        wsum = lambda v: (bm_p * p1(v)).sum(dim=1) * inv
        far = [sgm, wsum(bmom[1]), wsum(bmom[2]), wsum(bmom[3])]
        if quad:
            # parallel-axis aggregation: Q_sg = sum_b [Q_b
            #   + m_b (3 y y^T - |y|^2 I)], y = cm_b - cm_sg
            yx = p1(bmom[1]) - far[1][:, None]
            yy = p1(bmom[2]) - far[2][:, None]
            yz = p1(bmom[3]) - far[3][:, None]
            y2 = yx * yx + yy * yy + yz * yz
            pq = lambda qb, a, b2, diag: (
                p1(qb) + bm_p * (3.0 * a * b2 - (y2 if diag else 0.0))
            ).sum(dim=1)
            far += [pq(bmom[4], yx, yx, True), pq(bmom[5], yx, yy, False),
                    pq(bmom[6], yx, yz, False), pq(bmom[7], yy, yy, True),
                    pq(bmom[8], yy, yz, False), pq(bmom[9], yz, yz, True)]
        nfar = nsg
        blk_kw = dict(
            nv_blk=_i32(torch.clamp(st.n_blk, max=cfg.blk_window)),
            blk_rows=_entry_gather(bmom, st.blk_idx, chunk))
    else:
        far, nfar = bmom, nb
    far_rows = [torch.nn.functional.pad(v, (0, npad - nfar))[None, :]
                for v in far]
    ring_rows = _entry_gather(moments(nsub, sub), st.m2p_idx, chunk)
    nv_ring = _i32(torch.clamp(st.n_m2p, max=cfg.m2p_window))

    if tiers == "far":
        phi_c, gx, gy, gz, _, na_c = gk2.gravity_fused(
            nv_ring, tgt, ring_rows, far_rows, st.accept, b=bsz,
            g_const=cfg.g_const, bf16=bf16, **blk_kw)
        return (phi_c[:, 0], torch.cat([gx, gy, gz], dim=-1),
                torch.zeros_like(na_c[:, 0]), na_c[:, 0])

    nv_p2p, srcp = _near_rows(ctx, cfg, st)
    phi_c, gx, gy, gz, nd_c, na_c = gk2.gravity_fused(
        nv_ring, tgt, ring_rows, far_rows, st.accept, b=bsz,
        g_const=cfg.g_const, nv_p2p=nv_p2p, p2p_rows=srcp,
        receiver_soft=receiver, bf16=bf16, **blk_kw)
    return (phi_c[:, 0] + self_phi, torch.cat([gx, gy, gz], dim=-1),
            nd_c[:, 0] - 1, na_c[:, 0])


def _unsort(st: BlockStructure, fields):
    """Sorted [G*B] fields back to original order (one packed gather
    through the grouping's inverse permutation)."""
    return packed_permute(fields, st.groups.unsort_idx)


def forces(pos, h, mass, cfg: SimConfig, st: BlockStructure, vel=None,
           u=None, src=None, target_offset=0, gather_fn=None,
           sorted_io=False, matid=None, fbal=None,
           grav_tiers: str = "all") -> BlockForces:
    """Field evaluation against current fields: pass 1 (density, with the
    grad-h Omega under grad_h), the configured EOS, pass 2 (pressure
    gradient in the configured form, viscosity, the Balsara sums and the
    energy equation fused in) and tree gravity.

    `u` (an evolved-u EOS): specific internal energy of the particles; it
    feeds the pressure and the viscosity's sound speed and turns on pass 2's
    energy column (du_dt in the result). `matid`: per-particle Tillotson
    material ids (None = the uniform cfg.material).

    Near gravity comes from pass 2 itself over the SPH window when
    cfg.fuse_p2p_sph (with the residual-P2P window merged into the same
    launch under cfg.fuse_p2p_residual), else from the gravity sweeps.
    `grav_tiers`: 'all', or 'near' / 'far' for the RESPA inner and outer
    forces. `vel` is needed with viscosity or an evolved u; `fbal` is the
    previous step's
    Balsara factors (ones when absent). `sorted_io`: inputs are in the
    padded sorted [G*B] layout and outputs stay in it (the cached
    runner's chunk format).

    `src`/`target_offset`/`gather_fn`: data parallelism. The targets are
    the local shard, `src` = (pos, h, mass[, vel]) the all-gathered global
    set (its velocities with viscosity or an evolved u), and `gather_fn`
    all-gathers a local per-particle field into the global set's order
    (the source side of pass 2's coefficients). `sorted_io` composes with
    it: the targets stay in their sorted layout while the sources are
    sorted by the source grouping at every call."""
    check_slice(cfg)
    bsz = cfg.nbr_group_size
    do_grav = cfg.gravity_solver == "tree"
    gradh = cfg.grad_p_mode == "grad_h"
    av = cfg.av_alpha > 0.0
    balsara = cfg.av_balsara and av
    energy = cfg.evolves_u
    if av and vel is None:
        raise ValueError("artificial viscosity needs velocities; pass vel=")
    if energy and (u is None or vel is None):
        raise ValueError("the energy equation needs u and vel")
    if energy and cfg.grad_p_mode == "reference_asymmetric":
        raise ValueError(f"eos_mode={cfg.eos_mode!r} needs a momentum-"
                         "conserving pressure form (see ops/dense.pass2)")

    ctx = _prep_ctx(pos, h, mass, cfg, st, vel=vel if av or energy else None,
                    src=src, target_offset=target_offset,
                    sorted_io=sorted_io, u=u, matid=matid,
                    fbal=fbal if balsara else None)
    t, s = ctx.t, ctx.s
    to_src = lambda x: _to_source_layout(x, st, gather_fn)
    eos_kw = dict(u=t.get("u"), matid=t.get("mid"))

    # geometry rows gathered ONCE; pass 1 and pass 2 reuse them
    geom_rows = _sph_rows(_geom(s), st, cfg, ctx.nb)
    rho_t, nn_t, omega = _density_sweep(ctx, cfg, st, src1=geom_rows)
    prs_t = eos_ops.pressure_cfg(rho_t, cfg, **eos_kw)

    # Per-particle coefficients are precomputed so the kernel sees ONE
    # extra field per side; the target's rho scale is applied after the
    # sweep. Fully-dead groups sit at the rho floor where P/rho^2 is 0/0:
    # zero the coefficient there.
    tgt2 = _cols(t["x"], t["y"], t["z"], t["ih"])
    rho_ok = rho_t > 1e-20
    if gradh:
        om_safe = torch.clamp(omega, min=0.1)
        cc = torch.where(rho_ok, prs_t / (om_safe * rho_t * rho_t), 0.0)
        tgt2 += _cols(cc)
        p_scale = rho_t
    elif cfg.grad_p_mode == "reference_asymmetric":
        cc = prs_t / rho_t
        p_scale = None
    else:
        cc = torch.where(rho_ok, prs_t / (rho_t * rho_t), 0.0)
        tgt2 += _cols(cc)
        p_scale = rho_t
    s_extra = [to_src(cc)]
    if av:
        cs_t = eos_ops.sound_speed_cfg(rho_t, cfg, **eos_kw)
        tgt2 += _cols(t["vx"], t["vy"], t["vz"], t["h"], cs_t, rho_t)
        s_extra += [s["vx"], s["vy"], s["vz"], s["h"], to_src(cs_t),
                    to_src(rho_t)]
        if balsara:
            fb_t = t.get("fb")
            if fb_t is None:
                fb_t = torch.ones_like(rho_t)
            tgt2 += _cols(fb_t)
            s_extra += [to_src(fb_t)]
    elif energy:
        # the energy equation without viscosity still needs the pairwise
        # velocities
        tgt2 += _cols(t["vx"], t["vy"], t["vz"])
        s_extra += [s["vx"], s["vy"], s["vz"]]
    extra_rows = _sph_rows(s_extra, st, cfg, ctx.nb)
    fused = do_grav and grav_tiers != "far" and fuse_active(cfg)
    receiver = cfg.softening_mode == "receiver_h"
    # residual-P2P merge: the non-SPH near window is swept inside the same
    # launch, one launch fewer on the per-step path
    merged = fused and cfg.fuse_p2p_residual
    p2p_kw = {}
    if merged:
        p2p_kw = dict(zip(("nv_p2p", "p2p_rows"), _near_rows(ctx, cfg, st)))
    outs = gk2.pass2(
        _sph_nv(st, cfg), tgt2, geom_rows + extra_rows, b=bsz,
        mode=cfg.grad_p_mode, av=av, balsara=balsara, energy=energy,
        sign_bug=cfg.kernel_deriv_sign_bug, av_alpha=cfg.av_alpha,
        av_beta=cfg.av_beta, grav=fused, receiver_soft=receiver,
        g_const=cfg.g_const, **p2p_kw)
    # the rows (GBs at 100k with viscosity) are dead past the launch
    del geom_rows, extra_rows, p2p_kw, tgt2
    grad_p_t = torch.cat(outs[:3], dim=-1)
    if p_scale is not None:
        grad_p_t = grad_p_t * p_scale[:, None]
    if av:
        # the viscosity term carries the target's rho scale in every mode
        grad_p_t = grad_p_t + torch.cat(outs[3:6], dim=-1) * rho_t[:, None]
    fb_next_t = None
    if balsara:
        from . import dense as dense_ops
        fb_next_t = dense_ops.balsara_factor(
            torch.cat(outs[6:10], dim=-1), cs_t, rho_t, t["h"])
    n_base = (3 + (3 if av else 0) + (4 if balsara else 0)
              + (1 if energy else 0))
    # the energy rate is complete as summed: no rho scale
    du_t = outs[n_base - 1][:, 0] if energy else torch.zeros_like(rho_t)

    # ---- gravity ----
    if do_grav:
        if merged:
            # pass 2 swept BOTH near windows; only the far tiers come from
            # the gravity sweeps, and not on a RESPA inner evaluation.
            # +self_phi offsets the Dyer-Ip self potential the SPH rows
            # include, -1 the self pair in n_direct.
            self_phi = 2.4 * cfg.g_const * t["m"] * t["ih"]
            if grav_tiers == "near":
                phi_t = self_phi
                grad_phi_t = torch.zeros_like(grad_p_t)
                na_t = torch.zeros_like(nn_t)
            else:
                phi_f, grad_phi_t, _, na_t = _gravity_sweeps(ctx, cfg, st,
                                                             tiers="far")
                phi_t = phi_f + self_phi
            nd_t = -torch.ones_like(nn_t)
        else:
            phi_t, grad_phi_t, nd_t, na_t = _gravity_sweeps(
                ctx, cfg, st, tiers=grav_tiers)
        if fused:
            # the fused near part from pass 2: the tier sweep's +2.4 G m/h
            # and its nd - 1 offset the self pair included here
            phi_t = phi_t + outs[n_base][:, 0]
            grad_phi_t = grad_phi_t + torch.cat(
                outs[n_base + 1:n_base + 4], dim=-1)
            nd_t = nd_t + outs[n_base + 4][:, 0]
    else:
        phi_t = torch.zeros_like(rho_t)
        grad_phi_t = torch.zeros_like(grad_p_t)
        nd_t = torch.zeros_like(nn_t)
        na_t = torch.zeros_like(nn_t)

    fields = [rho_t, prs_t, grad_p_t, phi_t, grad_phi_t, nn_t, nd_t, na_t,
              du_t]
    if sorted_io:
        return BlockForces(*fields, fb_next_t)
    if fb_next_t is not None:
        fields.append(fb_next_t)
    return BlockForces(*_unsort(st, fields))


def gravity(pos, h, mass, cfg: SimConfig, st: BlockStructure, src=None,
            target_offset=0):
    """Tree gravity only: (phi, grad_phi, n_direct, n_approx) in original
    order, every tier in one launch — for runs whose SPH goes through the
    dense pipeline while gravity uses the block tree (the parity
    preset). `src`: (pos, h, mass) of a global source set (dp)."""
    check_slice(cfg)
    ctx = _prep_ctx(pos, h, mass, cfg, st, src=src,
                    target_offset=target_offset)
    return tuple(_unsort(st, list(_gravity_sweeps(ctx, cfg, st))))


def gravity_far(pos, h, mass, cfg: SimConfig, st: BlockStructure,
                sorted_io=False, src=None, target_offset=0):
    """Far-tier tree gravity only (ring sub-block multipoles + dense block
    scan): (phi_far, grad_phi_far, n_approx) — the RESPA outer force.
    `src`: (pos, h, mass) of a global source set (dp): the moments then
    sum over the global source blocks."""
    check_slice(cfg)
    ctx = _prep_ctx(pos, h, mass, cfg, st, sorted_io=sorted_io, src=src,
                    target_offset=target_offset)
    phi_t, grad_phi_t, _, na_t = _gravity_sweeps(ctx, cfg, st, tiers="far")
    if sorted_io:
        return phi_t, grad_phi_t, na_t
    return tuple(_unsort(st, [phi_t, grad_phi_t, na_t]))


def solve_h_newton(pos, h, mass, cfg: SimConfig, eta: float, src=None,
                   target_offset=0, groups=None, rho0=None):
    """Fixed-point solve of h = eta (m/rho(h))^(1/3) on the block pipeline.

    Builds a throwaway structure whose cutoffs are widened by the clamp
    margin c (capacities scaled by (1+c)^3), then iterates the gather-form
    density with h clamped to [h/(1+c), h*(1+c)]. `rho0` warm-starts with
    one fixed-point step from the state's density before the build (and
    one fewer sweep). Under exact lists the solve builds its own, at
    cfg.h_solve_window or the exact window scaled by (1+c)^3. `src`: (pos,
    h, mass) of a global source set (dp), whose densities the targets'
    sums take; `groups` is then a (target, source) pair. Returns the new h
    in original order."""
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
    # exact lists: the solve refines its own margin-valid lists
    wx = 0
    if cfg.sph_exact_window > 0:
        wx = cfg.h_solve_window or scale(cfg.sph_exact_window,
                                         cfg.block_chunk)
    cfg = cfg.replace(sph_exact_window=wx,
                      nbr_window=scale(cfg.nbr_window, 16),
                      sph_refined_window=(scale(cfg.sph_refined_window, 16)
                                          if cfg.sph_refined_window else 0))
    st = build(pos, h, mass, cfg, src=src, target_offset=target_offset,
               h_margin=c, groups=groups, sph_only=True)
    ctx = _prep_ctx(pos, h, mass, cfg, st, src=src,
                    target_offset=target_offset)
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
            "tree_overflow": (st.p2p_overflow + st.m2p_overflow
                              + st.blk_overflow)}
