"""Exact all-pairs SPH + gravity passes, blocked (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/dense.py``: each block of
`cfg.block_n` target rows evaluates the kernel against all sources as a
[block, S] broadcast and masks pairs outside the support, so the N^2 pair
tensor is never held at once. The reference's ``jax.lax.map`` over i-blocks
is a Python loop here. This is the plain formulation (q = r/h, divisions,
a = max(h_i, h_j)); the all-pairs CUDA kernels and their plain twins in
``ops/cuda/pairwise.py`` use the reciprocal formulation and agree with this
module to rounding, not bit for bit.

Both passes take a target/source split (`src`, `target_offset`) as the
reference does for sharded sources. With `energy=True` pass 2, the grad-h
pass 2 and the standalone viscosity sweep also accumulate the conjugate
energy equation; `u` and `matid` feed the adiabatic or Tillotson sound speed
of the viscosity. A dense run with an evolved internal energy takes these
functions on the card too: the all-pairs CUDA kernels have no energy column,
as the reference's do not.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from . import eos as eos_ops
from . import gravity as grav_ops
from . import kernels


class Pass1Out(NamedTuple):
    rho: torch.Tensor          # [N]   SPH density
    n_neighbors: torch.Tensor  # [N]   count of j with W(r, h_i) > 0
    phi: torch.Tensor          # [N]   gravitational potential
    grad_phi: torch.Tensor     # [N,3] potential gradient
    n_direct: torch.Tensor     # [N]   P2P terms used


def _guard(x):
    return torch.where(x > 0, x, 1.0)


def _blocks(n, cfg: SimConfig):
    b = max(1, min(cfg.block_n, n))
    return [(i0, min(n, i0 + b)) for i0 in range(0, n, b)]


def _pair_mask(i0, i1, target_offset, mass_s):
    idx_i = torch.arange(i0, i1, device=mass_s.device) + int(target_offset)
    sidx = torch.arange(mass_s.shape[0], device=mass_s.device)
    return (idx_i[:, None] != sidx[None, :]) & (mass_s > 0.0)[None, :]


def pass1(pos, h, mass, cfg: SimConfig, src=None, target_offset: int = 0,
          sph: bool = True) -> Pass1Out:
    """Density + neighbour count + direct gravity in one sweep.

    `src`: optional (pos_src, h_src, mass_src) source set (mass 0 = inert);
    `target_offset`: index of targets[0] in the source ordering, for the
    self-pair mask. `sph=False` skips the kernel math (gravity only; rho
    and n_neighbors come back zero)."""
    n = pos.shape[0]
    h_t = _guard(h)
    pos_s, h_s, mass_s = src if src is not None else (pos, h, mass)
    h_s = _guard(h_s)
    do_gravity = cfg.gravity_solver == "direct"
    outs = []
    for i0, i1 in _blocks(n, cfg):
        pos_i, h_i, m_i = pos[i0:i1], h_t[i0:i1], mass[i0:i1]
        dx = pos_i[:, None, :] - pos_s[None, :, :]
        r2 = (dx * dx).sum(dim=-1)
        r = torch.sqrt(r2)
        pair = _pair_mask(i0, i1, target_offset, mass_s)
        m_eff = torch.where(pair, mass_s[None, :], 0.0)
        if sph:
            w_i = kernels.w(r, h_i[:, None])
            w_j = kernels.w(r, h_s[None, :])
            rho = m_i * kernels.w0(h_i) \
                + (m_eff * (0.5 * (w_i + w_j))).sum(dim=-1)
            nn = ((w_i > 0.0) & pair).sum(dim=-1).to(torch.int32)
        else:
            rho = torch.zeros_like(h_i)
            nn = torch.zeros(h_i.shape, dtype=torch.int32, device=h.device)
        if do_gravity:
            if cfg.softening_mode == "receiver_h":
                a = h_i[:, None].expand_as(r)
            else:
                a = torch.maximum(h_i[:, None], h_s[None, :])
            gp, phi = grav_ops.dyer_ip(dx, r, m_eff, a, cfg.g_const)
            phi_i = phi.sum(dim=-1)
            gphi_i = gp.sum(dim=-2)
            nd = pair.sum(dim=-1).to(torch.int32)
        else:
            phi_i = torch.zeros_like(rho)
            gphi_i = torch.zeros_like(pos_i)
            nd = torch.zeros_like(nn)
        outs.append((rho, nn, phi_i, gphi_i, nd))
    return Pass1Out(*(torch.cat(p, dim=0) for p in zip(*outs)))


def density_gradh(pos, h, mass, cfg: SimConfig, src=None, target_offset=0):
    """Gather-form density rho_i = sum_j m_j W(r_ij, h_i) (self term
    included) and the grad-h factor Omega_i = 1 + h_i/(3 rho_i) sum_j m_j
    dW/dh(r_ij, h_i). Returns (rho, omega, n_neighbors)."""
    n = pos.shape[0]
    h_t = _guard(h)
    pos_s, h_s, mass_s = src if src is not None else (pos, h, mass)
    outs = []
    for i0, i1 in _blocks(n, cfg):
        pos_i, h_i, m_i = pos[i0:i1], h_t[i0:i1], mass[i0:i1]
        dx = pos_i[:, None, :] - pos_s[None, :, :]
        r = torch.sqrt((dx * dx).sum(dim=-1))
        pair = _pair_mask(i0, i1, target_offset, mass_s)
        m_eff = torch.where(pair, mass_s[None, :], 0.0)
        w_i = kernels.w(r, h_i[:, None])
        rho = m_i * kernels.w0(h_i) + (m_eff * w_i).sum(dim=-1)
        # self term of dW/dh: dW/dh(0,h) = -3 W(0,h)/h
        xi = (-3.0 * m_i * kernels.w0(h_i) / h_i
              + (m_eff * kernels.dw_dh(r, h_i[:, None])).sum(dim=-1))
        omega = 1.0 + h_i * xi / (3.0 * rho)
        nn = ((w_i > 0.0) & pair).sum(dim=-1).to(torch.int32)
        outs.append((rho, omega, nn))
    return tuple(torch.cat(p, dim=0) for p in zip(*outs))


def pass2_gradh(pos, h, mass, rho, omega, pressure, cfg: SimConfig,
                src=None, target_offset=0, energy: bool = False,
                vel=None, vel_src=None):
    """Grad-h symmetric pressure force as an effective gradient:
    gradP_i = rho_i sum_j m_j [P_i/(Omega_i rho_i^2) gradW_i(h_i)
    + P_j/(Omega_j rho_j^2) gradW_i(h_j)]. `src`: optional (pos, h, mass,
    coef) with coef = P/(Omega rho^2) of the source set.

    `energy=True` returns (grad_p, du_dt) with the Springel & Hernquist
    (2002) conjugate energy equation from the same sweep, du_i/dt =
    P_i/(Omega_i rho_i^2) sum_j m_j v_ij . gradW(r, h_i) (viscous heating is
    viscosity_accel's own energy term on this pipeline). Needs `vel`
    (`vel_src` for a separate source set)."""
    if energy and vel is None:
        raise ValueError("the energy equation needs velocities; pass vel=")
    n = pos.shape[0]
    h_t = _guard(h)
    # robustness floor: the discrete Omega can approach 0 at very low
    # neighbour counts; clamping keeps the pairwise terms antisymmetric
    om = torch.clamp(omega, min=0.1)
    rho_t = _guard(rho)
    coef = pressure / (om * rho_t * rho_t)
    pos_s, h_s, mass_s, coef_s = src if src is not None \
        else (pos, h, mass, coef)
    h_s = _guard(h_s)
    vel_s = vel if vel_src is None else vel_src
    sign_bug = cfg.kernel_deriv_sign_bug
    outs = []
    for i0, i1 in _blocks(n, cfg):
        pos_i, h_i = pos[i0:i1], h_t[i0:i1]
        dx = pos_i[:, None, :] - pos_s[None, :, :]
        r = torch.sqrt((dx * dx).sum(dim=-1))
        pair = _pair_mask(i0, i1, target_offset, mass_s)
        m_eff = torch.where(pair, mass_s[None, :], 0.0)
        gw_i = kernels.dw_dr_over_r(r, h_i[:, None], sign_bug)
        gw_j = kernels.dw_dr_over_r(r, h_s[None, :], sign_bug)
        radial = m_eff * (coef[i0:i1, None] * gw_i + coef_s[None, :] * gw_j)
        accel = -(dx * radial[..., None]).sum(dim=-2)
        du = None
        if energy:
            dv = vel[i0:i1, None, :] - vel_s[None, :, :]
            vdotr = (dv * dx).sum(dim=-1)
            du = coef[i0:i1] * (m_eff * gw_i * vdotr).sum(dim=-1)
        outs.append((-rho_t[i0:i1, None] * accel, du))
    grad_p = torch.cat([o[0] for o in outs], dim=0)
    if energy:
        return grad_p, torch.cat([o[1] for o in outs], dim=0)
    return grad_p


def balsara_factor(dc, cs, rho, h):
    """Balsara (1995) AV limiter f = |div v| / (|div v| + |curl v| +
    1e-4 c/h) from the RAW pass-2 sums dc[N,4] (rho*div, rho*curl up to
    sign: the shared 1/rho cancels, so the eps term carries the rho)."""
    d = dc[:, 0].abs()
    c = torch.sqrt((dc[:, 1:] * dc[:, 1:]).sum(dim=-1))
    eps = 1e-4 * cs * torch.clamp(rho, min=1e-30) / torch.clamp(h, min=1e-30)
    return d / (d + c + eps + 1e-30)


def _av_terms(cfg, dx, dv, r2, pair, h_i, h_s, cs_i, cs_s, rho_i, rho_s,
              fb_i, fb_s):
    """Monaghan Pi_ij [b,S] (Balsara-limited when fb_* are given) and
    v_ij . x_ij."""
    vdotr = (dv * dx).sum(dim=-1)
    hbar = 0.5 * (h_i[:, None] + h_s[None, :])
    mu = hbar * vdotr / (r2 + 0.01 * hbar * hbar)
    cbar = 0.5 * (cs_i[:, None] + cs_s[None, :])
    rhobar = 0.5 * (rho_i[:, None] + rho_s[None, :])
    pi_ij = torch.where(
        pair & (vdotr < 0.0),
        (-cfg.av_alpha * cbar * mu + cfg.av_beta * mu * mu) / rhobar, 0.0)
    if fb_i is not None:
        pi_ij = pi_ij * (0.5 * (fb_i[:, None] + fb_s[None, :]))
    return pi_ij, vdotr


def _returns(outs, energy, balsara):
    """Per-block (main, du, dc) triples to the reference's return shape:
    the main field, then du with energy, then dc with balsara; a bare
    tensor when it is alone."""
    ret = [torch.cat([o[0] for o in outs], dim=0)]
    if energy:
        ret.append(torch.cat([o[1] for o in outs], dim=0))
    if balsara:
        ret.append(torch.cat([o[2] for o in outs], dim=0))
    return tuple(ret) if len(ret) > 1 else ret[0]


def _dc_sums(g_dc, vdotr, dv, dx):
    div_sum = (g_dc * vdotr).sum(dim=-1)
    curl_sum = (torch.linalg.cross(dv, dx) * g_dc[..., None]).sum(dim=-2)
    return torch.cat([div_sum[:, None], curl_sum], dim=-1)


def viscosity_accel(pos, vel, h, mass, rho, cfg: SimConfig, src=None,
                    target_offset=0, energy: bool = False, u=None,
                    u_src=None, matid=None, matid_src=None, fbal=None,
                    fbal_src=None):
    """Monaghan (1992) artificial-viscosity acceleration, standalone sweep:
    a_i -= sum m_j Pi_ij grad W_sym, always with the CORRECT kernel
    derivative. `src`: optional (pos, vel, h, mass, rho). Returns accel,
    then with `energy=True` the shock-heating rate du_i/dt = 1/2 sum_j m_j
    Pi_ij v_ij . gradW_sym of the same sweep (`u`/`u_src` and
    `matid`/`matid_src` then feed the sound speed in Pi_ij), then under
    cfg.av_balsara the raw div/curl sums dc; a tuple when more than one."""
    n = pos.shape[0]
    balsara = cfg.av_balsara
    if src is None:
        src = (pos, vel, h, mass, rho)
        u_src, matid_src, fbal_src = u, matid, fbal
    pos_s, vel_s, h_s, mass_s, rho_s = src
    h_s, rho_s = _guard(h_s), _guard(rho_s)
    cs_s = eos_ops.sound_speed_cfg(rho_s, cfg, u=u_src, matid=matid_src)
    h_t, rho_t = _guard(h), _guard(rho)
    cs_t = eos_ops.sound_speed_cfg(rho_t, cfg, u=u, matid=matid)
    if balsara:
        fb_t = fbal if fbal is not None else torch.ones_like(rho)
        fb_s = fbal_src if fbal_src is not None else torch.ones_like(rho_s)
    outs = []
    for i0, i1 in _blocks(n, cfg):
        pos_i, h_i = pos[i0:i1], h_t[i0:i1]
        dx = pos_i[:, None, :] - pos_s[None, :, :]
        dv = vel[i0:i1, None, :] - vel_s[None, :, :]
        r2 = (dx * dx).sum(dim=-1)
        pair = _pair_mask(i0, i1, target_offset, mass_s)
        pi_ij, vdotr = _av_terms(
            cfg, dx, dv, r2, pair, h_i, h_s, cs_t[i0:i1], cs_s,
            rho_t[i0:i1], rho_s, fb_t[i0:i1] if balsara else None,
            fb_s if balsara else None)
        r = torch.sqrt(r2)
        gsym = 0.5 * (kernels.dw_dr_over_r(r, h_i[:, None], False)
                      + kernels.dw_dr_over_r(r, h_s[None, :], False))
        m_eff = torch.where(pair, mass_s[None, :], 0.0)
        acc = -(dx * (m_eff * pi_ij * gsym)[..., None]).sum(dim=-2)
        du = 0.5 * (m_eff * pi_ij * gsym * vdotr).sum(dim=-1) if energy \
            else None
        dc = _dc_sums(m_eff * gsym, vdotr, dv, dx) if balsara else None
        outs.append((acc, du, dc))
    return _returns(outs, energy, balsara)


def pass2(pos, h, mass, rho, pressure, cfg: SimConfig, src=None,
          target_offset: int = 0, vel=None, energy: bool = False, u=None,
          u_src=None, matid=None, matid_src=None, fbal=None, fbal_src=None):
    """Pressure gradient grad P_i, [N,3].

    'reference_asymmetric': sum_j (m_j / rho_j) P_j gradW_sym (no self
    term). 'symmetric': rho_i sum_j m_j (P_i/rho_i^2 + P_j/rho_j^2)
    gradW_sym. `src`: optional (pos, h, mass, rho, prs[, vel]). `vel` with
    cfg.av_alpha > 0 fuses the Monaghan AV term into the sweep (as
    -rho_i a_AV, always the correct kernel derivative); under
    cfg.av_balsara Pi_ij is limited by 0.5 (f_i + f_j) from the lagged
    `fbal`/`fbal_src` (default 1) and the raw div/curl sums dc[N,4] are
    returned last.

    `energy=True` also accumulates the conjugate specific-internal-energy
    rate in the same sweep, returned second: du_i/dt = 1/2 sum_j m_j
    (P_i/rho_i^2 + P_j/rho_j^2) v_ij . gradW_sym + 1/2 sum_j m_j Pi_ij
    v_ij . gradW_sym, the pairwise-antisymmetric partner of the symmetric
    momentum equation. Needs `vel` (and the source velocities in `src`);
    `u`/`u_src` and `matid`/`matid_src` feed the viscosity's sound speed."""
    n = pos.shape[0]
    av = cfg.av_alpha > 0.0 and vel is not None
    balsara = cfg.av_balsara and av
    if energy and vel is None:
        raise ValueError("the energy equation needs velocities; pass vel=")
    if energy and cfg.grad_p_mode == "reference_asymmetric":
        raise ValueError("an evolved internal energy needs a momentum-"
                         "conserving pressure form (the reference-asymmetric "
                         "force has no conjugate energy equation)")
    need_vel = av or energy
    if src is None:
        src = (pos, h, mass, rho, pressure) + ((vel,) if need_vel else ())
        u_src, matid_src, fbal_src = u, matid, fbal
    pos_s, h_s, mass_s, rho_s, prs_s = src[:5]
    h_s, rho_s = _guard(h_s), _guard(rho_s)
    h_t, rho_t = _guard(h), _guard(rho)
    if need_vel:
        vel_s = src[5]
    if av:
        cs_s = eos_ops.sound_speed_cfg(rho_s, cfg, u=u_src, matid=matid_src)
        cs_t = eos_ops.sound_speed_cfg(rho_t, cfg, u=u, matid=matid)
    if balsara:
        fb_t = fbal if fbal is not None else torch.ones_like(rho)
        fb_s = fbal_src if fbal_src is not None else torch.ones_like(rho_s)
    sign_bug = cfg.kernel_deriv_sign_bug
    outs = []
    for i0, i1 in _blocks(n, cfg):
        pos_i, h_i = pos[i0:i1], h_t[i0:i1]
        rho_i, prs_i = rho_t[i0:i1], pressure[i0:i1]
        dx = pos_i[:, None, :] - pos_s[None, :, :]
        r2 = (dx * dx).sum(dim=-1)
        r = torch.sqrt(r2)
        pair = _pair_mask(i0, i1, target_offset, mass_s)
        gw_i = kernels.dw_dr_over_r(r, h_i[:, None], sign_bug)
        gw_j = kernels.dw_dr_over_r(r, h_s[None, :], sign_bug)
        gsym = 0.5 * (gw_i + gw_j)
        m_eff = torch.where(pair, mass_s[None, :], 0.0)
        if cfg.grad_p_mode == "reference_asymmetric":
            coef = m_eff * (prs_s / rho_s)[None, :] * gsym
            pcoef = None
        else:
            pcoef = m_eff * ((prs_i / (rho_i * rho_i))[:, None]
                             + (prs_s / (rho_s * rho_s))[None, :]) * gsym
            coef = pcoef * rho_i[:, None]
        ecoef = pcoef if energy else None
        dc = None
        if need_vel:
            dv = vel[i0:i1, None, :] - vel_s[None, :, :]
            vdotr = (dv * dx).sum(dim=-1)
        if av:
            pi_ij, _ = _av_terms(
                cfg, dx, dv, r2, pair, h_i, h_s, cs_t[i0:i1], cs_s, rho_i,
                rho_s, fb_t[i0:i1] if balsara else None,
                fb_s if balsara else None)
            if sign_bug:
                gs_av = 0.5 * (kernels.dw_dr_over_r(r, h_i[:, None], False)
                               + kernels.dw_dr_over_r(r, h_s[None, :],
                                                      False))
            else:
                gs_av = gsym
            coef = coef + m_eff * pi_ij * gs_av * rho_i[:, None]
            if energy:
                ecoef = ecoef + m_eff * pi_ij * gs_av
            if balsara:
                dc = _dc_sums(m_eff * gs_av, vdotr, dv, dx)
        du = 0.5 * (ecoef * vdotr).sum(dim=-1) if energy else None
        outs.append(((dx * coef[..., None]).sum(dim=-2), du, dc))
    return _returns(outs, energy, balsara)
