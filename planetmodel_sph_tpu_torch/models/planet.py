"""The planet model's cached stepping (PyTorch port, production path).

Counterpart of ``planetmodel_sph_tpu/models/planet.py`` for the path the
``jupiter_100k`` preset runs: Verlet-cached chunks of `rebuild_every`
leapfrog KDK steps with the Newton h-solve at each chunk boundary, the
state kept in the Morton-sorted padded layout for the chunk, per-step h
tracking, impulse-RESPA far-field kicks and the centre-of-mass correction.
The reference's ``lax.scan`` loops are Python loops here; the eager
operations run on whatever device holds the state's tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..config import SimConfig, check_slice
from ..ops import structure
from ..state import ParticleState


class Forces(NamedTuple):
    rho: torch.Tensor
    pressure: torch.Tensor
    grad_p: torch.Tensor
    phi: torch.Tensor
    grad_phi: torch.Tensor
    n_neighbors: torch.Tensor
    n_direct: torch.Tensor
    n_approx: torch.Tensor
    accel: torch.Tensor
    h: torch.Tensor
    du_dt: torch.Tensor
    overflow: Optional[dict] = None


def h_eta(cfg: SimConfig) -> float:
    """eta in h = eta (m/rho)^(1/3) giving target_neighbors in radius kappa*h."""
    return ((3.0 * cfg.target_neighbors / (4.0 * math.pi)) ** (1.0 / 3.0)
            / cfg.kappa)


def com_correct(grad_phi, mass, cfg: SimConfig):
    """Opt-in exact momentum conservation for tree gravity: subtract the
    mass-weighted mean potential gradient so sum(m_i a_grav,i) = 0."""
    if not (cfg.grav_com_correction and cfg.gravity_solver == "tree"):
        return grad_phi
    f = (mass[:, None] * grad_phi).sum(dim=0)
    return grad_phi - f[None, :] / mass.sum()


def _skin(cfg: SimConfig, vel, accel):
    """PER-PARTICLE bound on motion over a rebuild period ([N]):
    safety * (|v| T + 0.5 |a| T^2), T = rebuild_every * dt."""
    if cfg.rebuild_every <= 1:
        return torch.zeros(vel.shape[:1], dtype=vel.dtype, device=vel.device)
    t = cfg.rebuild_every * cfg.dt
    v = torch.sqrt((vel * vel).sum(dim=-1))
    a = torch.sqrt((accel * accel).sum(dim=-1))
    return cfg.skin_safety * (t * v + 0.5 * t * t * a)


def _h_tracking(cfg: SimConfig) -> bool:
    return (cfg.h_track_margin > 0.0 and cfg.adaptive_h
            and cfg.h_mode == "newton" and cfg.grad_p_mode == "grad_h"
            and cfg.neighbor_mode == "grid")


def _build_caches(pos, h, mass, vel, cfg: SimConfig, accel=None,
                  groups=None):
    if accel is None:
        accel = torch.zeros_like(vel)
    return structure.build(pos, h, mass, cfg, skin=_skin(cfg, vel, accel),
                           groups=groups, h_margin=cfg.h_track_margin)


def _forces_block(pos, h, mass, cfg: SimConfig, st, vel=None, solve_h=True,
                  sorted_io=False, grav_tiers="all") -> Forces:
    """Force evaluation on the block pipeline. `solve_h`: run the bounded
    Newton h-solve and a fresh build first (the uncached path); the cached
    runner passes False. `sorted_io`: state in the padded sorted layout."""
    if (solve_h and cfg.adaptive_h and cfg.h_mode == "newton"
            and cfg.grad_p_mode == "grad_h"):
        h = structure.solve_h_newton(pos, h, mass, cfg, h_eta(cfg))
        st = structure.build(pos, h, mass, cfg)
    bf = structure.forces(pos, h, mass, cfg, st, vel=vel,
                          sorted_io=sorted_io, grav_tiers=grav_tiers)
    # padding slots duplicate real particles: weight the COM reduction by
    # the live mask so duplicates don't bias the net force
    m_eff = mass * st.groups.live.reshape(-1) if sorted_io else mass
    grad_phi = com_correct(bf.grad_phi, m_eff, cfg)
    accel = -bf.grad_p / bf.rho[:, None] - grad_phi
    return Forces(bf.rho, bf.pressure, bf.grad_p, bf.phi, grad_phi,
                  bf.n_neighbors, bf.n_direct, bf.n_approx, accel, h,
                  bf.du_dt, structure.overflow_info(st))


def _damp(vel, dt, cfg: SimConfig):
    """Settling-run velocity damping (cfg.vel_damping; no-op by default)."""
    if cfg.vel_damping <= 0.0 or cfg.freeze_velocity:
        return vel
    return vel * math.exp(-cfg.vel_damping * dt)


def _apply_forces(state: ParticleState, f: Forces) -> ParticleState:
    return state.replace(
        rho=f.rho, pressure=f.pressure, grad_p=f.grad_p, phi=f.phi,
        grad_phi=f.grad_phi, n_neighbors=f.n_neighbors,
        n_direct=f.n_direct, n_approx=f.n_approx, accel=f.accel, h=f.h,
        du_dt=f.du_dt)


def step_kdk(state: ParticleState, cfg: SimConfig, forces_fn):
    """Leapfrog kick-drift-kick; state.accel carries a(x_n). The smoothing
    length is whatever the caller put in the state (the cached runner
    updates it at chunk boundaries and by tracking)."""
    dt = cfg.dt
    v_half = state.vel if cfg.freeze_velocity \
        else state.vel + 0.5 * dt * state.accel
    pos = state.pos + dt * v_half
    f = forces_fn(pos, state.h, state.mass, vel=v_half)
    vel = v_half if cfg.freeze_velocity else v_half + 0.5 * dt * f.accel
    return _apply_forces(state, f).replace(pos=pos, vel=_damp(vel, dt, cfg))


def _permute_state(state: ParticleState, idx):
    """Reorder every state field by `idx` via one packed row gather."""
    names = [f.name for f in dataclasses.fields(state)]
    vals = structure.packed_permute([getattr(state, n) for n in names], idx)
    return ParticleState(**dict(zip(names, vals)))


def _check_runner(cfg: SimConfig):
    check_slice(cfg)
    if cfg.rebuild_every <= 1:
        raise NotImplementedError("rebuild_every<=1: the uncached step is "
                                  "not ported; the port runs cached chunks")
    if not (cfg.adaptive_h and cfg.h_mode == "newton"):
        raise NotImplementedError("the port runs the Newton h-solve only "
                                  "(adaptive_h=True, h_mode='newton')")
    if cfg.integrator != "leapfrog_kdk" or cfg.dt_mode != "fixed":
        raise NotImplementedError("the port runs fixed-dt leapfrog KDK only")
    if not cfg.sorted_chunks:
        raise NotImplementedError("sorted_chunks=False is not ported")


def chunk_setup(state: ParticleState, cfg: SimConfig, groups=None):
    """The rebuild at a chunk boundary: Newton h-solve (warm-started from
    the state's density), the cached structure, and the state permuted
    into its padded sorted layout. Returns (sorted state, structure)."""
    _check_runner(cfg)
    state = state.replace(h=structure.solve_h_newton(
        state.pos, state.h, state.mass, cfg, h_eta(cfg), groups=groups,
        rho0=state.rho))
    st = _build_caches(state.pos, state.h, state.mass, state.vel, cfg,
                       accel=state.accel, groups=groups)
    return _permute_state(state, st.groups.tgt_idx), st


def run_chunk_cached(state: ParticleState, cfg: SimConfig, k: int,
                     groups=None, return_groups=False):
    """Rebuild structures once, then advance k fixed-structure steps.

    Returns (state, info) — or (state, info, groups) with
    `return_groups=True` — where info carries the rebuild's overflow
    counters and groups is the Morton grouping used (for sort_every
    reuse). With respa_every dividing k the far tiers are impulse-RESPA
    kicks around respa_every inner near-field steps; otherwise every step
    evaluates every tier."""
    run_state, st = chunk_setup(state, cfg, groups)
    info = structure.overflow_info(st)
    live_w = st.groups.live.reshape(-1).to(run_state.pos.dtype)

    if _h_tracking(cfg):
        eta = h_eta(cfg)
        h_rb = run_state.h
        t_lo = h_rb / (1.0 + cfg.h_track_margin)
        t_hi = h_rb * (1.0 + cfg.h_track_margin)
        if cfg.h_max > 0.0:
            t_hi = torch.clamp(t_hi, max=cfg.h_max)

        def _tracked(s):
            h_t = eta * torch.pow(s.mass / torch.clamp(s.rho, min=1e-30),
                                  1.0 / 3.0)
            return s.replace(h=torch.minimum(torch.maximum(h_t, t_lo),
                                             t_hi))
    else:
        _tracked = lambda s: s

    def forces_fn(tiers):
        return lambda p, hh, m, vel=None: _forces_block(
            p, hh, m, cfg, st, vel=vel, solve_h=False, sorted_io=True,
            grav_tiers=tiers)

    respa = cfg.respa_every > 1 and k % cfg.respa_every == 0
    out = run_state
    if respa:
        m = cfg.respa_every
        dt = cfg.dt
        mass_r = run_state.mass

        def far_eval(s):
            phi_f, gphi_f, na_f = structure.gravity_far(
                s.pos, s.h, mass_r, cfg, st, sorted_io=True)
            return phi_f, com_correct(gphi_f, mass_r * live_w, cfg), na_f

        near_fn = forces_fn("near")
        # seed the carried accel with the near-only part: state.accel is
        # full (near+far) at the current positions
        phi_f, gphi_f, na_f = far_eval(run_state)
        out = run_state.replace(accel=run_state.accel + gphi_f)
        for _ in range(k // m):
            out = out.replace(vel=out.vel - (0.5 * m * dt) * gphi_f)
            for _ in range(m):
                out = step_kdk(_tracked(out), cfg, near_fn)
            phi_f, gphi_f, na_f = far_eval(out)
            out = out.replace(vel=out.vel - (0.5 * m * dt) * gphi_f)
        # restore the full-field invariant (all at the final positions)
        out = out.replace(accel=out.accel - gphi_f,
                          grad_phi=out.grad_phi + gphi_f,
                          phi=out.phi + phi_f, n_approx=na_f)
    else:
        full_fn = forces_fn("all")
        for _ in range(k):
            out = step_kdk(_tracked(out), cfg, full_fn)
    out = _permute_state(out, st.groups.unsort_idx)
    if return_groups:
        return out, info, st.groups
    return out, info


def _run_cached_span(state: ParticleState, cfg: SimConfig, n_steps: int):
    """Advance n_steps: windows rebuilt every rebuild_every steps, the
    Morton sort redone only every sort_every steps. Returns (state, summed
    overflow info)."""
    k = cfg.rebuild_every
    n_outer, rem = divmod(n_steps, k)
    s_chunks = max(1, cfg.sort_every // k) if cfg.sort_every else 1
    dev = state.pos.device
    info = {"nbr_overflow": torch.zeros((), dtype=torch.int32, device=dev),
            "tree_overflow": torch.zeros((), dtype=torch.int32, device=dev)}
    add = lambda a, b: {key: a[key] + b[key] for key in a}
    n_per, rem_chunks = divmod(n_outer, s_chunks)
    for _ in range(n_per):
        state, i1, grps = run_chunk_cached(state, cfg, k, return_groups=True)
        info = add(info, i1)
        for _ in range(s_chunks - 1):
            state, i2 = run_chunk_cached(state, cfg, k, groups=grps)
            info = add(info, i2)
    for _ in range(rem_chunks):
        state, i2 = run_chunk_cached(state, cfg, k)
        info = add(info, i2)
    if rem:
        state, i2 = run_chunk_cached(state, cfg, rem)
        info = add(info, i2)
    return state, info


def run_info(state: ParticleState, cfg: SimConfig, n_steps: int):
    """Advance n_steps; returns (state, info) where info sums the structure
    overflow counters over every rebuild in the run."""
    _check_runner(cfg)
    return _run_cached_span(state, cfg, n_steps)


def run(state: ParticleState, cfg: SimConfig, n_steps: int) -> ParticleState:
    """Advance n_steps (state only; see run_info for overflow accounting)."""
    return run_info(state, cfg, n_steps)[0]
