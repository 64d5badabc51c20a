"""The planet model's stepping (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/models/planet.py`` for the paths the
port runs:

- the uncached step (``rebuild_every <= 1``): one full force evaluation per
  step, staggered Euler or leapfrog KDK, fixed or CFL dt, relax-mode or
  Newton h, the polytropic EOS or an evolved internal energy (adiabatic,
  Tillotson with per-particle materials). On dense neighbours (the
  ``jupiter_3k`` preset) every step is one all-pairs pass 1 and one pass
  2, through the CUDA kernels of ``ops/cuda/pairwise.py`` where
  `cfg.use_pallas` (the reference's switch for its fused kernels) and
  through ``ops/dense.py`` otherwise or when the internal energy is
  evolved (those kernels have no energy column, in the reference either),
  with tree gravity from a fresh block structure when asked for (the
  ``parity`` preset); on grid neighbours it is a fresh block structure and the
  sweeps of ``ops/structure.py``;
- cached chunks (``rebuild_every > 1``): on grid neighbours (the
  ``jupiter_100k`` preset and its variants) the smoothing-length update
  (Newton solve or relaxation) and the rebuild at each chunk boundary, the
  state kept in the Morton-sorted padded layout for the chunk or, with
  ``sorted_chunks=False``, in its own order, per-step h tracking, viscosity
  with the Balsara factors carried in the state, impulse-RESPA far-field
  kicks and the centre-of-mass correction; on dense neighbours the
  relaxation of h at each chunk boundary and, under tree gravity, the block
  structure rebuilt with it;
- the cached-step API: :func:`init_carry` and :func:`step_carry`, one
  cached step at a time from Python.

`axis=` (``current_dt``, ``com_correct`` and the steps) is the data-parallel
mesh of ``parallel/mesh.py`` when a rank steps its shard (``parallel/dp.py``):
the CFL minimum and the centre-of-mass sums are then reduced over the ranks.

The reference's ``lax.scan`` loops are Python loops here and its
``lax.cond`` an ``if``; the eager operations run on whatever device holds
the state's tensors, and nothing in a step reads a value back to the host.

Under a profiler the runner's layers are spans (``utils/profiling``):
``psph.frame`` (:func:`run_info`) around ``psph.step`` (each step) or
``psph.chunk`` (:func:`run_chunk_cached`: ``psph.rebuild``,
``psph.permute``, ``psph.step``, ``psph.far_kick``), ``psph.forces`` (each
force evaluation) and ``psph.com_correct``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ..config import SimConfig, check_slice
from ..ops import dense, eos as eos_ops, structure
from ..ops.cuda import pairwise
from ..parallel import mesh as mesh_mod
from ..state import ParticleState
from ..utils import debug_nans, profiling


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
    # next-step Balsara AV-limiter factor (None unless cfg.av_balsara with
    # AV on)
    balsara: Optional[torch.Tensor] = None
    # structure overflow counters of any structure built INSIDE the force
    # evaluation; None when none was (dense + direct cannot drop)
    overflow: Optional[dict] = None


def update_h(h, n_neighbors, cfg: SimConfig):
    """Adaptive smoothing-length relaxation: h <- h * 0.5 * (1 +
    (target/N)^(1/3)), unchanged when N = 0. N is the neighbour count of
    the PREVIOUS step's kernel evaluation."""
    if not cfg.adaptive_h:
        return h
    nn = n_neighbors.to(h.dtype)
    ratio = torch.pow(cfg.target_neighbors / torch.where(nn > 0, nn, 1.0),
                      1.0 / 3.0)
    h_next = h * 0.5 * (1.0 + ratio)
    h_next = torch.where(n_neighbors > 0, h_next, h)
    if cfg.h_max > 0.0:
        h_next = torch.clamp(h_next, max=cfg.h_max)
    return h_next


def current_dt(state: ParticleState, cfg: SimConfig, axis=None):
    """The timestep the next step will take, a 0-d tensor on the state's
    device. dt_mode='fixed': cfg.dt. dt_mode='cfl': C * min_i(h_i/(c_i +
    |v_i|), sqrt(h_i/|a_i|)) from the state's last-step fields, clipped to
    [cfg.dt_min, cfg.dt]; particles with mass 0 are excluded. `axis`: the
    mesh when a rank steps its shard: the minimum is then taken over every
    rank, so all integrate with the same dt."""
    dtype, dev = state.pos.dtype, state.pos.device
    if cfg.dt_mode == "fixed":
        # filled on the device: no host-to-device copy in the step
        return torch.full((), cfg.dt, dtype=dtype, device=dev)
    live = state.mass > 0.0
    cs = eos_ops.sound_speed_cfg(
        torch.clamp(state.rho, min=1e-30), cfg,
        u=state.u if cfg.evolves_u else None,
        matid=state.matid if cfg.eos_mode == "tillotson" else None)
    v = torch.sqrt((state.vel * state.vel).sum(dim=-1))
    a = torch.sqrt((state.accel * state.accel).sum(dim=-1))
    dt_c = torch.where(live, state.h / (cs + v + 1e-30), 3e30)
    dt_f = torch.where(
        live, torch.sqrt(state.h / torch.clamp(a, min=1e-30)), 3e30)
    local_min = torch.minimum(dt_c.min(), dt_f.min())
    if axis is not None:
        local_min = mesh_mod.pmin(local_min, axis)
    dt = cfg.cfl_number * local_min
    return torch.clamp(dt, cfg.dt_min, cfg.dt).to(dtype)


def _step_dt(state: ParticleState, cfg: SimConfig, axis=None):
    """dt as the integrators use it: the Python float under dt_mode='fixed'
    (no device op), else :func:`current_dt`'s 0-d tensor."""
    return cfg.dt if cfg.dt_mode == "fixed" \
        else current_dt(state, cfg, axis=axis)


def h_eta(cfg: SimConfig) -> float:
    """eta in h = eta (m/rho)^(1/3) giving target_neighbors in radius kappa*h."""
    return ((3.0 * cfg.target_neighbors / (4.0 * math.pi)) ** (1.0 / 3.0)
            / cfg.kappa)


def com_correct(grad_phi, mass, cfg: SimConfig, axis=None):
    """Opt-in exact momentum conservation for tree gravity: subtract the
    mass-weighted mean potential gradient so sum(m_i a_grav,i) = 0. The
    two sums are taken in float64, so the correction does not depend on
    the order of the particles (a sorted chunk's padded layout and the
    state's own order give the same float32 result). `axis`: the mesh when
    a rank corrects its shard: each rank's float64 partial sums are
    all-reduced in float64, so a fixed rank count gives the same bits on
    every run."""
    if not (cfg.grav_com_correction and cfg.gravity_solver == "tree"):
        return grad_phi
    with profiling.span(profiling.COM_CORRECT):
        f = (mass[:, None].double() * grad_phi.double()).sum(dim=0)
        m = mass.double().sum()
        if axis is not None:
            # both partial sums in one all-reduce
            fm = mesh_mod.psum(torch.cat([f, m[None]]), axis)
            f, m = fm[:3], fm[3]
        mean = (f / m).to(grad_phi.dtype)
        return grad_phi - mean[None, :]


balsara_factor = dense.balsara_factor


@profiling.spanned(profiling.FORCES)
def compute_forces(pos, h, mass, cfg: SimConfig, vel=None, u=None,
                   matid=None, fbal=None) -> Forces:
    """Full field evaluation at the given positions and smoothing lengths
    (the uncached path: any structure is built fresh, with zero skin).

    `vel` is needed only with artificial viscosity or an evolved internal
    energy, `u` only under an evolved-u EOS, `matid` (per-particle material
    ids) only under the Tillotson EOS with several materials, `fbal` (the
    previous step's Balsara factors) only under cfg.av_balsara. Grid
    neighbours go through the block pipeline of ``ops/structure.py``."""
    check_slice(cfg)
    energy = cfg.evolves_u
    if energy and u is None:
        raise ValueError(f"eos_mode={cfg.eos_mode!r} needs the internal "
                         "energy; pass u= to compute_forces")
    if cfg.neighbor_mode == "grid":
        st = structure.build(pos, h, mass, cfg)
        return _forces_block(pos, h, mass, cfg, st, vel=vel, u=u,
                             matid=matid, fbal=fbal)
    return _forces_dense(pos, h, mass, cfg, vel=vel, u=u, matid=matid,
                         fbal=fbal)


def _forces_dense(pos, h, mass, cfg: SimConfig, vel=None, u=None,
                  matid=None, fbal=None, st=None,
                  cached=False) -> Forces:
    """The dense pipeline's force evaluation. Tree gravity comes from `st`
    when given (a cached structure, whose overflow the caller accounts
    for), else from a fresh structure. `cached`: the cached step's form
    (no Newton h-solve under grad-h, whose tree gravity also takes the
    centre-of-mass correction), as the reference's ``_forces_cached``."""
    energy = cfg.evolves_u
    if cfg.grad_p_mode == "grad_h":
        return _compute_forces_gradh(pos, h, mass, cfg, vel=vel, u=u,
                                     matid=matid, fbal=fbal, st=st,
                                     cached=cached)

    balsara = cfg.av_balsara and cfg.av_alpha > 0.0 and vel is not None
    # cfg.use_pallas is the reference's switch for its fused all-pairs
    # kernels; here it selects their CUDA counterparts (on CPU tensors the
    # wrappers run their plain versions). They have no energy column, in
    # the reference either: an evolved u takes ops/dense.py
    sweeps = pairwise if cfg.use_pallas and not energy else dense
    # the kernels' sweep order (from a size on): one for both passes
    pk = {"plan": pairwise.plan_for(pos)} if sweeps is pairwise else {}
    p1 = sweeps.pass1(pos, h, mass, cfg, **pk)
    rho, nn, phi, grad_phi, n_direct = p1
    n_approx = torch.zeros_like(n_direct)
    ov = None
    if cfg.gravity_solver == "tree":
        phi, grad_phi, n_direct, n_approx, ov = _block_gravity(pos, h, mass,
                                                               cfg, st)
    prs = eos_ops.pressure_cfg(rho, cfg, u=u, matid=matid)
    # only the Tillotson sound speed reads matid, and that EOS evolves u
    kw = {"matid": matid} if matid is not None and energy else {}
    if balsara:
        kw["fbal"] = fbal
    if energy:
        # the energy equation rides the same sweep
        out = sweeps.pass2(pos, h, mass, rho, prs, cfg, vel=vel, energy=True,
                           u=u, **kw)
        grad_p, du_dt = out[:2]
    else:
        out = sweeps.pass2(pos, h, mass, rho, prs, cfg, vel=vel, **kw, **pk)
        grad_p = out[0] if isinstance(out, tuple) else out
        du_dt = torch.zeros_like(rho)
    f_next = None
    if balsara:
        cs = eos_ops.sound_speed_cfg(rho, cfg, u=u, matid=matid)
        f_next = balsara_factor(out[-1], cs, rho, h)
    # dv/dt = -grad P / rho - grad Phi
    grad_phi = com_correct(grad_phi, mass, cfg)
    accel = -grad_p / rho[:, None] - grad_phi
    return Forces(rho, prs, grad_p, phi, grad_phi, nn, n_direct, n_approx,
                  accel, h, du_dt, f_next, ov)


def _block_gravity(pos, h, mass, cfg: SimConfig, st=None):
    """Block-tree gravity: (phi, grad_phi, n_direct, n_approx, overflow).
    From a fresh structure unless `st` is given; overflow is the fresh
    structure's counters, None for a supplied one (its caller accounts for
    it)."""
    ov = None
    if st is None:
        st = structure.build(pos, h, mass, cfg)
        ov = structure.overflow_info(st)
    return structure.gravity(pos, h, mass, cfg, st) + (ov,)


def _viscosity(pos, vel, h, mass, rho, cfg: SimConfig):
    """Monaghan AV as a standalone sweep (flag-gated); the all-pairs and
    windowed pass 2 fuse it instead."""
    if cfg.av_alpha <= 0.0:
        return torch.zeros_like(pos)
    if vel is None:
        raise ValueError("artificial viscosity needs velocities; pass "
                         "vel= to compute_forces")
    return dense.viscosity_accel(pos, vel, h, mass, rho, cfg)


def _compute_forces_gradh(pos, h, mass, cfg: SimConfig, vel=None, u=None,
                          matid=None, fbal=None, st=None,
                          cached=False) -> Forces:
    """Grad-h SPH (Springel & Hernquist 2002) on the dense pipeline:
    gather-form density with Omega correction factors and, under
    h_mode='newton', the fixed-point solve of h = eta (m/rho)^(1/3) (not in
    a `cached` step, which keeps its h and applies the centre-of-mass
    correction, as the reference's ``_forces_cached``). Tree gravity from
    `st` when given."""
    if cfg.adaptive_h and cfg.h_mode == "newton" and not cached:
        eta = h_eta(cfg)
        for _ in range(cfg.h_newton_iters):
            rho, _, _ = dense.density_gradh(pos, h, mass, cfg)
            h = eta * torch.pow(mass / rho, 1.0 / 3.0)
            if cfg.h_max > 0.0:
                h = torch.clamp(h, max=cfg.h_max)

    energy = cfg.evolves_u
    rho, omega, nn = dense.density_gradh(pos, h, mass, cfg)
    prs = eos_ops.pressure_cfg(rho, cfg, u=u, matid=matid)
    if energy:
        grad_p, du_dt = dense.pass2_gradh(pos, h, mass, rho, omega, prs, cfg,
                                          energy=True, vel=vel)
    else:
        grad_p = dense.pass2_gradh(pos, h, mass, rho, omega, prs, cfg)
        du_dt = torch.zeros_like(rho)
    ov = None
    if cfg.gravity_solver == "direct":
        g1 = dense.pass1(pos, h, mass, cfg, sph=False)
        phi, grad_phi, n_direct = g1.phi, g1.grad_phi, g1.n_direct
        n_approx = torch.zeros_like(n_direct)
    elif cfg.gravity_solver == "tree":
        phi, grad_phi, n_direct, n_approx, ov = _block_gravity(pos, h, mass,
                                                               cfg, st)
    else:
        phi = torch.zeros_like(rho)
        grad_phi = torch.zeros_like(pos)
        n_direct = torch.zeros_like(nn)
        n_approx = torch.zeros_like(n_direct)
    if cached:
        grad_phi = com_correct(grad_phi, mass, cfg)
    accel = -grad_p / rho[:, None] - grad_phi
    f_next = None
    if cfg.av_alpha > 0.0:
        if vel is None:
            raise ValueError("artificial viscosity needs velocities; pass "
                             "vel= to compute_forces")
        bkw = {"fbal": fbal} if cfg.av_balsara else {}
        va = dense.viscosity_accel(pos, vel, h, mass, rho, cfg,
                                   energy=energy, u=u, matid=matid, **bkw)
        if not isinstance(va, tuple):
            va = (va,)
        accel = accel + va[0]
        if energy:
            du_dt = du_dt + va[1]      # the viscous heating
        if cfg.av_balsara:
            cs = eos_ops.sound_speed_cfg(rho, cfg, u=u, matid=matid)
            f_next = balsara_factor(va[-1], cs, rho, h)
    return Forces(rho, prs, grad_p, phi, grad_phi, nn, n_direct, n_approx,
                  accel, h, du_dt, f_next, ov)


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


def _uses_block_cache(cfg: SimConfig) -> bool:
    """Whether cached steps keep a block structure: grid neighbours, or
    dense SPH with tree gravity."""
    return cfg.neighbor_mode == "grid" or cfg.gravity_solver == "tree"


def _build_caches(pos, h, mass, vel, cfg: SimConfig, accel=None,
                  groups=None):
    """The cached block structure (None when the configuration keeps
    none)."""
    if not _uses_block_cache(cfg):
        return None
    if accel is None:
        accel = torch.zeros_like(vel)
    return structure.build(pos, h, mass, cfg, skin=_skin(cfg, vel, accel),
                           groups=groups, h_margin=cfg.h_track_margin)


def _forces_block(pos, h, mass, cfg: SimConfig, st, vel=None, u=None,
                  matid=None, fbal=None, solve_h=True, sorted_io=False,
                  grav_tiers="all") -> Forces:
    """Force evaluation on the block pipeline. `solve_h`: run the bounded
    Newton h-solve and a fresh build first (the uncached path); the cached
    runner passes False. `sorted_io`: state in the padded sorted layout."""
    if (solve_h and cfg.adaptive_h and cfg.h_mode == "newton"
            and cfg.grad_p_mode == "grad_h"):
        h = structure.solve_h_newton(pos, h, mass, cfg, h_eta(cfg))
        st = structure.build(pos, h, mass, cfg)
    bf = structure.forces(pos, h, mass, cfg, st, vel=vel, u=u, matid=matid,
                          fbal=fbal, sorted_io=sorted_io,
                          grav_tiers=grav_tiers)
    # padding slots duplicate real particles: weight the COM reduction by
    # the live mask so duplicates don't bias the net force
    m_eff = mass * st.groups.live.reshape(-1) if sorted_io else mass
    grad_phi = com_correct(bf.grad_phi, m_eff, cfg)
    accel = -bf.grad_p / bf.rho[:, None] - grad_phi
    return Forces(bf.rho, bf.pressure, bf.grad_p, bf.phi, grad_phi,
                  bf.n_neighbors, bf.n_direct, bf.n_approx, accel, h,
                  bf.du_dt, bf.balsara, structure.overflow_info(st))


class Carry(NamedTuple):
    """The cached-step API's carry: the state, the steps taken (a Python
    int: the rebuild decision is made on the host) and the cached block
    structure (None when the configuration keeps none)."""
    state: ParticleState
    tick: int
    st: Optional[structure.BlockStructure]


@profiling.spanned(profiling.FORCES)
def _forces_cached(pos, h, mass, cfg: SimConfig, st, vel=None, u=None,
                   matid=None, fbal=None) -> Forces:
    """One force evaluation against the cached structure, in the state's
    own order: the block pipeline on grid neighbours (no h-solve), else
    the dense pipeline with tree gravity from `st`."""
    if cfg.neighbor_mode == "grid":
        return _forces_block(pos, h, mass, cfg, st, vel=vel, u=u,
                             matid=matid, fbal=fbal, solve_h=False)
    return _forces_dense(pos, h, mass, cfg, vel=vel, u=u, matid=matid,
                         fbal=fbal, st=st, cached=True)


def init_carry(state: ParticleState, cfg: SimConfig) -> Carry:
    """Prime forces and build the initial caches (the cached-step analog
    of :func:`prime`)."""
    check_slice(cfg)
    st = _build_caches(state.pos, state.h, state.mass, state.vel, cfg,
                       accel=state.accel)
    f = _forces_cached(state.pos, state.h, state.mass, cfg, st,
                       vel=state.vel, u=state.u, matid=state.matid,
                       fbal=state.balsara)
    return Carry(_apply_forces(state, f), 0, st)


def step_carry(carry: Carry, cfg: SimConfig) -> Carry:
    """One cached step (either integrator): every `rebuild_every`-th step
    (tick 0 included) relaxes h and rebuilds the structure at the step's
    evaluation positions, the others reuse it. The incremental API for
    driving single steps from Python; :func:`run_info` runs whole chunks."""
    state, tick = carry.state, carry.tick
    rebuild = tick % max(1, cfg.rebuild_every) == 0
    dt = current_dt(state, cfg)
    if cfg.integrator == "staggered_euler":
        eval_pos, v_half = state.pos, None
    else:
        v_half = state.vel if cfg.freeze_velocity \
            else state.vel + 0.5 * dt * state.accel
        eval_pos = state.pos + dt * v_half
    # adaptive h only at rebuild steps (support must not outgrow the lists)
    h = update_h(state.h, state.n_neighbors, cfg) \
        if cfg.adaptive_h and rebuild else state.h
    st = _build_caches(eval_pos, h, state.mass, state.vel, cfg,
                       accel=state.accel) if rebuild else carry.st
    energy = cfg.evolves_u
    u_half = state.u
    if energy and cfg.integrator != "staggered_euler":
        u_half = state.u + 0.5 * dt * state.du_dt
    # KDK evaluates forces at the post-drift position with the half-step
    # velocity (as step_kdk); staggered Euler with the pre-step velocity
    f = _forces_cached(eval_pos, h, state.mass, cfg, st,
                       vel=state.vel if v_half is None else v_half,
                       u=u_half, matid=state.matid, fbal=state.balsara)
    if cfg.integrator == "staggered_euler":
        pos = state.pos + state.vel * dt
        vel = state.vel if cfg.freeze_velocity else state.vel + f.accel * dt
        u_new = state.u + dt * f.du_dt if energy else state.u
    else:
        pos = eval_pos
        vel = v_half if cfg.freeze_velocity else v_half + 0.5 * dt * f.accel
        u_new = u_half + 0.5 * dt * f.du_dt if energy else state.u
    out = _apply_forces(state, f).replace(pos=pos, vel=_damp(vel, dt, cfg),
                                          h=h, u=u_new)
    return Carry(out, tick + 1, st)


def _damp(vel, dt, cfg: SimConfig):
    """Settling-run velocity damping (cfg.vel_damping; no-op by default)."""
    if cfg.vel_damping <= 0.0 or cfg.freeze_velocity:
        return vel
    if isinstance(dt, torch.Tensor):
        return vel * torch.exp(-cfg.vel_damping * dt)
    return vel * math.exp(-cfg.vel_damping * dt)


def _apply_forces(state: ParticleState, f: Forces) -> ParticleState:
    out = state.replace(
        rho=f.rho, pressure=f.pressure, grad_p=f.grad_p, phi=f.phi,
        grad_phi=f.grad_phi, n_neighbors=f.n_neighbors,
        n_direct=f.n_direct, n_approx=f.n_approx, accel=f.accel, h=f.h,
        du_dt=f.du_dt)
    if f.balsara is not None:
        out = out.replace(balsara=f.balsara)
    return out


def _default_forces(cfg: SimConfig):
    def fn(pos, h, mass, vel=None, u=None, matid=None, fbal=None):
        return compute_forces(pos, h, mass, cfg, vel=vel, u=u, matid=matid,
                              fbal=fbal)
    return fn


def _forces_kw(cfg: SimConfig, u, matid=None, fbal=None):
    """Thread u (matid under tillotson, fbal under av_balsara) into a
    forces_fn only when the configuration consumes them, so closures that
    take (pos, h, mass, vel=) keep working."""
    kw = {"u": u} if cfg.evolves_u else {}
    if cfg.eos_mode == "tillotson" and matid is not None:
        kw["matid"] = matid
    if cfg.av_balsara and fbal is not None:
        kw["fbal"] = fbal
    return kw


def prime(state: ParticleState, cfg: SimConfig,
          forces_fn=None) -> ParticleState:
    """Evaluate forces once at the initial state (fills accel for KDK)."""
    forces_fn = forces_fn or _default_forces(cfg)
    return _apply_forces(state, forces_fn(
        state.pos, state.h, state.mass, vel=state.vel,
        **_forces_kw(cfg, state.u, state.matid, state.balsara)))


def overflow_zero(device=None):
    """The all-zero structure-overflow counter dict."""
    return {"nbr_overflow": torch.zeros((), dtype=torch.int32, device=device),
            "tree_overflow": torch.zeros((), dtype=torch.int32,
                                         device=device)}


def _step_info(f: Forces, device):
    return f.overflow if f.overflow is not None else overflow_zero(device)


def step_staggered(state: ParticleState, cfg: SimConfig, forces_fn=None,
                   update_smoothing=True, axis=None, return_info=False):
    """Reference-ordered step: forces at x_n, then x_{n+1} = x_n + v_n dt
    (the OLD velocity), then v_{n+1} = v_n + a(x_n) dt. `return_info=True`
    also returns the overflow counters of any structure built inside the
    force evaluation (zeros when none was). `axis`: the mesh under data
    parallelism (see :func:`current_dt`)."""
    forces_fn = forces_fn or _default_forces(cfg)
    dt = _step_dt(state, cfg, axis=axis)
    h = update_h(state.h, state.n_neighbors, cfg) if update_smoothing \
        else state.h
    f = forces_fn(state.pos, h, state.mass, vel=state.vel,
                  **_forces_kw(cfg, state.u, state.matid, state.balsara))
    pos = state.pos + state.vel * dt
    vel = state.vel if cfg.freeze_velocity else state.vel + f.accel * dt
    out = _apply_forces(state, f).replace(pos=pos, vel=_damp(vel, dt, cfg))
    if cfg.evolves_u:
        # forward-Euler u update matching the staggered v update
        out = out.replace(u=state.u + dt * f.du_dt)
    if return_info:
        return out, _step_info(f, pos.device)
    return out


def step_kdk(state: ParticleState, cfg: SimConfig, forces_fn=None,
             update_smoothing=True, axis=None, return_info=False):
    """Leapfrog kick-drift-kick; state.accel carries a(x_n) from the last
    step. `update_smoothing=False` keeps the state's h (the cached runner
    updates it at chunk boundaries and by tracking).

    Under an evolved-u EOS the internal energy gets the same half-kick
    treatment as the velocity (state.du_dt carries du/dt(x_n)): the force
    evaluation at x_{n+1} sees u at the half step, mirroring v_half. u is
    deliberately NOT floored at 0: the Tillotson cold-pressure term keeps
    doing expansion work as u -> 0, so a floor would inject energy at every
    clamp. u may run a small negative debt instead; the EOS functions clamp
    u >= 0 for evaluation, so the pressure stays physical while the ledger
    sum(m u) stays exact. `axis`: the mesh under data parallelism (see
    :func:`current_dt`)."""
    forces_fn = forces_fn or _default_forces(cfg)
    dt = _step_dt(state, cfg, axis=axis)
    v_half = state.vel if cfg.freeze_velocity \
        else state.vel + 0.5 * dt * state.accel
    pos = state.pos + dt * v_half
    h = update_h(state.h, state.n_neighbors, cfg) if update_smoothing \
        else state.h
    u_half = state.u + 0.5 * dt * state.du_dt if cfg.evolves_u else state.u
    f = forces_fn(pos, h, state.mass, vel=v_half,
                  **_forces_kw(cfg, u_half, state.matid, state.balsara))
    vel = v_half if cfg.freeze_velocity else v_half + 0.5 * dt * f.accel
    out = _apply_forces(state, f).replace(pos=pos, vel=_damp(vel, dt, cfg))
    if cfg.evolves_u:
        out = out.replace(u=u_half + 0.5 * dt * f.du_dt)
    if return_info:
        return out, _step_info(f, pos.device)
    return out


def step(state: ParticleState, cfg: SimConfig, forces_fn=None,
         axis=None, return_info=False):
    if cfg.integrator == "staggered_euler":
        return step_staggered(state, cfg, forces_fn, axis=axis,
                              return_info=return_info)
    return step_kdk(state, cfg, forces_fn, axis=axis,
                    return_info=return_info)


@profiling.spanned(profiling.PERMUTE)
def _permute_state(state: ParticleState, idx):
    """Reorder every state field by `idx` via one packed row gather."""
    names = [f.name for f in dataclasses.fields(state)]
    vals = structure.packed_permute([getattr(state, n) for n in names], idx)
    return ParticleState(**dict(zip(names, vals)))


def _respa(cfg: SimConfig) -> bool:
    """Whether cached chunks split the far tiers off as RESPA kicks."""
    respa = (cfg.respa_every > 1 and cfg.gravity_solver == "tree"
             and cfg.neighbor_mode == "grid"
             and cfg.integrator != "staggered_euler"
             and cfg.dt_mode == "fixed" and not cfg.freeze_velocity)
    if cfg.respa_every > 1 and not respa:
        raise ValueError(
            "respa_every > 1 needs the cached grid+tree KDK pipeline "
            "with fixed dt (got neighbor_mode=%r gravity_solver=%r "
            "integrator=%r dt_mode=%r)" % (
                cfg.neighbor_mode, cfg.gravity_solver, cfg.integrator,
                cfg.dt_mode))
    return respa


@profiling.spanned(profiling.REBUILD)
def _chunk_rebuild(state: ParticleState, cfg: SimConfig, groups=None):
    """The rebuild at a chunk boundary: the smoothing-length update (the
    bounded Newton solve, warm-started from the state's density, under
    grad-h with h_mode='newton' on grid neighbours; else the relaxation
    step from the state's neighbour counts) and the cached structure (None
    when none is kept). Returns (state with the new h, structure)."""
    check_slice(cfg)
    if cfg.adaptive_h:
        if (cfg.h_mode == "newton" and cfg.grad_p_mode == "grad_h"
                and cfg.neighbor_mode == "grid"):
            state = state.replace(h=structure.solve_h_newton(
                state.pos, state.h, state.mass, cfg, h_eta(cfg),
                groups=groups, rho0=state.rho))
        else:
            state = state.replace(h=update_h(state.h, state.n_neighbors,
                                             cfg))
    return state, _build_caches(state.pos, state.h, state.mass, state.vel,
                                cfg, accel=state.accel, groups=groups)


def chunk_setup(state: ParticleState, cfg: SimConfig, groups=None):
    """:func:`_chunk_rebuild`, then the state permuted into the
    structure's padded sorted layout (a sorted chunk's set-up). Returns
    (sorted state, structure)."""
    state, st = _chunk_rebuild(state, cfg, groups)
    return _permute_state(state, st.groups.tgt_idx), st


@profiling.spanned(profiling.CHUNK)
def run_chunk_cached(state: ParticleState, cfg: SimConfig, k: int,
                     groups=None, return_groups=False):
    """Rebuild structures once, then advance k fixed-structure steps.

    Returns (state, info) — or (state, info, groups) with
    `return_groups=True` — where info carries the rebuild's overflow
    counters and groups is the Morton grouping used (for sort_every
    reuse; None without a block structure). On grid neighbours with
    cfg.sorted_chunks the chunk runs in the padded sorted layout (one
    permutation at each end); otherwise in the state's own order, each
    evaluation permuting its inputs and outputs. With respa_every dividing
    k the far tiers are impulse-RESPA kicks around respa_every inner
    near-field steps; otherwise every step evaluates every tier."""
    sorted_chunk = cfg.neighbor_mode == "grid" and cfg.sorted_chunks
    if sorted_chunk:
        run_state, st = chunk_setup(state, cfg, groups)
        live_w = st.groups.live.reshape(-1).to(run_state.pos.dtype)
    else:
        run_state, st = _chunk_rebuild(state, cfg, groups)
        live_w = 1.0
    info = structure.overflow_info(st) if st is not None \
        else overflow_zero(run_state.pos.device)

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
        if not sorted_chunk and tiers == "all":
            return lambda p, hh, m, vel=None, u=None, matid=None, \
                fbal=None: _forces_cached(p, hh, m, cfg, st, vel=vel, u=u,
                                          matid=matid, fbal=fbal)
        return profiling.spanned(profiling.FORCES)(
            lambda p, hh, m, vel=None, u=None, matid=None, fbal=None:
            _forces_block(p, hh, m, cfg, st, vel=vel, u=u, matid=matid,
                          fbal=fbal, solve_h=False, sorted_io=sorted_chunk,
                          grav_tiers=tiers))

    one_step = step_staggered if cfg.integrator == "staggered_euler" \
        else step_kdk
    # a remainder chunk that respa_every cannot divide runs full-rate
    respa = _respa(cfg) and k % cfg.respa_every == 0
    out = run_state
    if respa:
        m = cfg.respa_every
        dt = cfg.dt
        mass_r = run_state.mass

        def far_eval(s):
            with profiling.span(profiling.FAR_KICK):
                phi_f, gphi_f, na_f = structure.gravity_far(
                    s.pos, s.h, mass_r, cfg, st, sorted_io=sorted_chunk)
                return phi_f, com_correct(gphi_f, mass_r * live_w, cfg), na_f

        near_fn = forces_fn("near")
        # seed the carried accel with the near-only part: state.accel is
        # full (near+far) at the current positions
        phi_f, gphi_f, na_f = far_eval(run_state)
        out = run_state.replace(accel=run_state.accel + gphi_f)
        for _ in range(k // m):
            out = out.replace(vel=out.vel - (0.5 * m * dt) * gphi_f)
            for _ in range(m):
                with profiling.span(profiling.STEP):
                    out = step_kdk(_tracked(out), cfg, near_fn,
                                   update_smoothing=False)
            phi_f, gphi_f, na_f = far_eval(out)
            out = out.replace(vel=out.vel - (0.5 * m * dt) * gphi_f)
        # restore the full-field invariant (all at the final positions)
        out = out.replace(accel=out.accel - gphi_f,
                          grad_phi=out.grad_phi + gphi_f,
                          phi=out.phi + phi_f, n_approx=na_f)
    else:
        full_fn = forces_fn("all")
        for _ in range(k):
            with profiling.span(profiling.STEP):
                out = one_step(_tracked(out), cfg, full_fn,
                               update_smoothing=False)
    if sorted_chunk:
        out = _permute_state(out, st.groups.unsort_idx)
    if return_groups:
        return out, info, st.groups if st is not None else None
    return out, info


def _run_cached_span(state: ParticleState, cfg: SimConfig, n_steps: int):
    """Advance n_steps: windows rebuilt every rebuild_every steps, the
    Morton sort redone only every sort_every steps. Returns (state, summed
    overflow info)."""
    k = cfg.rebuild_every
    n_outer, rem = divmod(n_steps, k)
    s_chunks = max(1, cfg.sort_every // k) \
        if cfg.sort_every and _uses_block_cache(cfg) else 1
    info = overflow_zero(state.pos.device)
    add = _add_info
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


def _add_info(a, b):
    return {key: a[key] + b[key] for key in a}


def _run_steps(state: ParticleState, cfg: SimConfig, n_steps: int):
    """n_steps uncached steps; returns (state, summed overflow info)."""
    info = overflow_zero(state.pos.device)
    for _ in range(n_steps):
        with profiling.span(profiling.STEP):
            state, i1 = step(state, cfg, return_info=True)
            info = _add_info(info, i1)
    return state, info


def _run_span(state: ParticleState, cfg: SimConfig, n_steps: int):
    if cfg.rebuild_every > 1:
        check_slice(cfg)       # before any work: what cached chunks refuse
        return _run_cached_span(state, cfg, n_steps)
    return _run_steps(state, cfg, n_steps)


@profiling.spanned(profiling.FRAME)
def run_info(state: ParticleState, cfg: SimConfig, n_steps: int):
    """Advance n_steps; returns (state, info) where info sums the structure
    overflow counters over every rebuild in the run."""
    return _run_span(state, cfg, n_steps)


def run(state: ParticleState, cfg: SimConfig, n_steps: int) -> ParticleState:
    """Advance n_steps (state only; see run_info for overflow accounting)."""
    return run_info(state, cfg, n_steps)[0]


def run_with_diagnostics(state: ParticleState, cfg: SimConfig,
                         n_chunks: int, chunk: int,
                         nan_check=debug_nans.unchecked):
    """Advance n_chunks*chunk steps, measuring diagnostics every `chunk`
    steps. Returns (state, diags): each value of diags is an [n_chunks]
    tensor on the state's device (stacked once, at the end), with the
    chunk's summed overflow counters beside the measured quantities.
    `nan_check`: what each chunk runs through, a
    ``utils.debug_nans.NaNCheck`` under ``cli run --debug-nans``."""
    from ..utils import diagnostics

    rows = []
    for _ in range(n_chunks):
        state, info = nan_check(lambda s: _run_span(s, cfg, chunk), state,
                                chunk)
        d = diagnostics.measure(state, cfg)
        d.update({k: v.to(torch.int32) for k, v in info.items()})
        rows.append(d)
    return state, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
