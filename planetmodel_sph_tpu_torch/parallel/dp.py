"""Data-parallel stepping over a mesh of ranks (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/parallel/dp.py`` (see its docstring
for the design): the particles are sharded over a 1-D mesh, and every step

1. every rank all-gathers the source fields it needs (positions, smoothing
   lengths, masses, and the coefficients pass 2 reads);
2. each rank runs the same sweeps as the single-device path with its shard
   as targets and the gathered global set as sources (`target_offset`
   places the targets in the source order);
3. integration and the smoothing-length update stay local.

The reference runs one ``shard_map`` program; here every rank is a process
that calls the same plain function on its shard (SPMD), so each ``make_*``
returns that function: ``make_run_info(cfg, mesh)(local_state, n_steps)``.
There is no ``jit``; the scans are Python loops. Start the ranks with
``parallel.mesh.spawn`` and cut each rank's shard with
``parallel.mesh.shard_state``.
"""

from __future__ import annotations

import functools

import torch

from ..config import SimConfig, check_slice
from ..models import planet
from ..ops import dense, eos as eos_ops, structure
from ..utils import debug_nans
from . import mesh as mesh_mod

Mesh = mesh_mod.Mesh


def _offset(axis: Mesh, local_n: int) -> int:
    """The shard's first index in the gathered (global) order. Index
    fields that ride a packed gather as floats stay exact below 2^24
    particles in all (the shared contract of ``structure.packed_permute``):
    100,000 at jupiter_100k."""
    return mesh_mod.axis_index(axis) * local_n


def _dp_forces(cfg: SimConfig, axis: Mesh):
    """Forces closure of one rank: local targets, global sources.

    The per-step path (a fresh structure every step): on grid neighbours
    the block pipeline with this rank's target groups over the gathered
    global source blocks; on dense neighbours the all-pairs passes of
    ``ops/dense.py`` against the gathered set (as the reference's dp path
    does: its fused all-pairs kernels take no source split), with tree
    gravity from a two-set build when asked for."""
    gather = functools.partial(mesh_mod.all_gather, axis=axis)

    def forces(pos, h, mass, vel=None, u=None, matid=None, fbal=None):
        off = _offset(axis, pos.shape[0])
        av = cfg.av_alpha > 0.0
        balsara = cfg.av_balsara and av and vel is not None
        energy = cfg.evolves_u
        pos_g, h_g, mass_g = gather(pos), gather(h), gather(mass)
        src3 = (pos_g, h_g, mass_g)

        if cfg.neighbor_mode == "grid":
            need_vel = (av or energy) and vel is not None
            src = src3 + ((gather(vel),) if need_vel else ())
            st_ = structure.build(pos, h, mass, cfg, src=src3,
                                  target_offset=off)
            bf = structure.forces(pos, h, mass, cfg, st_,
                                  vel=vel if need_vel else None, u=u,
                                  matid=matid, fbal=fbal, src=src,
                                  target_offset=off, gather_fn=gather)
            grad_phi = planet.com_correct(bf.grad_phi, mass, cfg, axis=axis)
            accel = -bf.grad_p / bf.rho[:, None] - grad_phi
            return planet.Forces(bf.rho, bf.pressure, bf.grad_p, bf.phi,
                                 grad_phi, bf.n_neighbors, bf.n_direct,
                                 bf.n_approx, accel, h, bf.du_dt,
                                 bf.balsara, structure.overflow_info(st_))

        av_extra = du_dt = f_next = None
        mkw = {} if matid is None else \
            {"matid": matid, "matid_src": gather(matid)}
        if balsara:
            fb = fbal if fbal is not None else torch.ones_like(h)
            mkw.update(fbal=fb, fbal_src=gather(fb))
        if cfg.grad_p_mode == "grad_h":
            rho, omega, nn = dense.density_gradh(pos, h, mass, cfg,
                                                 src=src3, target_offset=off)
            prs = eos_ops.pressure_cfg(rho, cfg, u=u, matid=matid)
            om_safe = torch.clamp(omega, min=0.1)
            coef = prs / (om_safe * torch.where(rho > 0, rho, 1.0) ** 2)
            p2 = dense.pass2_gradh(
                pos, h, mass, rho, omega, prs, cfg,
                src=src3 + (gather(coef),), target_offset=off,
                energy=energy, vel=vel,
                vel_src=gather(vel) if energy else None)
            grad_p, du_dt = p2 if energy else (p2, None)
            if av:
                va = dense.viscosity_accel(
                    pos, vel, h, mass, rho, cfg,
                    src=(pos_g, gather(vel), h_g, mass_g, gather(rho)),
                    target_offset=off, energy=energy, u=u,
                    u_src=gather(u) if energy else None, **mkw)
                if not isinstance(va, tuple):
                    va = (va,)
                av_extra = va[0]
                if energy:
                    du_dt = du_dt + va[1]
                if balsara:
                    cs = eos_ops.sound_speed_cfg(rho, cfg, u=u, matid=matid)
                    f_next = dense.balsara_factor(va[-1], cs, rho, h)
        else:
            p1 = dense.pass1(pos, h, mass, cfg, src=src3, target_offset=off)
            rho, nn = p1.rho, p1.n_neighbors
            prs = eos_ops.pressure_cfg(rho, cfg, u=u, matid=matid)
            src5 = src3 + (gather(rho), gather(prs))
            if (av or energy) and vel is not None:
                src5 = src5 + (gather(vel),)
            p2 = dense.pass2(pos, h, mass, rho, prs, cfg, src=src5,
                             target_offset=off, vel=vel, energy=energy,
                             u=u, u_src=gather(u) if energy else None,
                             **mkw)
            if not isinstance(p2, tuple):
                p2 = (p2,)
            grad_p = p2[0]
            du_dt = p2[1] if energy else None
            if balsara:
                cs = eos_ops.sound_speed_cfg(rho, cfg, u=u, matid=matid)
                f_next = dense.balsara_factor(p2[-1], cs, rho, h)

        ov = None
        if cfg.gravity_solver == "tree":
            st_g = structure.build(pos, h, mass, cfg, src=src3,
                                   target_offset=off)
            ov = structure.overflow_info(st_g)
            phi, grad_phi, n_direct, n_approx = structure.gravity(
                pos, h, mass, cfg, st_g, src=src3, target_offset=off)
        elif cfg.gravity_solver == "direct" and cfg.grad_p_mode != "grad_h":
            phi, grad_phi, n_direct = p1.phi, p1.grad_phi, p1.n_direct
            n_approx = torch.zeros_like(n_direct)
        elif cfg.gravity_solver == "direct":
            g1 = dense.pass1(pos, h, mass, cfg, src=src3, target_offset=off,
                             sph=False)
            phi, grad_phi, n_direct = g1.phi, g1.grad_phi, g1.n_direct
            n_approx = torch.zeros_like(n_direct)
        else:
            phi = torch.zeros_like(rho)
            grad_phi = torch.zeros_like(pos)
            n_direct = torch.zeros_like(nn)
            n_approx = torch.zeros_like(nn)

        grad_phi = planet.com_correct(grad_phi, mass, cfg, axis=axis)
        accel = -grad_p / rho[:, None] - grad_phi
        if av_extra is not None:
            accel = accel + av_extra
        if du_dt is None:
            du_dt = torch.zeros_like(rho)
        return planet.Forces(rho, prs, grad_p, phi, grad_phi, nn,
                             n_direct, n_approx, accel, h, du_dt, f_next,
                             ov)

    return forces


def _cached(cfg: SimConfig) -> bool:
    return cfg.rebuild_every > 1 and cfg.neighbor_mode == "grid"


def make_step(cfg: SimConfig, mesh: Mesh):
    """One rank's step: local state -> local state (a fresh structure
    every step)."""
    check_slice(cfg)

    def local_step(state):
        return planet.step(state, cfg, forces_fn=_dp_forces(cfg, mesh),
                           axis=mesh)
    return local_step


def make_prime(cfg: SimConfig, mesh: Mesh):
    """One rank's prime: the forces of its shard at the initial state."""
    check_slice(cfg)

    def local_prime(state):
        return planet.prime(state, cfg, forces_fn=_dp_forces(cfg, mesh))
    return local_prime


def make_run(cfg: SimConfig, mesh: Mesh):
    """One rank's n-step run: (local state, n_steps) -> local state."""
    check_slice(cfg)

    def run(state, n_steps):
        return local_run_steps(state, cfg=cfg, axis=mesh, n_steps=n_steps)
    return run


def make_run_info(cfg: SimConfig, mesh: Mesh):
    """One rank's n-step run returning (local state, overflow info), the
    info summed over the ranks: the dp mirror of ``planet.run_info``."""
    check_slice(cfg)

    def run(state, n_steps):
        return local_run_steps_info(state, cfg=cfg, axis=mesh,
                                    n_steps=n_steps)
    return run


def make_run_diag(cfg: SimConfig, mesh: Mesh,
                  nan_check=debug_nans.unchecked):
    """(local state, n_chunks, chunk) -> (local state, diagnostics): the
    run in chunks with the GLOBAL state's diagnostics after each (every
    field gathered, then ``utils.diagnostics.measure``, so a row equals the
    measure of the gathered state), beside the chunk's summed overflow
    counters; each value an [n_chunks] tensor on the rank's device, the
    same on every rank. `nan_check`: what each chunk runs through, a
    ``utils.debug_nans.NaNCheck`` over this mesh under ``--debug-nans``."""
    from ..utils import diagnostics
    check_slice(cfg)

    def run(state, n_chunks, chunk):
        rows = []
        for _ in range(n_chunks):
            state, info = nan_check(
                lambda s: local_run_steps_info(s, cfg=cfg, axis=mesh,
                                               n_steps=chunk), state, chunk)
            d = diagnostics.measure(mesh_mod.gather_state(state, mesh), cfg)
            d.update({k: v.to(torch.int32) for k, v in info.items()})
            rows.append(d)
        return state, {k: torch.stack([r[k] for r in rows])
                       for k in rows[0]}
    return run


def local_run_steps(state, *, cfg, axis, n_steps):
    if _cached(cfg):
        return _local_run_cached(state, cfg=cfg, axis=axis,
                                 n_steps=n_steps)[0]
    for _ in range(n_steps):
        state = planet.step(state, cfg, forces_fn=_dp_forces(cfg, axis),
                            axis=axis)
    return state


def surfaces_overflow(cfg: SimConfig) -> bool:
    """Whether the dp runner reports real overflow counters: True on every
    path (the cached grid path accounts per rebuild, the per-step paths
    thread the counters out of the forces closure; dense + direct builds
    no bounded structure, so its zeros are exhaustive)."""
    return True


def local_run_steps_info(state, *, cfg, axis, n_steps):
    """(state, overflow info); the info is summed over the ranks, so the
    'dropped AND counted' contract holds on every dp path."""
    if _cached(cfg):
        out, info = _local_run_cached(state, cfg=cfg, axis=axis,
                                      n_steps=n_steps)
    else:
        out, info = state, planet.overflow_zero(state.pos.device)
        for _ in range(n_steps):
            out, i = planet.step(out, cfg, forces_fn=_dp_forces(cfg, axis),
                                 axis=axis, return_info=True)
            info = planet._add_info(info, i)
    return out, {k: mesh_mod.psum(v, axis) for k, v in info.items()}


def _unsort_geom(grp, pos, h, vel=None):
    """Sorted-layout local (pos, h[, vel]) back to the shard's own order
    (one packed gather): the source fields are all-gathered in that order,
    so the frozen source grouping's global indexing stays valid."""
    arrs = [pos, h] + ([vel] if vel is not None else [])
    out = structure.packed_permute(arrs, grp.unsort_idx, pad_to=32)
    return out[0], out[1], (out[2] if vel is not None else None)


def _collect_many(collect, *xs):
    """``[collect(x) for x in xs]`` in one call: the [n] and [n, k] fields
    (one dtype) as columns of one tensor, split back (one message a peer
    instead of one a field; the same values)."""
    cols = [x.reshape(x.shape[0], -1) for x in xs]
    both = collect(torch.cat(cols, dim=1))
    out, c = [], 0
    for x, col in zip(xs, cols):
        w = col.shape[1]
        out.append(both[:, c:c + w].reshape((-1,) + x.shape[1:])
                   .contiguous())
        c += w
    return out


def run_chunk_cached(s, cfg: SimConfig, axis: Mesh, kk: int, groups=None,
                     return_groups=False, collect=None, far_hook=None,
                     target_offset=None):
    """One Verlet-cached chunk of one rank with the full production stack,
    the dp mirror of ``planet.run_chunk_cached``:

    - the chunk-boundary Newton h-solve (grad-h) over the gathered sources,
      warm-started from the state's density, or the relaxation step;
    - ONE skinned two-set build (`skin_src`: the gathered source skins;
      `groups`: the frozen (target, source) groupings of `sort_every`);
    - sorted chunks (cfg.sorted_chunks): the local shard stays in its padded
      target-sorted layout for the chunk, the sources are gathered every
      step in shard order (unsorted first) to match the source grouping;
    - per-step h tracking (h_track_margin);
    - impulse-RESPA (respa_every): ring + far tiers from the gathered
      current positions once per period as half-period kicks around
      near-field-only KDK steps.

    `collect` / `far_hook` / `target_offset` adapt the runner to a halo
    layout: `collect` replaces the all-gather, `target_offset` places the
    targets in the collected set, and ``far_hook(pos_t, h_t, pos_o, h_o) ->
    (phi, grad_phi, n_far)`` adds a far field to every full force
    evaluation (to the outer far force only under RESPA)."""
    local_n = s.pos.shape[0]
    if collect is None:
        collect = functools.partial(mesh_mod.all_gather, axis=axis)
    off = _offset(axis, local_n) if target_offset is None else target_offset
    av = cfg.av_alpha > 0.0
    need_vel = av or cfg.evolves_u

    # ---- chunk boundary: h update ----
    if cfg.adaptive_h:
        if cfg.h_mode == "newton" and cfg.grad_p_mode == "grad_h":
            src3 = tuple(_collect_many(collect, s.pos, s.h, s.mass))
            h = structure.solve_h_newton(s.pos, s.h, s.mass, cfg,
                                         planet.h_eta(cfg), src=src3,
                                         target_offset=off, rho0=s.rho,
                                         groups=groups)
        else:
            h = planet.update_h(s.h, s.n_neighbors, cfg)
        s = s.replace(h=h)

    # ---- one skinned build per chunk ----
    skin = planet._skin(cfg, s.vel, s.accel)
    pos_c, h_c, mass_c, skin_c = _collect_many(collect, s.pos, s.h, s.mass,
                                               skin)   # mass: static
    src3 = (pos_c, h_c, mass_c)
    st = structure.build(s.pos, s.h, s.mass, cfg, skin=skin, src=src3,
                         target_offset=off, skin_src=skin_c,
                         h_margin=cfg.h_track_margin, groups=groups)
    info = structure.overflow_info(st)

    sorted_chunk = cfg.sorted_chunks and cfg.neighbor_mode == "grid"
    grp = st.groups
    if sorted_chunk:
        run_state = planet._permute_state(s, grp.tgt_idx)
        live_w = grp.live.reshape(-1).to(s.pos.dtype)
    else:
        run_state, live_w = s, 1.0

    def current_orig(pos, hh, vel):
        """Current (pos, h[, vel]) in the shard's own order."""
        if sorted_chunk:
            return _unsort_geom(grp, pos, hh, vel if need_vel else None)
        return pos, hh, vel if need_vel else None

    def current_src(pos_o, h_o, vel_o):
        """Collected (pos, h, mass[, vel]) of the CURRENT step (one
        collect)."""
        if need_vel and vel_o is not None:
            pos_g, h_g, vel_g = _collect_many(collect, pos_o, h_o, vel_o)
            return (pos_g, h_g, mass_c, vel_g)
        pos_g, h_g = _collect_many(collect, pos_o, h_o)
        return (pos_g, h_g, mass_c)

    def make_forces(tiers):
        def forces_fn(pos, hh, mm, vel=None, u=None, matid=None,
                      fbal=None):
            pos_o, h_o, vel_o = current_orig(pos, hh, vel)
            bf = structure.forces(pos, hh, mm, cfg, st,
                                  vel=vel if need_vel else None, u=u,
                                  matid=matid, fbal=fbal,
                                  src=current_src(pos_o, h_o, vel_o),
                                  target_offset=off, gather_fn=collect,
                                  sorted_io=sorted_chunk, grav_tiers=tiers)
            phi, grad_phi, n_approx = bf.phi, bf.grad_phi, bf.n_approx
            if far_hook is not None and tiers == "all":
                phi_f, gphi_f, n_far = far_hook(pos, hh, pos_o, h_o)
                phi = phi + phi_f
                grad_phi = grad_phi + gphi_f
                n_approx = n_approx + n_far
            # padding slots duplicate real particles: weight by live
            grad_phi = planet.com_correct(grad_phi, mm * live_w, cfg,
                                          axis=axis)
            accel = -bf.grad_p / bf.rho[:, None] - grad_phi
            return planet.Forces(bf.rho, bf.pressure, bf.grad_p, phi,
                                 grad_phi, bf.n_neighbors, bf.n_direct,
                                 n_approx, accel, hh, bf.du_dt, bf.balsara,
                                 None)
        return forces_fn

    # ---- per-step h tracking (see SimConfig.h_track_margin) ----
    if planet._h_tracking(cfg):
        eta = planet.h_eta(cfg)
        h_rb = run_state.h
        t_lo = h_rb / (1.0 + cfg.h_track_margin)
        t_hi = h_rb * (1.0 + cfg.h_track_margin)
        if cfg.h_max > 0.0:
            t_hi = torch.clamp(t_hi, max=cfg.h_max)

        def tracked(s2):
            h_t = eta * torch.pow(s2.mass / torch.clamp(s2.rho, min=1e-30),
                                  1.0 / 3.0)
            return s2.replace(h=torch.minimum(torch.maximum(h_t, t_lo),
                                              t_hi))
    else:
        tracked = lambda s2: s2

    one_step = planet.step_staggered if cfg.integrator == "staggered_euler" \
        else planet.step_kdk
    # raises on respa_every > 1 outside the cached grid + tree KDK
    # pipeline; a remainder chunk that respa_every cannot divide runs
    # full-rate
    respa = planet._respa(cfg) and kk % cfg.respa_every == 0
    out = run_state
    if respa:
        m = cfg.respa_every
        dt = cfg.dt
        mass_r = run_state.mass

        def far_eval(s2):
            pos_o, h_o, _ = current_orig(s2.pos, s2.h, None)
            phi_f, gphi_f, na_f = structure.gravity_far(
                s2.pos, s2.h, mass_r, cfg, st, sorted_io=sorted_chunk,
                src=current_src(pos_o, h_o, None)[:3], target_offset=off)
            if far_hook is not None:
                p2, g2, n2 = far_hook(s2.pos, s2.h, pos_o, h_o)
                phi_f = phi_f + p2
                gphi_f = gphi_f + g2
                na_f = na_f + n2
            gphi_f = planet.com_correct(gphi_f, mass_r * live_w, cfg,
                                        axis=axis)
            return phi_f, gphi_f, na_f

        near_fn = make_forces("near")
        # seed the carried accel with the near-only part: state.accel is
        # full (near + far) at the current positions
        phi_f, gphi_f, na_f = far_eval(run_state)
        out = run_state.replace(accel=run_state.accel + gphi_f)
        for _ in range(kk // m):
            out = out.replace(vel=out.vel - (0.5 * m * dt) * gphi_f)
            for _ in range(m):
                out = planet.step_kdk(tracked(out), cfg, near_fn,
                                      update_smoothing=False, axis=axis)
            phi_f, gphi_f, na_f = far_eval(out)
            out = out.replace(vel=out.vel - (0.5 * m * dt) * gphi_f)
        # restore the full-field invariant (all at the final positions)
        out = out.replace(accel=out.accel - gphi_f,
                          grad_phi=out.grad_phi + gphi_f,
                          phi=out.phi + phi_f, n_approx=na_f)
    else:
        full_fn = make_forces("all")
        for _ in range(kk):
            out = one_step(tracked(out), cfg, full_fn,
                           update_smoothing=False, axis=axis)
    if sorted_chunk:
        out = planet._permute_state(out, grp.unsort_idx)
    if return_groups:
        return out, info, (st.groups, st.src_groups)
    return out, info


def _local_run_cached(state, *, cfg, axis, n_steps, chunk_fn=None,
                      zero=None):
    """A Verlet-cached span of one rank: windows rebuilt every
    rebuild_every steps, the (target, source) Morton groupings redone only
    every sort_every steps (the dp mirror of ``planet._run_cached_span``).
    Returns (state, summed info, not yet summed over the ranks).

    `chunk_fn` / `zero` let a halo runner reuse the same span with its own
    chunk function and info keys."""
    run_chunk = chunk_fn or run_chunk_cached
    info = zero if zero is not None else \
        planet.overflow_zero(state.pos.device)
    add = lambda a, b: {k: a[k] + b[k] for k in a}
    k = max(1, cfg.rebuild_every)
    n_outer, rem = divmod(n_steps, k)
    s_chunks = max(1, cfg.sort_every // k) if cfg.sort_every else 1
    n_per, rem_chunks = divmod(n_outer, s_chunks)
    out = state
    for _ in range(n_per):
        out, i, grps = run_chunk(out, cfg, axis, k, return_groups=True)
        info = add(info, i)
        for _ in range(s_chunks - 1):
            out, i = run_chunk(out, cfg, axis, k, groups=grps)
            info = add(info, i)
    for _ in range(rem_chunks):
        out, i = run_chunk(out, cfg, axis, k)
        info = add(info, i)
    if rem:
        out, i = run_chunk(out, cfg, axis, rem)
        info = add(info, i)
    return out, info
