"""Halo-exchange data parallelism: sharded sources, ring-local raw halo
(PyTorch port of ``planetmodel_sph_tpu/parallel/halo.py``; see its
docstring for the design).

The replicated layout (``parallel/dp.py``) all-gathers every source into
every rank: O(N) bytes a rank a step. Here

1. **Morton-range sharding**: :func:`morton_shard_state` sorts the global
   state along the Morton curve of its cubic box and gives each rank one
   contiguous range, a spatially coherent brick;
2. **raw halo = ring neighbours only**: every step a rank collects the raw
   fields of its ±R ring neighbours (R = cfg.halo_ring_radius) with
   :func:`parallel.mesh.ppermute` and hands ``[local | ring]`` to the same
   block pipeline the single-device path runs (``structure.build`` /
   ``structure.forces`` with ``src=`` and ``target_offset=0``);
3. **far field = chunked monopoles**: each rank reduces its particles to
   ``halo_chunk``-particle moments, all-gathers those, and evaluates the
   non-ring ranks' chunks as monopoles on its targets;
4. **never silently wrong**: a non-ring chunk inside the conservative
   acceptance bound is still evaluated as a monopole but counted in
   ``halo_violations``; :func:`run_resharded` re-shards on it.

As in ``parallel/dp.py`` every rank is a process that calls the same plain
function on its shard (SPMD): each ``make_*`` returns that function, and
there is no ``jit``.

**Standing difference from the reference: 2R >= D is refused.** The ring
collects the shifts +1, -1, ..., +R, -R modulo D. With 2R >= D two shifts
fetch the same shard (D = 2, R = 1: +1 and -1), or a shift fetches the
rank itself (D = 1), so the sources hold duplicates and densities come out
too high with nothing counted. The reference's ``check_config`` checks only
R >= 1; :func:`check_config` here also takes the rank count and refuses
2R >= D by name, and every ``make_*`` and :func:`run_resharded` calls it.
"""

from __future__ import annotations

import functools

import torch

from ..config import SimConfig, check_slice
from ..models import planet
from ..ops import morton, structure
from ..utils import debug_nans
from . import mesh as mesh_mod

Mesh = mesh_mod.Mesh


def check_config(cfg: SimConfig, n_ranks: int):
    """Refuse what the halo layout cannot serve, each by name: dense
    neighbours, direct gravity, R < 1, and a ring that reaches some shard
    twice (2R >= D, see the module docstring)."""
    if cfg.neighbor_mode != "grid":
        raise ValueError("dp_mode='halo' needs neighbor_mode='grid' (the "
                         "block pipeline; dense mode wants all sources)")
    if cfg.gravity_solver == "direct":
        raise ValueError("dp_mode='halo' cannot serve direct O(N^2) "
                         "gravity (it needs every raw source); use "
                         "gravity_solver='tree' or 'none'")
    r = cfg.halo_ring_radius
    if r < 1:
        raise ValueError("halo_ring_radius must be >= 1")
    if 2 * r >= n_ranks:
        raise ValueError(
            f"halo_ring_radius={r} over {n_ranks} rank(s): 2R >= D, so the "
            f"ring's shifts +-1..+-{r} modulo {n_ranks} collect some shard "
            "more than once (duplicated sources, densities too high, "
            "nothing counted); use 2 * halo_ring_radius < D, or "
            "dp_mode='replicated'")


def morton_shard_state(state, axis: Mesh):
    """This rank's rows of the global state sorted along the Morton curve.

    `state` is this rank's shard: the shards are gathered (rank order),
    sorted along the Morton curve of the CUBIC box about them
    (``hi = lo + max(hi - lo)``: a box stretched per axis would destroy the
    coherence of equal-count Morton ranges) with a stable sort, and cut
    again. Re-invoke when ``halo_violations`` climbs (particles migrated
    bricks)."""
    full = mesh_mod.gather_state(state, axis)
    lo = full.pos.amin(0)
    hi = lo + (full.pos.amax(0) - lo).max()
    order = torch.sort(morton.encode(full.pos, lo, hi), stable=True).indices
    return mesh_mod.shard_state(planet._permute_state(full, order), axis)


def _ring_shifts(r: int):
    """Deterministic collect order: +1, -1, +2, -2, ... (matches the
    source layout [local | shifts...] everywhere)."""
    out = []
    for k in range(1, r + 1):
        out += [k, -k]
    return out


def _ring_collect(x, axis: Mesh, r: int):
    """[n_loc, ...] -> [(2r+1) n_loc, ...]: the local shard first, then the
    ±1..±r ring neighbours' copies, a ``ppermute`` a shift (the 2r of
    them as one exchange, ``mesh.ppermutes``)."""
    d = mesh_mod.axis_size(axis)
    # perm maps source -> destination: shard i's data lands on shard i - s,
    # i.e. every shard RECEIVES shard (i + s)'s data
    perms = [[(i, (i - s) % d) for i in range(d)] for s in _ring_shifts(r)]
    return torch.cat([x] + mesh_mod.ppermutes(x, axis, perms), dim=0)


def _chunk_moments(pos, mass, h, chunk: int):
    """Monopole and geometry summaries of consecutive `chunk`-particle
    slices (Morton-contiguous, so spatially tight): a dict of [C]-leading
    tensors m, cm[3], amin[3], amax[3], bmax, hmax."""
    n = pos.shape[0]
    if n % chunk:
        raise ValueError(f"shard size {n} not divisible by "
                         f"halo_chunk={chunk}")
    c = n // chunk
    p = pos.reshape(c, chunk, 3)
    m = mass.reshape(c, chunk)
    mt = m.sum(dim=1)
    cm = (p * m[..., None]).sum(dim=1) / torch.clamp(mt, min=1e-30)[:, None]
    d = p - cm[:, None, :]
    bmax = torch.sqrt((d * d).sum(dim=-1).amax(dim=1))
    return dict(m=mt, cm=cm, amin=p.amin(dim=1), amax=p.amax(dim=1),
                bmax=bmax, hmax=h.reshape(c, chunk).amax(dim=1))


def _gathered_moments(pos, mass, h, cfg: SimConfig, axis: Mesh):
    """Every rank's chunk moments, rank order: the 12 floats of a chunk
    all-gathered as one [C, 12] tensor (one collective, not six)."""
    mom = _chunk_moments(pos, mass, h, cfg.halo_chunk)
    width = {k: v.reshape(v.shape[0], -1).shape[1] for k, v in mom.items()}
    packed = mesh_mod.all_gather(torch.cat(
        [v.reshape(v.shape[0], -1) for v in mom.values()], dim=1), axis)
    out, c = {}, 0
    for k, w in width.items():
        col = packed[:, c:c + w]
        out[k] = (col if mom[k].ndim == 2 else col[:, 0]).contiguous()
        c += w
    return out


# targets a slice of the [n, D*C] monopole sum (bounds its intermediates)
FAR_SLICE = 4096


def _far_field(pos, h, mom, axis: Mesh, cfg: SimConfig, margin=0.0,
               h_infl: float = 1.0):
    """Monopole contribution of the non-ring ranks' chunks on the local
    targets: (phi, grad_phi, n_far, violations).

    `mom`: the all-gathered chunk moments, leading axis D*C. The rank's own
    and its ring's chunks are masked out (their raw particles feed the
    block pipeline). `margin` / `h_infl` widen the violation bound only:
    the cached runner checks the pre-chunk state with the chunk's motion
    bound and the worst-case h growth, so a flag fires before a chunk
    could run with a mis-approximated near neighbour. The [n, D*C] sum is
    plain PyTorch (the reference's is ``jnp``, outside any kernel), over
    the D*C axis, in slices of FAR_SLICE targets."""
    d = mesh_mod.axis_size(axis)
    me = mesh_mod.axis_index(axis)
    dev = pos.device
    c = mom["m"].shape[0] // d
    shard_of = torch.arange(d * c, device=dev) // c
    ring = torch.zeros(d, dtype=torch.bool, device=dev)
    ring[me] = True
    for s in _ring_shifts(cfg.halo_ring_radius):
        ring[(me + s) % d] = True
    far = ~ring[shard_of] & (mom["m"] > 0.0)                     # [D*C]

    # conservative proximity bound against the rank's target box: inside
    # it a monopole can exceed the theta-MAC error (gravity) or even be an
    # SPH neighbour; count it (never silent)
    tlo, thi = pos.amin(0), pos.amax(0)
    t_hmax = h.amax()
    gap = torch.clamp(torch.maximum(tlo[None, :] - mom["amax"],
                                    mom["amin"] - thi[None, :]), min=0.0)
    gap2 = (gap * gap).sum(dim=-1)
    theta = max(cfg.theta, 1e-3)
    cut = torch.maximum(cfg.kappa * h_infl * torch.maximum(t_hmax,
                                                           mom["hmax"]),
                        mom["bmax"] / theta) + margin
    violations = ((gap2 < cut * cut) & far).sum().to(torch.int32)

    # monopole M2P (unsoftened far field)
    gm = cfg.g_const * mom["m"]
    phi = torch.empty(pos.shape[0], dtype=pos.dtype, device=dev)
    grad_phi = torch.empty_like(pos)
    for i0 in range(0, pos.shape[0], FAR_SLICE):
        p = pos[i0:i0 + FAR_SLICE]
        dx = mom["cm"][None, :, :] - p[:, None, :]               # [s,DC,3]
        r2 = (dx * dx).sum(dim=-1)
        inv_r = torch.where(far[None, :],
                            1.0 / torch.sqrt(torch.clamp(r2, min=1e-30)),
                            0.0)
        phi[i0:i0 + FAR_SLICE] = -(gm[None, :] * inv_r).sum(dim=1)
        grad_phi[i0:i0 + FAR_SLICE] = -((gm[None, :] * inv_r ** 3)[..., None]
                                        * dx).sum(dim=1)
    n_far = far.sum().to(torch.int32)
    return phi, grad_phi, n_far, violations


def _halo_forces(cfg: SimConfig, axis: Mesh):
    """Forces closure of one rank: local targets, [local | ring] raw
    sources, the all-gathered chunk moments for the rest."""
    check_config(cfg, mesh_mod.axis_size(axis))
    r = cfg.halo_ring_radius
    collect = functools.partial(_ring_collect, axis=axis, r=r)

    def forces(pos, h, mass, vel=None, u=None, matid=None, fbal=None):
        av = cfg.av_alpha > 0.0
        need_vel = (av or cfg.evolves_u) and vel is not None
        src3 = (collect(pos), collect(h), collect(mass))
        src = src3 + ((collect(vel),) if need_vel else ())
        st = structure.build(pos, h, mass, cfg, src=src3, target_offset=0)
        bf = structure.forces(pos, h, mass, cfg, st,
                              vel=vel if need_vel else None, u=u,
                              matid=matid, fbal=fbal, src=src,
                              target_offset=0, gather_fn=collect)
        ov = structure.overflow_info(st)
        if cfg.gravity_solver == "tree":
            mom = _gathered_moments(pos, mass, h, cfg, axis)
            phi_f, gphi_f, n_far, viol = _far_field(pos, h, mom, axis, cfg)
            phi = bf.phi + phi_f
            grad_phi = bf.grad_phi + gphi_f
            n_approx = bf.n_approx + n_far
        else:
            phi, grad_phi, n_approx = bf.phi, bf.grad_phi, bf.n_approx
            viol = torch.zeros((), dtype=torch.int32, device=pos.device)
        ov["halo_violations"] = viol
        grad_phi = planet.com_correct(grad_phi, mass, cfg, axis=axis)
        accel = -bf.grad_p / bf.rho[:, None] - grad_phi
        return planet.Forces(bf.rho, bf.pressure, bf.grad_p, phi, grad_phi,
                             bf.n_neighbors, bf.n_direct, n_approx, accel, h,
                             bf.du_dt, bf.balsara, ov)

    return forces


def zero_info(device=None):
    """The all-zero info dict of the halo runners."""
    z = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return {"nbr_overflow": z(), "tree_overflow": z(),
            "halo_violations": z()}


def _check(cfg: SimConfig, mesh: Mesh):
    check_slice(cfg)
    check_config(cfg, mesh_mod.axis_size(mesh))


def make_step(cfg: SimConfig, mesh: Mesh):
    """One rank's halo step (its state a Morton-range shard): local state
    -> local state."""
    _check(cfg, mesh)

    def local_step(state):
        return planet.step(state, cfg, forces_fn=_halo_forces(cfg, mesh),
                           axis=mesh)
    return local_step


def make_prime(cfg: SimConfig, mesh: Mesh):
    """One rank's prime: the forces of its shard at the initial state."""
    _check(cfg, mesh)

    def local_prime(state):
        return planet.prime(state, cfg, forces_fn=_halo_forces(cfg, mesh))
    return local_prime


def run_chunk_cached(s, cfg: SimConfig, axis: Mesh, kk: int, groups=None,
                     return_groups=False):
    """One Verlet-cached halo chunk: ``dp.run_chunk_cached`` (the same
    production stack) with the ring collection for sources
    (``target_offset=0``: the targets lead the collected set) and the
    non-ring universe as chunk monopoles through `far_hook` (under RESPA
    at the outer cadence with the other far tiers).
    ``halo_violations`` is counted once a chunk on the pre-chunk state
    with the bound widened by the chunk's motion budget (2x the global max
    Verlet skin) and the worst-case h growth, so the flag fires before a
    chunk could run with a mis-approximated near neighbour."""
    check_config(cfg, mesh_mod.axis_size(axis))
    from . import dp
    collect = functools.partial(_ring_collect, axis=axis,
                                r=cfg.halo_ring_radius)
    far_hook = None
    viol = torch.zeros((), dtype=torch.int32, device=s.pos.device)
    if cfg.gravity_solver == "tree":
        mass_o = s.mass

        def far_hook(pos_t, h_t, pos_o, h_o):
            mom = _gathered_moments(pos_o, mass_o, h_o, cfg, axis)
            phi_f, gphi_f, n_far, _ = _far_field(pos_t, h_t, mom, axis, cfg)
            return phi_f, gphi_f, n_far

        # pre-chunk conservative violation check (the state BEFORE the
        # chunk's h update and build: the margins cover both)
        skin = planet._skin(cfg, s.vel, s.accel)
        margin = 2.0 * mesh_mod.pmax(skin.amax(), axis)
        h_infl = (1.0 + cfg.h_newton_clamp) * (1.0 + cfg.h_track_margin) \
            if (cfg.adaptive_h and cfg.h_mode == "newton") else \
            (1.0 + cfg.h_track_margin)
        mom0 = _gathered_moments(s.pos, s.mass, s.h, cfg, axis)
        _, _, _, viol = _far_field(s.pos, s.h, mom0, axis, cfg,
                                   margin=margin, h_infl=h_infl)

    out = dp.run_chunk_cached(s, cfg, axis, kk, groups=groups,
                              return_groups=return_groups, collect=collect,
                              far_hook=far_hook, target_offset=0)
    out[1]["halo_violations"] = viol
    return out


def _local_run_cached(state, *, cfg, axis, n_steps):
    """A Verlet-cached halo span (sort_every grouping reuse included): the
    shared dp span with the halo chunk."""
    from . import dp
    return dp._local_run_cached(state, cfg=cfg, axis=axis, n_steps=n_steps,
                                chunk_fn=run_chunk_cached,
                                zero=zero_info(state.pos.device))


def local_run_steps_info(state, *, cfg, axis, n_steps):
    """(state, info): halo stepping; the info (overflow counters and
    halo_violations) summed over steps or chunks and over the ranks.
    rebuild_every > 1 takes the Verlet-cached production spans."""
    if cfg.rebuild_every > 1 and cfg.neighbor_mode == "grid":
        out, info = _local_run_cached(state, cfg=cfg, axis=axis,
                                      n_steps=n_steps)
    else:
        out, info = state, zero_info(state.pos.device)
        forces_fn = _halo_forces(cfg, axis)
        for _ in range(n_steps):
            out, i = planet.step(out, cfg, forces_fn=forces_fn, axis=axis,
                                 return_info=True)
            info = {k: info[k] + i[k] for k in info}
    return out, {k: mesh_mod.psum(v, axis) for k, v in info.items()}


def make_run(cfg: SimConfig, mesh: Mesh):
    """One rank's n-step run: (local state, n_steps) -> (local state,
    info summed over the ranks)."""
    _check(cfg, mesh)

    def run(state, n_steps):
        return local_run_steps_info(state, cfg=cfg, axis=mesh,
                                    n_steps=n_steps)
    return run


def make_run_diag(cfg: SimConfig, mesh: Mesh,
                  nan_check=debug_nans.unchecked):
    """(local state, n_chunks, chunk) -> (local state, diagnostics): the
    halo mirror of ``dp.make_run_diag``, with ``halo_violations`` in every
    row (the loud re-shard signal); each value an [n_chunks] tensor, the
    same on every rank. `nan_check`: what each chunk runs through, a
    ``utils.debug_nans.NaNCheck`` over this mesh under ``--debug-nans``."""
    from ..utils import diagnostics
    _check(cfg, mesh)

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


def run_resharded(state, cfg: SimConfig, mesh: Mesh, n_steps: int,
                  span: int = 0, log=None, on_segment=None):
    """The halo layout's survivability loop: advance `n_steps` in
    `span`-step segments; a segment that reports ``halo_violations`` is
    discarded and run again from the pre-segment state after a re-shard
    (:func:`morton_shard_state`). If violations persist right after a
    re-shard (the geometry exceeds the ring), the segment is accepted and
    counted, and later segments re-shard only above twice the largest
    accepted count (the reference's ratchet, kept as it is).

    Every rank runs the loop in lockstep: each decision is taken from the
    info summed over the ranks, so no rank leaves the loop alone.
    ``on_segment(state, done, info)`` fires on every rank after every
    accepted segment. Returns (local state, summed info, n_reshards)."""
    _check(cfg, mesh)
    span = span or max(cfg.rebuild_every, 1) * 4
    runner = make_run(cfg, mesh)
    total = {k: 0 for k in zero_info()}
    done = 0
    reshards = 0
    fresh_shard = False       # True right after a re-shard
    # hysteresis for the persistent-stray regime (see the reference)
    accepted_viol = 0
    while done < n_steps:
        k = min(span, n_steps - done)
        out, info = runner(state, k)
        viol = int(info["halo_violations"])
        if viol > max(2 * accepted_viol, 0) and not fresh_shard:
            reshards += 1
            if log:
                log(f"step {done}: {viol} halo violations -> re-shard "
                    f"and retry segment")
            state = morton_shard_state(state, mesh)
            fresh_shard = True
            continue
        if viol > 0:
            if fresh_shard and log:
                log(f"step {done}: {viol} violations persist after "
                    f"re-shard (ring radius {cfg.halo_ring_radius} too "
                    f"small for the geometry) — accepted and counted; "
                    f"re-shard hysteresis baseline set")
            accepted_viol = max(accepted_viol, viol)
        fresh_shard = False
        state = out
        for k2 in total:
            total[k2] += int(info[k2])
        done += k
        if on_segment is not None:
            on_segment(state, done, info)
    return state, total, reshards


def bytes_per_step(cfg: SimConfig, n: int, n_dev: int,
                   n_fields: int = 5) -> dict:
    """Received bytes a shard a step: the halo against the replicated
    layout, and the 3-D brick alternative (26 neighbours), as the
    reference computes them (see its docstring). `n_fields`: raw f32
    fields exchanged a particle (pos counts 3); the moments message is 12
    f32 per halo_chunk particles."""
    n_loc = n // n_dev
    raw = 4 * n_fields
    rep = (n_dev - 1) * n_loc * raw
    mom = (n_dev - 1) * (n_loc // cfg.halo_chunk) * 12 * 4
    halo = (min(2 * cfg.halo_ring_radius, n_dev - 1) * n_loc * raw
            + mom)
    brick = min(26, n_dev - 1) * n_loc * raw \
        + (max(n_dev - 27, 0) * (n_loc // cfg.halo_chunk) * 12 * 4)
    return {"replicated": rep, "halo": halo, "brick_26": brick,
            "ratio": rep / max(halo, 1)}
