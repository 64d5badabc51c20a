"""Initial-condition generators (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/models/ics.py``: the reference scene
(N particles uniform in a ball, at rest, support radius kh =
particle_radius * (1 + U[0, 0.5)), equal masses), the analytic n=1
polytrope, the two-planet collision (with per-body Tillotson materials),
the differentiated core-and-mantle body and the over-rotating planet.

Random numbers come from an explicit ``torch.Generator`` seeded with
`cfg.seed`. Every state is drawn and assembled on the CPU and then moved to
`device`, so a run on the card and a run on the CPU start from identical
particles. The stream is PyTorch's, not the reference's threefry: the same
seed gives the same *distribution*, not the same particles.
"""

from __future__ import annotations

import math

import torch

from ..config import SimConfig
from ..ops import eos as eos_ops
from ..state import FIELDS, ParticleState, resolve_device


def _generator(seed: int) -> torch.Generator:
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return gen


def _unit_vectors(gen, n, dtype):
    d = torch.randn((n, 3), generator=gen, dtype=dtype)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def uniform_sphere(gen: torch.Generator, n, radius, dtype=torch.float32,
                   method="rejection"):
    """n points uniform in a ball of the given radius, on the CPU.

    method='rejection' mirrors the reference's sampler (uniform in the
    bounding cube, keep the points inside) in a fixed-size way: oversample
    the cube 4x and take the first n accepted points in draw order
    (acceptance pi/6 ~ 0.52, so a shortfall has probability < 1e-40 at any
    realistic n). method='direct' is the inverse-CDF construction
    r = R u^(1/3) with an isotropic direction."""
    if method == "direct":
        u = torch.rand((n,), generator=gen, dtype=dtype)
        r = radius * torch.pow(u, 1.0 / 3.0)
        return r[:, None] * _unit_vectors(gen, n, dtype)
    if method != "rejection":
        raise ValueError(f"method={method!r}: 'rejection' or 'direct'")
    m = 4 * n + 64
    pts = (torch.rand((m, 3), generator=gen, dtype=dtype) * 2.0 - 1.0) \
        * radius
    inside = (pts * pts).sum(dim=-1) < radius * radius
    idx = torch.nonzero(inside)[:n, 0]
    if idx.shape[0] < n:
        raise RuntimeError(f"rejection sampling kept {idx.shape[0]} of the "
                           f"{n} points asked for")
    return pts[idx]


def _init_u(cfg: SimConfig, rho):
    """IC thermal state: the cold material energy cfg.u0 (tillotson), or
    the polytropic relation at the IC density (an adiabatic run starts at
    the barotropic EOS's pressure; inert otherwise)."""
    if cfg.eos_mode == "tillotson":
        return torch.full_like(rho, cfg.u0)
    return eos_ops.internal_energy(rho, cfg.eos_k, cfg.eos_gamma)


def _init_matid(cfg: SimConfig, n: int):
    """Uniform material ids from cfg.material (inert unless tillotson)."""
    return torch.full((n,), eos_ops.material_index(cfg.material),
                      dtype=torch.int32)


def _state(cfg: SimConfig, pos, h, rho, device, mass=None, pressure=None,
           u=None, matid=None) -> ParticleState:
    """A state at rest from positions, smoothing lengths and the IC density
    estimate, moved to `device`. Equal masses, the polytropic pressure, the
    configured EOS's initial u and cfg.material unless given."""
    dev = resolve_device(device)
    n, dt = cfg.n, cfg.torch_dtype
    z3 = lambda: torch.zeros((n, 3), dtype=dt)
    z1 = lambda: torch.zeros((n,), dtype=dt)
    i1 = lambda: torch.zeros((n,), dtype=torch.int32)
    st = ParticleState(
        pos=pos, vel=z3(),
        mass=torch.full((n,), cfg.particle_mass, dtype=dt) if mass is None
        else mass,
        h=h, rho=rho,
        pressure=eos_ops.pressure(rho, cfg.eos_k, cfg.eos_gamma)
        if pressure is None else pressure,
        grad_p=z3(), phi=z1(), grad_phi=z3(), n_neighbors=i1(),
        n_direct=i1(), n_approx=i1(), accel=z3(),
        u=_init_u(cfg, rho) if u is None else u, du_dt=z1(),
        matid=_init_matid(cfg, n) if matid is None else matid,
        balsara=torch.ones((n,), dtype=dt))
    return _to(st, dev)


def _to(state: ParticleState, dev) -> ParticleState:
    return ParticleState(**{k: getattr(state, k).to(dev) for k in FIELDS})


def jupiter(cfg: SimConfig, device="cuda") -> ParticleState:
    """The reference scene: cold uniform ball of gas, at rest
    (count=3000, particleRadius=5, radius=50, totalMass=100 by default)."""
    dt = cfg.torch_dtype
    gen = _generator(cfg.seed)
    pos = uniform_sphere(gen, cfg.n, cfg.radius, dt)
    # support radius kh = particleRadius * (1 + U[0, 0.5)); h = kh / kappa
    kh = cfg.particle_radius * (
        1.0 + 0.5 * torch.rand((cfg.n,), generator=gen, dtype=dt))
    rho0 = cfg.total_mass / (4.0 / 3.0 * math.pi * cfg.radius ** 3)
    return _state(cfg, pos, kh / cfg.kappa,
                  torch.full((cfg.n,), rho0, dtype=dt), device)


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at x, xp increasing."""
    hi = torch.clamp(torch.searchsorted(xp, x), 1, xp.shape[0] - 1)
    lo = hi - 1
    t = (x - xp[lo]) / (xp[hi] - xp[lo])
    return fp[lo] + t * (fp[hi] - fp[lo])


def polytrope_radius(cfg: SimConfig) -> float:
    """Outer radius R1 = pi sqrt(K / (2 pi G)) of the n=1 polytrope."""
    return math.pi * math.sqrt(cfg.eos_k / (2.0 * math.pi * cfg.g_const))


def polytrope(cfg: SimConfig, rho_floor_frac: float = 0.01,
              device="cuda") -> ParticleState:
    """n=1 polytrope: the analytic hydrostatic equilibrium for P = K rho^2,
    rho(r) = rho_c sin(xi)/xi with xi = pi r / R1. Particles are drawn from
    the exact enclosed-mass CDF m(xi)/M = (sin xi - xi cos xi)/pi by inverse
    transform, at rest, with h = eta (m/rho)^(1/3) matched to the local
    density (rho floored at rho_floor_frac * rho_c so outer-shell smoothing
    lengths stay bounded)."""
    from .planet import h_eta

    dt = cfg.torch_dtype
    gen = _generator(cfg.seed)
    r1 = polytrope_radius(cfg)
    xi_grid = torch.linspace(0.0, math.pi, 4097, dtype=dt)
    cdf = (torch.sin(xi_grid) - xi_grid * torch.cos(xi_grid)) / math.pi
    u = torch.rand((cfg.n,), generator=gen, dtype=dt)
    xi = _interp(u, cdf, xi_grid)
    r = xi * (r1 / math.pi)
    pos = r[:, None] * _unit_vectors(gen, cfg.n, dt)

    rho_c = cfg.total_mass * math.pi ** 2 / (4.0 * r1 ** 3)
    sinc = torch.where(xi > 1e-4, torch.sin(xi) / torch.clamp(xi, min=1e-4),
                       1.0)
    rho = rho_c * sinc
    rho_h = torch.clamp(rho, min=rho_floor_frac * rho_c)
    h = h_eta(cfg) * torch.pow(cfg.particle_mass / rho_h, 1.0 / 3.0)
    if cfg.h_max > 0.0:
        h = torch.clamp(h, max=cfg.h_max)
    return _state(cfg, pos, h, rho, device)


def two_planet_collision(cfg: SimConfig, separation: float = 150.0,
                         approach_speed: float = 0.5,
                         impact_parameter: float = 0.0, materials=None,
                         device="cuda") -> ParticleState:
    """Two Jupiter-like planets on a collision course. The particles split
    (n+1)//2 / n//2 (exactly cfg.n particles, odd n included) with mass
    proportional to count and a bulk velocity of +-approach_speed/2 along
    x; impact_parameter offsets them along y.

    `materials` (tillotson only): per-body material names, e.g. ("basalt",
    "ice") for a rock-on-ice impact. Each body's RADIUS is then derived
    from its material's cold reference density, so that the body starts at
    rho0 (one inheriting cfg.radius would start compressed by rho_IC/rho0
    and explode under the stiff cold-pressure terms); masses stay
    proportional to count, so particles have equal mass across both
    bodies."""
    n_a = (cfg.n + 1) // 2
    n_b = cfg.n - n_a
    mat_a, mat_b = materials if materials is not None \
        else (cfg.material, cfg.material)

    def body(nn, mat, seed):
        c = cfg.replace(n=nn, total_mass=cfg.total_mass * nn / cfg.n,
                        seed=seed, material=mat)
        if materials is not None and cfg.eos_mode == "tillotson":
            rho0 = eos_ops.material_rho0(mat)
            r = (3.0 * c.total_mass / (4.0 * math.pi * rho0)) ** (1.0 / 3.0)
            c = c.replace(radius=r, particle_radius=cfg.particle_radius
                          * r / cfg.radius)
        return jupiter(c, device="cpu")

    a, b = body(n_a, mat_a, cfg.seed), body(n_b, mat_b, cfg.seed + 1)
    dx = torch.tensor([separation / 2, impact_parameter / 2, 0.0],
                      dtype=a.pos.dtype)
    dv = torch.tensor([approach_speed / 2, 0.0, 0.0], dtype=a.pos.dtype)
    both = ParticleState(**{k: torch.cat([getattr(a, k), getattr(b, k)])
                            for k in FIELDS})
    both = both.replace(pos=torch.cat([a.pos - dx, b.pos + dx]),
                        vel=torch.cat([a.vel + dv, b.vel - dv]))
    return _to(both, resolve_device(device))


def differentiated_planet(cfg: SimConfig, core_material: str = "iron",
                          mantle_material: str = "basalt",
                          core_mass_frac: float = 0.3,
                          device="cuda") -> ParticleState:
    """Differentiated body: a dense core inside a lighter mantle (Tillotson
    EOS; the classic planetary-collision IC, cf. Benz & Asphaug 1999).

    The geometry follows from the materials' cold reference densities so
    that the body starts pressure-free: V_core = f M / rho0_core, the
    mantle fills the rest at rho0_mantle, and the OUTER RADIUS OVERRIDES
    cfg.radius (a cold Tillotson shell at rho != rho0 would start with
    pressure of the scale of A and explode). Particle counts split in
    proportion to mass (equal-mass particles), positions are uniform within
    each shell, u = cfg.u0, at rest."""
    from .planet import h_eta

    if cfg.eos_mode != "tillotson":
        raise ValueError("differentiated_planet needs eos_mode='tillotson' "
                         "(materials define the density structure)")
    dt = cfg.torch_dtype
    gen = _generator(cfg.seed)
    rho_core = eos_ops.material_rho0(core_material)
    rho_mant = eos_ops.material_rho0(mantle_material)
    m_core_tot = core_mass_frac * cfg.total_mass
    m_mant_tot = cfg.total_mass - m_core_tot
    v_core = m_core_tot / rho_core
    v_mant = m_mant_tot / rho_mant
    four_pi_3 = 4.0 / 3.0 * math.pi
    r_core = (v_core / four_pi_3) ** (1.0 / 3.0)
    r_out = ((v_core + v_mant) / four_pi_3) ** (1.0 / 3.0)

    n_core = max(1, min(cfg.n - 1, round(cfg.n * core_mass_frac)))
    n_mant = cfg.n - n_core

    pos_core = uniform_sphere(gen, n_core, r_core, dt)
    # mantle shell: r = (r_core^3 + U (r_out^3 - r_core^3))^(1/3)
    uu = torch.rand((n_mant,), generator=gen, dtype=dt)
    r = torch.pow(r_core ** 3 + uu * (r_out ** 3 - r_core ** 3), 1.0 / 3.0)
    pos = torch.cat([pos_core, r[:, None] * _unit_vectors(gen, n_mant, dt)])

    full = lambda k, v, d=dt: torch.full((k,), v, dtype=d)
    mass = torch.cat([full(n_core, m_core_tot / n_core),
                      full(n_mant, m_mant_tot / n_mant)])
    rho = torch.cat([full(n_core, rho_core), full(n_mant, rho_mant)])
    matid = torch.cat([
        full(n_core, eos_ops.material_index(core_material), torch.int32),
        full(n_mant, eos_ops.material_index(mantle_material), torch.int32)])
    h = h_eta(cfg) * torch.pow(mass / rho, 1.0 / 3.0)
    if cfg.h_max > 0.0:
        h = torch.clamp(h, max=cfg.h_max)
    u = torch.full((cfg.n,), cfg.u0, dtype=dt)
    return _state(cfg, pos, h, rho, device, mass=mass,
                  pressure=eos_ops.tillotson_pressure(rho, u, matid), u=u,
                  matid=matid)


def rotating_planet(cfg: SimConfig, omega: float = 0.05,
                    device="cuda") -> ParticleState:
    """Over-rotating planet: solid-body rotation about z."""
    st = jupiter(cfg, device="cpu")
    w = torch.tensor([0.0, 0.0, omega], dtype=st.pos.dtype).expand_as(st.pos)
    st = st.replace(vel=torch.linalg.cross(w, st.pos))
    return _to(st, resolve_device(device))
