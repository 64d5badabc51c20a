"""Initial-condition generators (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/models/ics.py``: the reference scene
(N particles uniform in a ball, at rest, support radius kh =
particle_radius * (1 + U[0, 0.5)), equal masses), the analytic n=1
polytrope, the two-planet collision and the over-rotating planet.

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


def _state(cfg: SimConfig, pos, h, rho, device) -> ParticleState:
    """A state at rest from positions, smoothing lengths and the IC density
    estimate, moved to `device`."""
    dev = resolve_device(device)
    n, dt = cfg.n, cfg.torch_dtype
    z3 = lambda: torch.zeros((n, 3), dtype=dt)
    z1 = lambda: torch.zeros((n,), dtype=dt)
    i1 = lambda: torch.zeros((n,), dtype=torch.int32)
    st = ParticleState(
        pos=pos, vel=z3(), mass=torch.full((n,), cfg.particle_mass, dtype=dt),
        h=h, rho=rho,
        pressure=eos_ops.pressure(rho, cfg.eos_k, cfg.eos_gamma),
        grad_p=z3(), phi=z1(), grad_phi=z3(), n_neighbors=i1(),
        n_direct=i1(), n_approx=i1(), accel=z3(),
        # thermal state matching the polytropic relation at the IC density
        u=eos_ops.internal_energy(rho, cfg.eos_k, cfg.eos_gamma),
        du_dt=z1(),
        matid=torch.full((n,), eos_ops.material_index(cfg.material),
                         dtype=torch.int32),
        balsara=torch.ones((n,), dtype=dt))
    return _to(st, dev)


def _to(state: ParticleState, dev) -> ParticleState:
    return ParticleState(**{k: getattr(state, k).to(dev) for k in FIELDS})


def jupiter(cfg: SimConfig, device="cuda") -> ParticleState:
    """The reference scene: cold uniform ball of gas, at rest
    (count=3000, particleRadius=5, radius=50, totalMass=100 by default)."""
    eos_ops.require_polytropic(cfg)
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

    eos_ops.require_polytropic(cfg)
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
    x; impact_parameter offsets them along y. Per-body `materials` need the
    Tillotson EOS and are not ported."""
    if materials is not None:
        raise NotImplementedError("materials: per-body Tillotson materials "
                                  "are not ported")
    n_a = (cfg.n + 1) // 2
    n_b = cfg.n - n_a

    def body(nn, seed):
        return jupiter(cfg.replace(n=nn, seed=seed,
                                   total_mass=cfg.total_mass * nn / cfg.n),
                       device="cpu")

    a, b = body(n_a, cfg.seed), body(n_b, cfg.seed + 1)
    dx = torch.tensor([separation / 2, impact_parameter / 2, 0.0],
                      dtype=a.pos.dtype)
    dv = torch.tensor([approach_speed / 2, 0.0, 0.0], dtype=a.pos.dtype)
    both = ParticleState(**{k: torch.cat([getattr(a, k), getattr(b, k)])
                            for k in FIELDS})
    both = both.replace(pos=torch.cat([a.pos - dx, b.pos + dx]),
                        vel=torch.cat([a.vel + dv, b.vel - dv]))
    return _to(both, resolve_device(device))


def differentiated_planet(cfg: SimConfig, *args, **kwargs):
    """Dense core inside a lighter mantle: defined by the Tillotson
    materials' reference densities, so it waits for that EOS."""
    raise NotImplementedError("differentiated_planet needs eos_mode="
                              "'tillotson', which is not ported")


def rotating_planet(cfg: SimConfig, omega: float = 0.05,
                    device="cuda") -> ParticleState:
    """Over-rotating planet: solid-body rotation about z."""
    st = jupiter(cfg, device="cpu")
    w = torch.tensor([0.0, 0.0, omega], dtype=st.pos.dtype).expand_as(st.pos)
    st = st.replace(vel=torch.linalg.cross(w, st.pos))
    return _to(st, resolve_device(device))
