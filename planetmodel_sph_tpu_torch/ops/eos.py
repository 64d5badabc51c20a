"""Equation of state (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/eos.py``: the polytropic
P = K rho^gamma (``PressureFieldSystem.cs:30-34``) with its barotropic
specific internal energy u = K rho^(gamma-1)/(gamma-1) and sound speed; the
ideal gas P = (gamma-1) rho u on the evolved internal energy
(``eos_mode='adiabatic'``); and the Tillotson (1962) material EOS
(``eos_mode='tillotson'``) with per-particle materials. f32 throughout.
"""

from __future__ import annotations

import torch

from ..utils import profiling

# Tillotson constants (cgs: g/cm^3, dyne/cm^2, erg/g) from Benz & Asphaug
# (1999) table 1 and Melosh (1989) appendix II; the port's own copy of the
# reference's table, in the same order (the order IS the matid encoding).
TILLOTSON_MATERIALS = {
    #          rho0     a     b     A        B        e0       e_iv     e_cv     alpha beta
    "basalt": (2.700, 0.50, 1.50, 2.67e11, 2.67e11, 4.87e12, 4.72e10, 1.82e11, 5.0, 5.0),
    "granite": (2.680, 0.50, 1.30, 1.80e11, 1.80e11, 1.60e11, 3.50e10, 1.80e11, 5.0, 5.0),
    "iron":   (7.860, 0.50, 1.50, 1.28e12, 1.05e12, 9.50e10, 1.42e10, 8.45e10, 5.0, 5.0),
    "ice":    (0.917, 0.30, 0.10, 9.47e10, 9.47e10, 1.00e11, 7.73e9,  3.04e10, 10.0, 5.0),
    "water":  (0.998, 0.70, 0.15, 2.18e10, 1.33e11, 7.00e10, 4.19e9,  2.69e10, 10.0, 5.0),
}

# Cold-expanded cutoff: below this compression ratio the condensed branch's
# tension term is unphysical (rarefied material holds no tension); P >= 0
# there.
TILLOTSON_ETA_FLOOR = 0.8

# Material-id encoding of ParticleState.matid: index into the table's order
MATERIAL_NAMES = tuple(TILLOTSON_MATERIALS)
MATERIAL_INDEX = {name: i for i, name in enumerate(MATERIAL_NAMES)}


def material_index(name: str) -> int:
    """Stable integer id of a Tillotson material (ParticleState.matid)."""
    return MATERIAL_INDEX[name]


def material_rho0(material):
    """Reference (zero-pressure cold) density: a Python float for a name,
    a tensor for a matid tensor."""
    if isinstance(material, str):
        return TILLOTSON_MATERIALS[material][0]
    tab = torch.tensor([m[0] for m in TILLOTSON_MATERIALS.values()],
                       dtype=torch.float32, device=material.device)
    return tab[material.long()]


def _till_consts(material):
    """Tillotson constants for a material name (Python floats, the scalar
    path) or a per-particle integer matid tensor (one [M, 10] table row
    gather; every constant becomes a tensor broadcasting with rho and u)."""
    if isinstance(material, str):
        return TILLOTSON_MATERIALS[material]
    tab = torch.tensor(list(TILLOTSON_MATERIALS.values()),
                       dtype=torch.float32, device=material.device)
    row = tab[material.long()]                              # [..., 10]
    return tuple(row[..., i] for i in range(10))


def pressure(rho, k: float, gamma: float = 2.0):
    if gamma == 2.0:
        return k * rho * rho
    return k * torch.pow(rho, gamma)


def internal_energy(rho, k: float, gamma: float = 2.0):
    """Specific internal energy u(rho) for the polytropic EOS."""
    if gamma == 2.0:
        return k * rho
    return k * torch.pow(rho, gamma - 1.0) / (gamma - 1.0)


def sound_speed(rho, k: float, gamma: float = 2.0):
    """c_s = sqrt(dP/drho)."""
    return torch.sqrt(gamma * k * torch.pow(rho, gamma - 1.0))


def _dmax(x, c: float):
    """d max(x, c) / dx with the reference's rule at a tie (``jnp.maximum``
    passes half the tangent there; the default u0 = 0 sits on one)."""
    return torch.where(x > c, 1.0, torch.where(x == c, 0.5, 0.0))


def _dmin(x, c: float):
    return torch.where(x < c, 1.0, torch.where(x == c, 0.5, 0.0))


def _tillotson(rho, u, material, partials: bool):
    """(P, dP/drho, dP/du) of the three-branch Tillotson form; the partials
    are None unless asked for. They are the derivatives of exactly the
    expressions below, clamps included (what forward-mode differentiation
    of the reference gives), written out by hand: a few dozen elementwise
    operations instead of a transformed trace."""
    rho0, a, b, A, B, e0, e_iv, e_cv, alpha, beta = _till_consts(material)
    rho_in, u_in = rho, u
    rho = torch.clamp(rho, min=1e-30)
    u = torch.clamp(u, min=0.0)
    eta = rho / rho0
    mu = eta - 1.0
    # at vacuum densities eta^2 underflows f32 (w -> inf) and x^2
    # overflows; both clamps are inert for eta > ~1e-8
    eta_s = torch.clamp(eta, min=1e-8)
    w = u / (e0 * eta_s * eta_s) + 1.0
    pc_raw = (a + b / w) * rho * u + A * mu + B * mu * mu
    # cold-expanded: no tension in rarefied material
    cold = (eta < TILLOTSON_ETA_FLOOR) & (u < e_cv)
    pc = torch.where(cold, torch.clamp(pc_raw, min=0.0), pc_raw)
    x_raw = rho0 / rho - 1.0
    x = torch.clamp(x_raw, max=100.0)
    decay = torch.exp(-alpha * x * x)
    e_bx = torch.exp(-beta * x)
    inner = b * rho * u / w + A * mu * e_bx
    pe = a * rho * u + inner * decay
    t_raw = (u - e_iv) / (e_cv - e_iv)
    t = torch.clamp(t_raw, 0.0, 1.0)
    hybrid = (1.0 - t) * pc + t * pe

    def select(c_val, e_val, h_val):
        return torch.where(rho >= rho0, c_val,
                           torch.where(u <= e_iv, c_val,
                                       torch.where(u >= e_cv, e_val, h_val)))

    p = select(pc, pe, hybrid)
    if not partials:
        return p, None, None
    d_rho = _dmax(rho_in, 1e-30)               # d rho (clamped) / d rho
    d_u = _dmax(u_in, 0.0)                     # d u (clamped) / d u
    d_pc = torch.where(cold, _dmax(pc_raw, 0.0), 1.0)
    # d/drho
    eta_r = d_rho / rho0
    w_r = -2.0 * u * (_dmax(eta, 1e-8) * eta_r) / (e0 * eta_s * eta_s * eta_s)
    bw2 = b / (w * w)
    pc_r = d_pc * (-bw2 * w_r * rho * u + (a + b / w) * u * d_rho
                   + A * eta_r + 2.0 * B * mu * eta_r)
    x_r = _dmin(x_raw, 100.0) * (-rho0 / (rho * rho)) * d_rho
    inner_r = (b * u * d_rho / w - bw2 * rho * u * w_r + A * eta_r * e_bx
               - A * mu * e_bx * beta * x_r)
    pe_r = (a * u * d_rho + inner_r * decay
            - inner * decay * 2.0 * alpha * x * x_r)
    dp_drho = select(pc_r, pe_r, (1.0 - t) * pc_r + t * pe_r)
    # d/du
    w_u = d_u / (e0 * eta_s * eta_s)
    pc_u = d_pc * (-bw2 * w_u * rho * u + (a + b / w) * rho * d_u)
    pe_u = a * rho * d_u + (b * rho * d_u / w - bw2 * rho * u * w_u) * decay
    t_u = (d_u / (e_cv - e_iv) * _dmax(t_raw, 0.0)
           * _dmin(torch.clamp(t_raw, min=0.0), 1.0))
    dp_du = select(pc_u, pe_u,
                   t_u * (pe - pc) + (1.0 - t) * pc_u + t * pe_u)
    return p, dp_drho, dp_du


def tillotson_pressure(rho, u, material="basalt"):
    """P(rho, u) in the three-branch Tillotson form:

    condensed (rho >= rho0, or u <= e_iv):
        Pc = (a + b/w) rho u + A mu + B mu^2,   w = u/(e0 eta^2) + 1
    expanded (rho < rho0 and u >= e_cv):
        Pe = a rho u + [b rho u / w + A mu exp(-beta x)] exp(-alpha x^2),
        x = rho0/rho - 1
    hybrid (rho < rho0, e_iv < u < e_cv): linear interpolation in u.

    Elementwise and branch-free (torch.where). The clamps (rho >= 1e-30,
    u >= 0, eta_s >= 1e-8, x <= 100) keep the unselected branches and their
    derivatives finite: `where` does not stop a NaN there (0 * inf).

    `material`: a name (uniform material, scalar constants) or an integer
    matid tensor (per-particle materials) broadcasting against rho and u."""
    return _tillotson(rho, u, material, partials=False)[0]


def tillotson_sound_speed(rho, u, material="basalt"):
    """c_s = sqrt(dP/drho|u + (P/rho^2) dP/du|rho), the adiabatic sound
    speed, with the exact partials of the pressure form. Floored at
    1e-3 sqrt(A/rho0), a fraction of the cold bulk sound speed, so viscosity
    and the CFL criterion stay defined in tension and vacuum."""
    rho0, _, _, A = _till_consts(material)[:4]
    # a higher floor than the pressure's: rho^2 in the P/rho^2 dP/du term
    # must not underflow f32; the cs floor dominates there anyway
    rho = torch.clamp(rho, min=1e-12)
    u = torch.clamp(u, min=0.0)
    p, dp_drho, dp_du = _tillotson(rho, u, material, partials=True)
    cs2 = dp_drho + p / (rho * rho) * dp_du
    cs2_floor = torch.as_tensor(1e-6 * A / rho0, dtype=cs2.dtype,
                                device=cs2.device)
    return torch.sqrt(torch.maximum(cs2, cs2_floor))


# --- cfg-aware forms (u ignored when polytropic) ---

def _need_u(cfg, u):
    if cfg.evolves_u and u is None:
        raise ValueError(f"{cfg.eos_mode} EOS needs the internal energy u")


@profiling.spanned(profiling.EOS)
def pressure_cfg(rho, cfg, u=None, matid=None):
    """P from the configured EOS. 'adiabatic' is the ideal gas
    P = (gamma-1) rho u, 'tillotson' the material EOS above, both with u
    the EVOLVED specific internal energy; 'polytropic' the barotropic
    P = K rho^gamma. `matid` (tillotson only): per-particle material ids;
    None = the uniform cfg.material."""
    _need_u(cfg, u)
    if cfg.eos_mode == "adiabatic":
        return (cfg.eos_gamma - 1.0) * rho * torch.clamp(u, min=0.0)
    if cfg.eos_mode == "tillotson":
        return tillotson_pressure(
            rho, u, cfg.material if matid is None else matid)
    return pressure(rho, cfg.eos_k, cfg.eos_gamma)


def sound_speed_cfg(rho, cfg, u=None, matid=None):
    """c_s from the configured EOS: adiabatic sqrt(gamma (gamma-1) u),
    tillotson from the exact partials, polytropic
    sqrt(gamma K rho^(gamma-1)). Floor-safe at u = 0 and rho = 0."""
    _need_u(cfg, u)
    if cfg.eos_mode == "adiabatic":
        return torch.sqrt(cfg.eos_gamma * (cfg.eos_gamma - 1.0)
                          * torch.clamp(u, min=0.0))
    if cfg.eos_mode == "tillotson":
        return tillotson_sound_speed(
            rho, u, cfg.material if matid is None else matid)
    return sound_speed(torch.clamp(rho, min=0.0), cfg.eos_k, cfg.eos_gamma)
