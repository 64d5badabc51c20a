"""Conserved-quantity and field diagnostics (PyTorch port).

Same keys and definitions as ``planetmodel_sph_tpu.utils.diagnostics``:
KE = 1/2 sum m |v|^2, PE = 1/2 sum m phi, E_int = sum m u (the evolved u
under the adiabatic and Tillotson EOS, u(rho) under the polytropic); momenta
and angular momentum about the centre of mass. `inertia_com` is the trace
moment sum m |r - r_com|^2, as in the reference (not I_zz). Values are
0-dim tensors on the state's device.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops import eos as eos_ops
from ..state import ParticleState
from . import profiling


def _safe_norm(x):
    """|x| without squaring large components in f32."""
    s = torch.clamp(x.abs().max(), min=1e-30)
    return s * torch.sqrt(((x / s) ** 2).sum())


@profiling.spanned(profiling.MEASURE)
def measure(state: ParticleState, cfg: SimConfig) -> dict:
    m = state.mass
    v2 = (state.vel * state.vel).sum(dim=-1)
    ke = 0.5 * (m * v2).sum()
    pe = 0.5 * (m * state.phi).sum()
    # an evolved-u EOS: the state's thermal energy; polytropic: the
    # barotropic u(rho)
    u = state.u if cfg.evolves_u else \
        eos_ops.internal_energy(state.rho, cfg.eos_k, cfg.eos_gamma)
    e_int = (m * u).sum()
    mom = (m[:, None] * state.vel).sum(dim=0)
    mtot = m.sum()
    com = (m[:, None] * state.pos).sum(dim=0) / mtot
    vcom = mom / mtot
    ang = (m[:, None] * torch.linalg.cross(state.pos - com,
                                           state.vel - vcom)).sum(dim=0)
    r = torch.linalg.norm(state.pos - com, dim=-1)
    inertia = (m * r * r).sum()

    def stats(x, name):
        return {f"{name}_min": x.min(), f"{name}_max": x.max(),
                f"{name}_avg": x.mean()}

    nn = state.n_neighbors
    out = {
        "mass": mtot,
        "kinetic_energy": ke,
        "potential_energy": pe,
        "internal_energy": e_int,
        "total_energy": ke + pe + e_int,
        "momentum_x": mom[0], "momentum_y": mom[1], "momentum_z": mom[2],
        "momentum_mag": _safe_norm(mom),
        "angular_momentum_x": ang[0],
        "angular_momentum_y": ang[1],
        "angular_momentum_z": ang[2],
        "angular_momentum_mag": _safe_norm(ang),
        "inertia_com": inertia,
        "radius_rms": torch.sqrt((r * r).mean()),
        "radius_max": r.max(),
        "neighbors_avg": nn.to(torch.float32).mean(),
        "neighbors_min": nn.min(),
        "neighbors_max": nn.max(),
        "gravity_p2p_avg": state.n_direct.to(torch.float32).mean(),
        "gravity_m2p_avg": state.n_approx.to(torch.float32).mean(),
        "h_min": state.h.min(),
        "h_max": state.h.max(),
        "h_avg": state.h.mean(),
        "vel_max": torch.sqrt(v2.max()),
    }
    cs = eos_ops.sound_speed_cfg(torch.clamp(state.rho, min=1e-30), cfg,
                                 u=state.u if cfg.evolves_u else None)
    dt_cfl = state.h / (cs + torch.sqrt(v2) + 1e-30)
    out["dt_cfl_min"] = dt_cfl.min()
    out["cfl_number"] = cfg.dt / torch.clamp(dt_cfl.min(), min=1e-30)
    out.update(stats(state.rho, "rho"))
    out.update(stats(state.pressure, "pressure"))
    out.update(stats(state.phi, "phi"))
    out.update(stats(u, "specific_internal_energy"))
    return out


def energy_drift(diags: dict):
    """Relative drift |E(t) - E(0)| / |E(0)| from a stacked diagnostics
    dict."""
    e = diags["total_energy"]
    return (e - e[0]).abs() / e[0].abs()
