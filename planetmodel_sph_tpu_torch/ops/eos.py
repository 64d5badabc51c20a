"""Equation of state (PyTorch port, polytropic path).

P = K rho^gamma (``PressureFieldSystem.cs:30-34``), the barotropic
specific internal energy u = K rho^(gamma-1)/(gamma-1) used by the energy
diagnostic, and the sound speed. The adiabatic and Tillotson EOS of
``planetmodel_sph_tpu.ops.eos`` are not ported yet.
"""

from __future__ import annotations

import torch

# material-id encoding of ParticleState.matid (the reference's Tillotson
# table order); the polytropic path only needs the ids
MATERIAL_NAMES = ("basalt", "granite", "iron", "ice", "water")


def material_index(name: str) -> int:
    """Stable integer id of a Tillotson material (ParticleState.matid)."""
    return MATERIAL_NAMES.index(name)


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


def require_polytropic(cfg):
    if cfg.eos_mode != "polytropic":
        raise NotImplementedError(
            f"eos_mode={cfg.eos_mode!r}: the port runs the polytropic EOS "
            "only")


def pressure_cfg(rho, cfg, u=None, matid=None):
    """P from the configured EOS (polytropic: u and matid are unused)."""
    require_polytropic(cfg)
    return pressure(rho, cfg.eos_k, cfg.eos_gamma)


def sound_speed_cfg(rho, cfg, u=None, matid=None):
    """c_s from the configured EOS, floor-safe at rho=0."""
    require_polytropic(cfg)
    return sound_speed(torch.clamp(rho, min=0.0), cfg.eos_k, cfg.eos_gamma)
