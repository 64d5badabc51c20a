"""Pairwise (P2P) and multipole (M2P) gravity terms (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/gravity.py``. P2P is the Dyer & Ip
(1993) uniform-density-sphere softened force law with softening length a:

    r >= a:  |grad phi| / r = m / r^3,  phi = -m/r
    r <  a:  with x = r/a,
             |grad phi| / r = (m/a^3) (8 - 9x + 2x^3)
             phi = -(m/a) (2.4 - 4x^2 + 3x^3 - 0.4 x^5)

Each function returns (grad phi, phi): the potential gradient, not the
acceleration. All are elementwise, broadcast, and NaN-free for r >= 0,
a > 0. The windowed kernels of ``ops/cuda/groups2.py`` and the all-pairs
kernels of ``ops/cuda/pairwise.py`` carry the reciprocal form inside them.
"""

from __future__ import annotations

import torch


def dyer_ip_fast(dx, r2, m, inv_a, g_const: float = 1.0):
    """Softened P2P term in reciprocal form: one rsqrt, softening as a
    precomputed 1/a (symmetrized per pair as min(1/h_i, 1/h_j)).

    dx: (..., 3) x_field - x_source; r2: (...,) |dx|^2; m: (...,) source
    mass (0 masks the pair); inv_a: (...,) reciprocal softening length."""
    inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
    x = r2 * inv_r * inv_a                         # == r/a; 0 at r=0
    x2 = x * x
    x3 = x2 * x
    inv_a3 = inv_a * inv_a * inv_a
    inner_mag_over_r = (m * inv_a3) * (8.0 - 9.0 * x + 2.0 * x3)
    inner_phi = -(m * inv_a) * (2.4 - 4.0 * x2 + 3.0 * x3 - 0.4 * x2 * x3)
    outer_mag_over_r = m * inv_r * inv_r * inv_r
    outer_phi = -m * inv_r
    near = x < 1.0                                 # r=0 falls here (softened)
    mag_over_r = torch.where(near, inner_mag_over_r, outer_mag_over_r)
    phi = torch.where(near, inner_phi, outer_phi)
    grad_phi = dx * (g_const * mag_over_r)[..., None]
    return grad_phi, g_const * phi


def dyer_ip(dx, r, m, a, g_const: float = 1.0):
    """Softened P2P contribution of a source (mass m at distance r, 0 masks
    the pair) on a field point, softening length a."""
    r_safe = torch.where(r > 0.0, r, 1.0)
    x = r / a
    x2 = x * x
    x3 = x2 * x
    inner_mag_over_r = (m / (a * a * a)) * (8.0 - 9.0 * x + 2.0 * x3)
    inner_phi = -(m / a) * (2.4 - 4.0 * x2 + 3.0 * x3 - 0.4 * x2 * x3)
    outer_mag_over_r = m / (r_safe * r_safe * r_safe)
    outer_phi = -m / r_safe
    near = r < a
    mag_over_r = torch.where(near, inner_mag_over_r, outer_mag_over_r)
    phi = torch.where(near, inner_phi, outer_phi)
    grad_phi = dx * (g_const * mag_over_r)[..., None]
    return grad_phi, g_const * phi


def monopole(dx, r, m, g_const: float = 1.0):
    """Unsoftened monopole M2P term; `m` is the node's monopole moment and
    `dx` points from its centre of mass to the field point."""
    r_safe = torch.where(r > 0.0, r, 1.0)
    mag_over_r = m / (r_safe * r_safe * r_safe)
    phi = -m / r_safe
    grad_phi = dx * (g_const * mag_over_r)[..., None]
    return grad_phi, g_const * phi


def accept_bmax(r2, bmax2, theta: float):
    """Salmon & Warren (1993) bmax MAC (``GravityFieldSystem.cs:229-247``):
    accept a node when bmax^2 < theta^2 r^2 (squared lengths, no sqrt)."""
    return bmax2 < (theta * theta) * r2
