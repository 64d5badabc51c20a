"""Monaghan-Lattanzio (1983) cubic spline SPH kernel (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/ops/kernels.py``, expression for
expression: 3D normalization 1/(pi h^3), support radius kappa*h with
kappa = 2, piecewise in q = r/h. ``sign_bug=True`` reproduces the
reference's ``+3q`` error in the q < 1 branch of dW/dr
(``SplineKernel.cs:135``). Everything is elementwise, broadcasts, and is
NaN-free for r >= 0, h > 0 (branches not taken still execute under
``torch.where``).
"""

from __future__ import annotations

import math

import torch

KAPPA = 2.0
_PI = math.pi


def w(r, h):
    """Kernel value W(r, h). Shapes broadcast."""
    q = r / h
    inv_pi_h3 = 1.0 / (_PI * h * h * h)
    q2 = q * q
    inner = (1.0 - 1.5 * q2 + 0.75 * q2 * q) * inv_pi_h3
    t = 2.0 - q
    outer = 0.25 * t * t * t * inv_pi_h3
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def w0(h):
    """W(0, h) = 1/(pi h^3), the self-density term."""
    return 1.0 / (_PI * h * h * h)


def dw_dr(r, h, sign_bug: bool = False):
    """Radial derivative dW/dr."""
    q = r / h
    inv_pi_h4 = 1.0 / (_PI * h * h * h * h)
    inner_lin = 3.0 * q if sign_bug else -3.0 * q
    inner = (inner_lin + 2.25 * q * q) * inv_pi_h4
    t = 2.0 - q
    outer = -0.75 * t * t * inv_pi_h4
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def dw_dr_over_r(r, h, sign_bug: bool = False):
    """(dW/dr)/r, finite at r=0 (limit -3/(pi h^5); +3/(pi h^5) with the
    bug). grad_i W = (x_i - x_j) * (dW/dr)/r."""
    h5 = h * h * h * h * h
    q = r / h
    inv_pi_h5 = 1.0 / (_PI * h5)
    lin = 3.0 if sign_bug else -3.0
    inner = (lin + 2.25 * q) * inv_pi_h5
    t = 2.0 - q
    r_safe = torch.where(r > 0.0, r, 1.0)
    outer = -0.75 * t * t / (_PI * h * h * h * h * r_safe)
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def w_and_grad(dx, r, h, sign_bug: bool = False):
    """Fused (W, grad_i W) for a displacement dx = x_i - x_j with |dx| = r:
    shapes (...,) and (..., 3)."""
    wv = w(r, h)
    grad = dx * dw_dr_over_r(r, h, sign_bug)[..., None]
    return wv, grad


def dw_dh(r, h):
    """Partial derivative of W w.r.t. h: -(3 W + r dW/dr)/h, written fully
    in q so no branch multiplies a huge r into a zero."""
    q = r / h
    inv_pi_h4 = 1.0 / (_PI * h * h * h * h)
    q2 = q * q
    inner = 3.0 * (1.0 - 1.5 * q2 + 0.75 * q2 * q) \
        + (-3.0 * q2 + 2.25 * q2 * q)
    t = 2.0 - q
    outer = 0.75 * t * t * t - 0.75 * q * t * t
    val = torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))
    return -val * inv_pi_h4


def interacts(r2, h_i, h_j, kappa: float = KAPPA):
    """True iff r^2 < (kappa * max(h_i, h_j))^2: the pair is inside the
    larger of the two support radii."""
    s = torch.maximum(h_i, h_j) * kappa
    return r2 < s * s
