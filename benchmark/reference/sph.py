"""Plain PyTorch SPH and self-gravity: the arithmetic of the reference.

Written from the published equations and the configuration's keys, and
from nothing of the program under test (it imports no module of it and
reads none of its tables): the Monaghan-Lattanzio cubic spline with
support 2h, the polytropic EOS P = K rho^gamma, grad-h density and
pressure force (Springel & Hernquist 2002) or the symmetric forms, and
Dyer & Ip (1993) softened gravity with the softening length max(h_i, h_j).

Every function takes tensors of one dtype and computes in it, so the same
code gives the float64 reference and the lower-precision control. Pair
sums over neighbours go through explicit pair lists; gravity is the exact
sum over all pairs, Newtonian from a matrix product and corrected to the
softened law for the pairs of the list that lie inside their softening.
"""

from __future__ import annotations

import math

import torch

PI = math.pi
KAPPA = 2.0


# ---------------------------------------------------------------------------
# kernel and EOS
# ---------------------------------------------------------------------------

def w(r, h):
    """W(r, h) = 1/(pi h^3) {1 - 1.5 q^2 + 0.75 q^3 | 0.25 (2-q)^3 | 0}."""
    q = r / h
    c = 1.0 / (PI * h ** 3)
    inner = (1.0 - 1.5 * q ** 2 + 0.75 * q ** 3) * c
    outer = 0.25 * (2.0 - q) ** 3 * c
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def dw_dr_over_r(r, h):
    """(dW/dr) / r; at r = 0 its limit -3/(pi h^5)."""
    q = r / h
    inner = (-3.0 + 2.25 * q) / (PI * h ** 5)
    rs = torch.where(r > 0.0, r, 1.0)
    outer = -0.75 * (2.0 - q) ** 2 / (PI * h ** 4 * rs)
    return torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))


def dw_dh(r, h):
    """dW/dh = -(3 W + r dW/dr) / h."""
    q = r / h
    inner = 3.0 * (1.0 - 1.5 * q ** 2 + 0.75 * q ** 3) \
        + (-3.0 * q ** 2 + 2.25 * q ** 3)
    outer = 0.75 * (2.0 - q) ** 3 - 0.75 * q * (2.0 - q) ** 2
    val = torch.where(q < 1.0, inner, torch.where(q < 2.0, outer, 0.0))
    return -val / (PI * h ** 4)


def pressure(rho, cfg):
    if cfg["eos_mode"] != "polytropic":
        raise NotImplementedError(f"eos_mode={cfg['eos_mode']!r}")
    return cfg["eos_k"] * rho ** cfg["eos_gamma"]


def h_eta(cfg) -> float:
    """eta of h = eta (m/rho)^(1/3), which gives target_neighbors inside
    the support radius 2h."""
    return ((3.0 * cfg["target_neighbors"] / (4.0 * PI)) ** (1.0 / 3.0)
            / cfg["kappa"])


# ---------------------------------------------------------------------------
# pairs
# ---------------------------------------------------------------------------

def _block_rows(n: int, budget: int = 1 << 27) -> int:
    return max(1, min(n, budget // max(1, n)))


def all_pairs(pos, mass, g_const, reach=None, gravity=True):
    """One pass over all pairs i != j, in blocks of target rows.

    Returns (grad_phi [N,3], phi [N], pairs) where the gravity is the
    Newtonian sum -sum_j g m_j / r over pairs at a distance above 0 (its
    gradient pointing away from the sources), before any softening (None
    when `gravity` is False), and
    `pairs` = (i, j) of every ordered pair with r < max(reach_i, reach_j)
    (None without `reach`)."""
    n = pos.shape[0]
    dt, dev = pos.dtype, pos.device
    sq = (pos * pos).sum(dim=-1)
    ones_x = torch.cat([pos, torch.ones((n, 1), dtype=dt, device=dev)],
                       dim=-1)
    gphi = torch.zeros((n, 3), dtype=dt, device=dev)
    phi = torch.zeros((n,), dtype=dt, device=dev)
    pi_list, pj_list = [], []
    b = _block_rows(n)
    for i0 in range(0, n, b):
        i1 = min(n, i0 + b)
        rows = torch.arange(i0, i1, device=dev)
        r2 = sq[i0:i1, None] + sq[None, :] - 2.0 * (pos[i0:i1] @ pos.T)
        # the self pair, and pairs at no distance in this dtype, take no
        # Newtonian term (the softened law gives theirs)
        r2 = torch.where(r2 > 0.0, r2, float("inf"))
        r2[rows - i0, rows] = float("inf")
        if reach is not None:
            rc = torch.maximum(reach[i0:i1, None], reach[None, :])
            ii, jj = torch.nonzero(r2 < rc * rc, as_tuple=True)
            pi_list.append(ii + i0)
            pj_list.append(jj)
        if gravity:
            inv_r = torch.rsqrt(r2)                       # 0 on the self pair
            phi[i0:i1] = -(inv_r @ mass)
            wgt = inv_r * inv_r * inv_r * mass[None, :]
            s = wgt @ ones_x                              # [b, 4]
            gphi[i0:i1] = pos[i0:i1] * s[:, 3:4] - s[:, :3]
            del inv_r, wgt
        del r2
    pairs = None
    if reach is not None:
        pairs = (torch.cat(pi_list), torch.cat(pj_list))
    if not gravity:
        return None, None, pairs
    return g_const * gphi, g_const * phi, pairs


def pair_geometry(pos, pairs):
    i, j = pairs
    dx = pos[i] - pos[j]
    r = torch.sqrt((dx * dx).sum(dim=-1))
    return dx, r


def _scatter(n, i, vals):
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, i, vals)


def dyer_ip(dx, r, m, a):
    """Dyer-Ip softened (grad phi, phi) of a source m at separation dx,
    |dx| = r, softening a (uniform-density sphere inside r < a)."""
    x = r / a
    inner_mag = m / a ** 3 * (8.0 - 9.0 * x + 2.0 * x ** 3)
    inner_phi = -(m / a) * (2.4 - 4.0 * x ** 2 + 3.0 * x ** 3
                            - 0.4 * x ** 5)
    rs = torch.where(r > 0.0, r, 1.0)
    near = r < a
    mag = torch.where(near, inner_mag, m / rs ** 3)
    phi = torch.where(near, inner_phi, -m / rs)
    return dx * mag[:, None], phi


def newton_pair(dx, r, m):
    """The Newtonian (grad phi, phi) of a source m at separation dx; none
    at r = 0, as in :func:`all_pairs`."""
    at = r > 0.0
    rs = torch.where(at, r, 1.0)
    return (dx * torch.where(at, m / rs ** 3, 0.0)[:, None],
            torch.where(at, -m / rs, 0.0))


def softening(h, i, j, cfg):
    if cfg["softening_mode"] == "receiver_h":
        return h[i]
    return torch.maximum(h[i], h[j])


def pair_gravity(pos, h, mass, pairs, cfg):
    """The softened (grad phi, phi) summed over the listed pairs."""
    i, j = pairs
    dx, r = pair_geometry(pos, pairs)
    g, p = dyer_ip(dx, r, mass[j], softening(h, i, j, cfg))
    n = pos.shape[0]
    gc = cfg["g_const"]
    return gc * _scatter(n, i, g), gc * _scatter(n, i, p)


def softening_correction(pos, h, mass, pairs, cfg):
    """What the softened law adds to the Newtonian one over the listed
    pairs: (grad phi, phi). The list must hold every pair inside its
    softening."""
    i, j = pairs
    dx, r = pair_geometry(pos, pairs)
    a = softening(h, i, j, cfg)
    inside = r < a
    i, j, dx, r, a = i[inside], j[inside], dx[inside], r[inside], a[inside]
    gs, ps = dyer_ip(dx, r, mass[j], a)
    gn, pn = newton_pair(dx, r, mass[j])
    n = pos.shape[0]
    gc = cfg["g_const"]
    return gc * _scatter(n, i, gs - gn), gc * _scatter(n, i, ps - pn)


def com_correct(grad_phi, mass, cfg):
    """Subtract the mass-weighted mean of grad phi (the configuration's
    exact momentum conservation for tree gravity)."""
    if not (cfg["grav_com_correction"] and cfg["gravity_solver"] == "tree"):
        return grad_phi
    mean = (mass[:, None] * grad_phi).sum(dim=0) / mass.sum()
    return grad_phi - mean[None, :]


# ---------------------------------------------------------------------------
# SPH sums over a pair list
# ---------------------------------------------------------------------------

def density(pos, h, mass, pairs, cfg):
    """(rho, omega, n_neighbors). grad-h: the gather form sum_j m_j
    W(r, h_i) and Omega_i = 1 + h_i/(3 rho_i) sum_j m_j dW/dh; otherwise
    the symmetric form sum_j m_j (W(r, h_i) + W(r, h_j))/2 and Omega = 1.
    The self term m_i W(0, h_i) is in both; n_neighbors counts j != i with
    r < 2 h_i."""
    n = pos.shape[0]
    i, j = pairs
    dx, r = pair_geometry(pos, pairs)
    hi = h[i]
    wi = w(r, hi)
    w0 = mass / (PI * h ** 3)
    nn = _scatter(n, i, (r < KAPPA * hi).to(torch.int32))
    if cfg["grad_p_mode"] == "grad_h":
        rho = w0 + _scatter(n, i, mass[j] * wi)
        xi = -3.0 * w0 / h + _scatter(n, i, mass[j] * dw_dh(r, hi))
        omega = 1.0 + h * xi / (3.0 * rho)
    else:
        rho = w0 + _scatter(n, i, mass[j] * 0.5 * (wi + w(r, h[j])))
        omega = torch.ones_like(rho)
    return rho, omega, nn


def pressure_gradient(pos, h, mass, rho, omega, prs, pairs, cfg):
    """grad P_i. grad-h: rho_i sum_j m_j [P_i/(Omega_i rho_i^2) dW(h_i) +
    P_j/(Omega_j rho_j^2) dW(h_j)] (Omega floored at 0.1); symmetric:
    rho_i sum_j m_j (P_i/rho_i^2 + P_j/rho_j^2) (dW(h_i) + dW(h_j))/2;
    dW the kernel gradient along x_i - x_j."""
    n = pos.shape[0]
    i, j = pairs
    dx, r = pair_geometry(pos, pairs)
    gi = dw_dr_over_r(r, h[i])
    gj = dw_dr_over_r(r, h[j])
    if cfg["grad_p_mode"] == "grad_h":
        coef = prs / (torch.clamp(omega, min=0.1) * rho * rho)
        radial = mass[j] * (coef[i] * gi + coef[j] * gj)
    elif cfg["grad_p_mode"] == "symmetric":
        coef = prs / (rho * rho)
        radial = mass[j] * (coef[i] + coef[j]) * 0.5 * (gi + gj)
    else:
        raise NotImplementedError(f"grad_p_mode={cfg['grad_p_mode']!r}")
    return rho[:, None] * _scatter(n, i, dx * radial[:, None])


def support_reach(h, pad=0.0):
    """Per-particle list reach: the support radius 2h plus `pad`."""
    return KAPPA * h + pad


def gravity_full(pos, h, mass, cfg, pairs):
    """Exact softened gravity over all pairs: the Newtonian sum, then the
    softened law for the listed pairs inside their softening."""
    g, p, _ = all_pairs(pos, mass, cfg["g_const"])
    dg, dp = softening_correction(pos, h, mass, pairs, cfg)
    return g + dg, p + dp


def evaluate(pos, h, mass, cfg, pairs=None):
    """Every field at (pos, h): rho, omega, n_neighbors, pressure, grad_p,
    grad_phi, phi and accel = -grad_p/rho - grad_phi, with `pairs` the
    neighbour list (made here when None)."""
    gphi = phi = None
    if pairs is None:
        gphi, phi, pairs = all_pairs(pos, mass, cfg["g_const"],
                                     reach=support_reach(h))
        dg, dp = softening_correction(pos, h, mass, pairs, cfg)
        gphi, phi = gphi + dg, phi + dp
    else:
        gphi, phi = gravity_full(pos, h, mass, cfg, pairs)
    gphi = com_correct(gphi, mass, cfg)
    rho, omega, nn = density(pos, h, mass, pairs, cfg)
    prs = pressure(rho, cfg)
    gp = pressure_gradient(pos, h, mass, rho, omega, prs, pairs, cfg)
    return dict(rho=rho, omega=omega, n_neighbors=nn, pressure=prs,
                grad_p=gp, grad_phi=gphi, phi=phi,
                accel=-gp / rho[:, None] - gphi)
