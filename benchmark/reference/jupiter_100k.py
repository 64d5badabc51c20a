"""Plain reference of the ``jupiter_100k`` configuration: the production
step of a settled 100k-particle Jupiter.

Written from the configuration's keys (``configs/jupiter_100k.json``):
grad-h SPH with the bounded Newton solve of h = eta (m/rho)^(1/3) at each
rebuild (every `rebuild_every` steps, warm-started from the state's
density, h clamped to [h/(1+c), h(1+c)]), h tracked each step inside
[h_rb/(1+margin), h_rb(1+margin)], leapfrog KDK at fixed dt, and
impulse-RESPA: the far gravity is a kick of `respa_every` dt/2 at each end
of a period, the near gravity and the pressure force act every step.

Where the program draws the line between near and far by its tree, this
reference draws it by its neighbour list (the pairs inside twice the
tracked support plus a skin), and takes both parts exactly: the far part
is the exact sum over every other pair, not multipoles. So the two differ
by the tree's approximation and by where the split lies, both far below
what a lost step or a wrong sum would move.
"""

from __future__ import annotations

import torch

from benchmark.reference import sph

# the list's skin: this many times the largest distance a particle's
# velocity and acceleration at the rebuild carry it over the chunk
SKIN_SAFETY = 3.0


def newton_h(pos, h, mass, cfg, rho0=None):
    """The bounded fixed-point solve of h = eta (m/rho(h))^(1/3)."""
    c = cfg["h_newton_clamp"]
    hmax = cfg["h_max"]
    eta = sph.h_eta(cfg)
    if hmax > 0.0:
        h = torch.clamp(h, max=hmax)
    if rho0 is not None:
        hw = eta * (mass / torch.clamp(rho0, min=1e-30)) ** (1.0 / 3.0)
        h = torch.minimum(torch.maximum(hw, h / (1.0 + c)), h * (1.0 + c))
        if hmax > 0.0:
            h = torch.clamp(h, max=hmax)
    lo, hi = h / (1.0 + c), h * (1.0 + c)
    if hmax > 0.0:
        hi = torch.clamp(hi, max=hmax)
    _, _, pairs = sph.all_pairs(pos, mass, cfg["g_const"],
                                reach=sph.support_reach(hi), gravity=False)
    iters = max(1, cfg["h_newton_iters"] - (1 if rho0 is not None else 0))
    ht = h
    for _ in range(iters):
        rho, _, _ = sph.density(pos, ht, mass, pairs, cfg)
        ht = torch.minimum(torch.maximum(
            eta * (mass / rho) ** (1.0 / 3.0), lo), hi)
    return ht


def start(inputs, cfg):
    """The set-up's force evaluation: the Newton solve from the inputs' h,
    then every field at the solved h."""
    pos, mass = inputs["pos"], inputs["mass"]
    h = newton_h(pos, inputs["h"], mass, cfg)
    return dict(sph.evaluate(pos, h, mass, cfg), pos=pos, vel=inputs["vel"],
                mass=mass, h=h)


def _far(pos, mass, pairs, cfg):
    """The Newtonian gravity of every pair off the list (all of them lie
    outside their softening): the all-pairs sum less the listed pairs'."""
    g, p, _ = sph.all_pairs(pos, mass, cfg["g_const"])
    i, j = pairs
    dx, r = sph.pair_geometry(pos, pairs)
    gn, pn = sph.newton_pair(dx, r, mass[j])
    gc = cfg["g_const"]
    g = g - gc * sph._scatter(pos.shape[0], i, gn)
    p = p - gc * sph._scatter(pos.shape[0], i, pn)
    return sph.com_correct(g, mass, cfg), p


def _chunk(s, cfg, k):
    """One rebuild period of k steps from the state dict `s` (which holds
    rho and the full accel at its positions)."""
    dt = cfg["dt"]
    m_respa = cfg["respa_every"]
    if m_respa <= 1 or k % m_respa:
        raise NotImplementedError("this reference runs RESPA periods that "
                                  "divide the chunk")
    margin = cfg["h_track_margin"]
    hmax = cfg["h_max"]
    eta = sph.h_eta(cfg)
    x, v, m = s["pos"], s["vel"], s["mass"]
    h = newton_h(x, s["h"], m, cfg, rho0=s["rho"])
    t = k * dt
    speed = torch.sqrt((v * v).sum(dim=-1))
    acc = torch.sqrt((s["accel"] * s["accel"]).sum(dim=-1))
    skin = SKIN_SAFETY * float((speed * t + 0.5 * acc * t * t).max())
    reach = sph.support_reach(h * (1.0 + margin), pad=2.0 * skin)
    _, _, pairs = sph.all_pairs(x, m, cfg["g_const"], reach=reach,
                                gravity=False)
    x_rb = x
    gf, pf = _far(x, m, pairs, cfg)
    a = s["accel"] + gf
    rho = s["rho"]
    lo = h / (1.0 + margin)
    hi = h * (1.0 + margin)
    if hmax > 0.0:
        hi = torch.clamp(hi, max=hmax)
    for _ in range(k // m_respa):
        v = v - (0.5 * m_respa * dt) * gf
        for _ in range(m_respa):
            h = torch.minimum(torch.maximum(
                eta * (m / torch.clamp(rho, min=1e-30)) ** (1.0 / 3.0), lo),
                hi)
            vh = v + (0.5 * dt) * a
            x = x + dt * vh
            moved = torch.sqrt(((x - x_rb) ** 2).sum(dim=-1)).max()
            if float(moved) > skin:
                # a particle outran the skin: list the pairs anew (exact
                # sums; the far kicks keep the split they started with)
                _, _, pairs = sph.all_pairs(x, m, cfg["g_const"],
                                            reach=reach, gravity=False)
                x_rb = x
            rho, omega, nn = sph.density(x, h, m, pairs, cfg)
            prs = sph.pressure(rho, cfg)
            gp = sph.pressure_gradient(x, h, m, rho, omega, prs, pairs, cfg)
            gn, pn = sph.pair_gravity(x, h, m, pairs, cfg)
            gn = sph.com_correct(gn, m, cfg)
            a = -gp / rho[:, None] - gn
            v = vh + (0.5 * dt) * a
        gf, pf = _far(x, m, pairs, cfg)
        v = v - (0.5 * m_respa * dt) * gf
    return dict(pos=x, vel=v, mass=m, h=h, rho=rho, omega=omega,
                n_neighbors=nn, pressure=prs, grad_p=gp, grad_phi=gn + gf,
                phi=pn + pf, accel=a - gf)


def frame(state, cfg, steps):
    """`steps` steps from the state's positions, velocities, masses and
    smoothing lengths; the fields it starts from are evaluated here."""
    k = cfg["rebuild_every"]
    if steps % k:
        raise NotImplementedError("frames of whole rebuild periods only")
    pos, h, mass = state["pos"], state["h"], state["mass"]
    s = dict(sph.evaluate(pos, h, mass, cfg), pos=pos, vel=state["vel"],
             mass=mass, h=h)
    for _ in range(steps // k):
        s = _chunk(s, cfg, k)
    return s
