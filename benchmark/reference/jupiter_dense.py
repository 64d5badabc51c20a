"""Plain reference of the ``jupiter_dense`` configuration: the Jupiter v1
scene on the exact path.

Written from the configuration's keys (``configs/jupiter_dense.json``):
every step is leapfrog KDK at fixed dt with every field evaluated afresh:
h relaxed by h <- h (1 + (target/N)^(1/3)) / 2 from the previous step's
neighbour count N (kept where N = 0), the symmetric density sum_j m_j
(W(h_i) + W(h_j))/2, the polytropic pressure, the symmetric pressure force
and exact all-pairs softened gravity.
"""

from __future__ import annotations

import torch

from benchmark.reference import sph


def relax_h(h, nn, cfg):
    if not cfg["adaptive_h"]:
        return h
    nnf = nn.to(h.dtype)
    ratio = (cfg["target_neighbors"] / torch.where(nnf > 0, nnf, 1.0)) \
        ** (1.0 / 3.0)
    out = torch.where(nn > 0, h * 0.5 * (1.0 + ratio), h)
    if cfg["h_max"] > 0.0:
        out = torch.clamp(out, max=cfg["h_max"])
    return out


def start(inputs, cfg):
    """The set-up's force evaluation at the inputs' h."""
    pos, h, mass = inputs["pos"], inputs["h"], inputs["mass"]
    return dict(sph.evaluate(pos, h, mass, cfg), pos=pos, vel=inputs["vel"],
                mass=mass, h=h)


def frame(state, cfg, steps):
    """`steps` steps from the state's positions, velocities, masses and
    smoothing lengths; the fields it starts from are evaluated here."""
    if cfg["integrator"] != "leapfrog_kdk" or cfg["dt_mode"] != "fixed":
        raise NotImplementedError("leapfrog KDK at a fixed dt only")
    dt = cfg["dt"]
    x, v, h, m = state["pos"], state["vel"], state["h"], state["mass"]
    f = sph.evaluate(x, h, m, cfg)
    for _ in range(steps):
        vh = v + (0.5 * dt) * f["accel"]
        x = x + dt * vh
        h = relax_h(h, f["n_neighbors"], cfg)
        f = sph.evaluate(x, h, m, cfg)
        v = vh + (0.5 * dt) * f["accel"]
    return dict(f, pos=x, vel=v, mass=m, h=h)
