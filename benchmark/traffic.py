"""The one generator of every cell's inputs, driven by a traffic file.

A traffic file (``workloads/<traffic>.json``) names the kind of inputs and
its parameters; the cell's configuration gives the sizes. Two kinds:

- ``settled_state``: a PSPH1 snapshot of the repository (pinned by its
  SHA-256), turned by a uniform random rotation about its centre of mass
  drawn from the seed;
- ``cold_ball``: the Jupiter scene's initial conditions (n particles
  uniform in a ball of the configuration's radius, at rest, equal masses,
  support radius particle_radius (1 + U[0, 0.5))), drawn on the device by
  a ``torch.Generator`` seeded with the seed.

Either gives the same {pos, vel, mass, h} tensors, in the configuration's
dtype on the given device, to the program and to the reference.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from . import psph


def _seed64(seed: int) -> int:
    return int(seed) % (1 << 63)


def rotation(seed: int) -> np.ndarray:
    """A rotation matrix uniform over SO(3): a normalised Gaussian
    quaternion from the seed."""
    q = np.random.default_rng(_seed64(seed)).normal(size=4)
    a, b, c, d = q / np.linalg.norm(q)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
         2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a - b * b + c * c - d * d,
         2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b),
         a * a - b * b - c * c + d * d]])


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _settled_state(spec, cfg, seed, device, root):
    path = os.path.join(root, spec["file"])
    if sha256(path) != spec["sha256"]:
        raise ValueError(f"{spec['file']}: not the state this traffic was "
                         "written for (SHA-256 differs)")
    header, arrays = psph.read(path)
    stored = header["config"]
    pos = arrays["pos"].astype(np.float64)
    vel = arrays["vel"].astype(np.float64)
    mass = arrays["mass"].astype(np.float64)
    h = arrays["h"].astype(np.float64)
    com = (mass[:, None] * pos).sum(axis=0) / mass.sum()
    diff = sorted(k for k in set(stored) | set(cfg)
                  if stored.get(k) != cfg.get(k))
    if diff:
        raise ValueError(f"{spec['file']} was written under another "
                         f"configuration: {diff}")
    rot = rotation(seed)
    pos = com + (pos - com) @ rot.T
    vel = vel @ rot.T
    dt = getattr(torch, cfg["dtype"])
    to = lambda a: torch.from_numpy(a).to(dtype=dt, device=device)
    return {"pos": to(pos), "vel": to(vel), "mass": to(mass), "h": to(h)}


def _cold_ball(spec, cfg, seed, device, root):
    n = cfg["n"]
    dt = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed64(seed))
    radius = cfg["radius"]
    # uniform in the bounding cube, the first n points inside the ball
    # (4n + 64 draws leave a shortfall with probability < 1e-40)
    pts = (torch.rand((4 * n + 64, 3), generator=gen, dtype=dt,
                      device=device) * 2.0 - 1.0) * radius
    inside = torch.nonzero((pts * pts).sum(dim=-1) < radius * radius)[:, 0]
    if inside.shape[0] < n:
        raise RuntimeError("the ball's rejection sampling fell short")
    pos = pts[inside[:n]]
    kh = cfg["particle_radius"] * (1.0 + 0.5 * torch.rand(
        (n,), generator=gen, dtype=dt, device=device))
    return {"pos": pos.contiguous(),
            "vel": torch.zeros((n, 3), dtype=dt, device=device),
            "mass": torch.full((n,), cfg["total_mass"] / n, dtype=dt,
                               device=device),
            "h": kh / cfg["kappa"]}


KINDS = {"settled_state": _settled_state, "cold_ball": _cold_ball}


def make_inputs(traffic: dict, cfg: dict, seed: int, device, root: str):
    """The cell's inputs from its traffic file's ``inputs`` and its
    configuration dict `cfg` (every key of the program's configuration as
    run)."""
    spec = traffic["inputs"]
    return KINDS[spec["kind"]](spec, cfg, seed, device, root)
