"""The comparison that decides ``correct``: what the timed path produced,
against the configuration's plain reference in float64.

Three parts, each a few numbers (the larger, the worse):

- ``start_*``: the set-up's state (the inputs primed by one force
  evaluation at their h) against the reference's own set-up from the
  same inputs;
- ``frame_*``: one frame of the window, drawn from the seed, followed by
  the reference from the program's state at the frame's start (positions,
  velocities, masses, smoothing lengths; every force it evaluates
  itself): positions, velocities and h at the frame's end;
- ``end_*``: the fields of the window's last state against the
  reference's evaluation at its positions and smoothing lengths;

A frame whose structure overflow counters are not zero (interactions
the program dropped) or whose energy is not finite is a failed frame
(``run.Window``); a run with one is not correct either.

Field gaps: density and h relative per particle; the neighbour count in
counts; pressure acceleration (grad P / rho), gravity (grad phi) and
potential over the median magnitude of the reference's; a frame's
positions and velocities over the median distance the reference moved
them in the frame. Each is the largest over all particles.
"""

from __future__ import annotations

import math

import torch

from .reference import sph

F64 = torch.float64


def _f64(fields: dict) -> dict:
    return {k: (v.to(F64) if v.is_floating_point() else v)
            for k, v in fields.items()}


def _norm(x):
    return torch.sqrt((x * x).sum(dim=-1))


def _rel(p, r):
    return float(((p - r).abs() / r.abs()).max())


def _vec(p, r, scale):
    return float(_norm(p - r).max() / scale)


def _scalar(p, r):
    return float((p - r).abs().max() / r.abs().median())


def _finite(v: float) -> float:
    """A NaN compares false against any limit: report it as infinite."""
    return v if math.isfinite(v) else math.inf


def field_gaps(prog: dict, ref: dict, prefix: str) -> dict:
    pa = prog["grad_p"] / prog["rho"][:, None]
    ra = ref["grad_p"] / ref["rho"][:, None]
    return {
        prefix + "rho": _rel(prog["rho"], ref["rho"]),
        prefix + "nn": float((prog["n_neighbors"].to(torch.int64)
                              - ref["n_neighbors"].to(torch.int64)
                              ).abs().max()),
        prefix + "gradp": _vec(pa, ra, _norm(ra).median()),
        prefix + "grav": _vec(prog["grad_phi"], ref["grad_phi"],
                              _norm(ref["grad_phi"]).median()),
        prefix + "phi": _scalar(prog["phi"], ref["phi"]),
    }


def judge(ref_mod, cfg: dict, inputs: dict, start: dict, frame: tuple,
          end: dict, steps: int) -> tuple[dict, int]:
    """The compared numbers, and the reference's neighbour pairs at the
    last state (the work count of the roofline). `start` and `end` are the
    program's fields at set-up and after the window; `frame` (fields at a
    frame's start, fields at its end)."""
    inputs = _f64(inputs)
    nums = {}
    ref0 = ref_mod.start(inputs, cfg)
    nums.update(field_gaps(_f64(start), ref0, "start_"))
    del ref0
    s_in, s_out = _f64(frame[0]), _f64(frame[1])
    r = ref_mod.frame(s_in, cfg, steps)
    moved = _norm(r["pos"] - s_in["pos"]).median()
    kicked = _norm(r["vel"] - s_in["vel"]).median()
    nums.update(frame_pos=_vec(s_out["pos"], r["pos"], moved),
                frame_vel=_vec(s_out["vel"], r["vel"], kicked),
                frame_h=_rel(s_out["h"], r["h"]))
    del r, s_in, s_out
    se = _f64(end)
    re = sph.evaluate(se["pos"], se["h"], se["mass"], cfg)
    nums.update(field_gaps(se, re, "end_"))
    pairs = int(re["n_neighbors"].sum())
    return {k: _finite(v) for k, v in nums.items()}, pairs


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct when every number
    has a limit and none exceeds it."""
    out = {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in out.values())
    return ok, out
