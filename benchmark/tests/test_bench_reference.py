"""The plain reference against the program's plain path at a tiny n on
the CPU: the set-up's fields and one frame."""

import torch

from benchmark import check
from benchmark.program import Program
from benchmark.reference import sph


def _fields(system, state):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in system.fields(state).items()}


def test_dense_start_and_frame_agree_to_rounding(tiny):
    cell = tiny("tiny_dense")
    cfg = cell.config["config"]
    ref = cell.reference()
    from benchmark import traffic
    inputs = traffic.make_inputs(cell.traffic, cfg, 3, "cpu", cell.root)
    prog = Program(cell.config)
    s0 = prog.start(inputs)
    r0 = ref.start({k: v.double() for k, v in inputs.items()}, cfg)
    gaps = check.field_gaps(_fields(prog, s0), r0, "")
    assert gaps["nn"] == 0
    assert max(v for k, v in gaps.items() if k != "nn") < 1e-4, gaps
    s1, _ = prog.frame(s0, 10)
    r1 = ref.frame(_fields(prog, s0), cfg, 10)
    f1 = _fields(prog, s1)
    moved = torch.sqrt(((r1["pos"] - s0.pos.double()) ** 2).sum(-1))
    gap = torch.sqrt(((f1["pos"] - r1["pos"]) ** 2).sum(-1)).max()
    assert float(gap / moved.median()) < 0.1
    assert float(((f1["h"] - r1["h"]).abs() / r1["h"]).max()) < 1e-5
    e = sph.evaluate(f1["pos"], f1["h"], f1["mass"], cfg)
    gaps = check.field_gaps(f1, e, "")
    assert gaps["nn"] == 0
    assert max(v for k, v in gaps.items() if k != "nn") < 1e-4, gaps


def test_grid_start_agrees(tiny):
    """The production configuration's set-up: the Newton h-solve and the
    fields at it; gravity within the tree's approximation."""
    cell = tiny("tiny_prod")
    cfg = cell.config["config"]
    from benchmark import traffic
    inputs = traffic.make_inputs(cell.traffic, cfg, 4, "cpu", cell.root)
    prog = Program(cell.config)
    s0 = _fields(prog, prog.start(inputs))
    r0 = cell.reference().start({k: v.double() for k, v in inputs.items()},
                                cfg)
    assert float(((s0["h"] - r0["h"]).abs() / r0["h"]).max()) < 1e-5
    gaps = check.field_gaps(s0, r0, "")
    assert gaps["nn"] == 0
    assert gaps["rho"] < 1e-5 and gaps["gradp"] < 1e-4, gaps
    assert gaps["grav"] < 3e-2 and gaps["phi"] < 3e-3, gaps
