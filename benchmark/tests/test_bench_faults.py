"""The comparison refuses the timed path broken underneath, and the
control: a run driven through the harness (its look for a card skipped)
on the tiny cells, with the program replaced by a faulty wrapper or by the
plain reference computed in bfloat16."""

import pytest
import torch

from benchmark import run
from benchmark.program import Program
from benchmark.reference.system import ReferenceSystem


class Faulty:
    """The program with one fault planted in its frame."""

    def __init__(self, inner, fault):
        self.inner, self.fault = inner, fault

    def start(self, inputs):
        return self.inner.start(inputs)

    def read(self, state, info):
        return self.inner.read(state, info)

    def fields(self, state):
        return self.inner.fields(state)

    def frame(self, state, steps):
        out, info = self.inner.frame(state, steps)
        if self.fault == "unchanged":
            return state, info
        n = state.pos.shape[0]
        if self.fault == "half_left_out":
            # the second half of the particles is not advanced
            keep = {k: torch.cat([v[: n // 2], getattr(state, k)[n // 2:]])
                    for k, v in Program.fields(out).items()}
            return out.replace(**keep), info
        if self.fault == "answer_altered":
            pos = out.pos.clone()
            pos[n // 3] += out.h[n // 3]
            return out.replace(pos=pos), info
        raise ValueError(self.fault)


def _run(cell, system, seconds):
    result = run.run(cell, 2**31 + 77, seconds, False, "cpu", system=system)
    return result, result["checks"]


def test_dense_sound_run_is_correct(tiny):
    cell = tiny("tiny_dense")
    result, checks = _run(cell, None, 0.5)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out",
                                   "answer_altered"])
def test_dense_fault_is_refused(tiny, fault):
    cell = tiny("tiny_dense")
    result, checks = _run(cell, Faulty(Program(cell.config), fault), 0.5)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in checks.values())


def test_dense_control_is_refused(tiny):
    cell = tiny("tiny_dense")
    ctl = ReferenceSystem(cell.config, cell.reference(), torch.bfloat16)
    result, checks = _run(cell, ctl, 0.5)
    assert not result["correct"]
    failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert "start_rho" in failed and "end_rho" in failed, checks


def test_grid_sound_run_is_correct(tiny):
    cell = tiny("tiny_prod")
    result, checks = _run(cell, None, 0.01)
    assert result["correct"], checks


def test_grid_unchanged_state_is_refused(tiny):
    cell = tiny("tiny_prod")
    result, checks = _run(cell, Faulty(Program(cell.config), "unchanged"),
                          0.01)
    assert not result["correct"]
    assert checks["frame_pos"]["value"] > checks["frame_pos"]["limit"]
