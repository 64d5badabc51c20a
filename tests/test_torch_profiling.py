"""The port's profiling helpers (``planetmodel_sph_tpu_torch/utils/
profiling.py``) on the CPU: ``steps_per_sec`` times the run it is given
after a warm-up from the same state, and ``trace`` writes a Chrome trace
of the block."""

import json
import os

from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.models import ics, planet
from planetmodel_sph_tpu_torch.utils import profiling

CFG = tc.jupiter_3k(n=64)


def test_steps_per_sec_times_the_run():
    state = planet.prime(ics.jupiter(CFG, device="cpu"), CFG)
    calls = []

    def run(s, k):
        calls.append((s is state, k))
        return planet.run(s, CFG, k)

    sps, out = profiling.steps_per_sec(run, state, 3, warmup=2)
    assert calls == [(True, 2), (True, 3)] and sps > 0
    ref = planet.run(state, CFG, 3)
    assert bool((out.pos == ref.pos).all())


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "tr")
    with profiling.trace(logdir) as d:
        assert d == logdir
        planet.prime(ics.jupiter(CFG, device="cpu"), CFG)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
