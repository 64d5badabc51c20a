"""The end-to-end statistics over all frames and the trace reduction."""

import json

import pytest
import torch

from benchmark import run, trace, traffic


def test_rate_counts_every_frame_over_the_wall():
    assert run.rate(frames=50, steps=64, n=100_000, wall_s=16.0) == \
        pytest.approx(50 * 64 * 100_000 / 16.0)


def test_p95_is_over_all_frames():
    frames = [0.02] * 95 + [0.05] * 5
    assert run.percentile(frames, 95) == pytest.approx(0.02 + 0.03 * 0.05,
                                                       rel=1e-9)
    assert run.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_sampler_keeps_a_seeded_uniform_frame():
    picks = []
    for seed in range(400):
        s = run.Sampler(seed)
        for i in range(10):
            s.offer(i)
        picks.append(s.kept)
    assert set(picks) == set(range(10))
    again = run.Sampler(7)
    for i in range(10):
        again.offer(i)
    first = run.Sampler(7)
    for i in range(10):
        first.offer(i)
    assert again.kept == first.kept


class Counter:
    """A system whose state is the number of frames run since the start;
    records the state each frame starts from."""

    def __init__(self):
        self.starts = []

    def frame(self, state, steps):
        self.starts.append(state)
        return state + 1, {}

    def read(self, state, info):
        return {"nbr_overflow": 0, "tree_overflow": 0, "total_energy": 0.0}

    def fields(self, state):
        return state


def test_window_returns_to_the_start_every_cycle():
    sys = Counter()
    w = run.Window(sys, 0, steps=1, cycle=3, sync=lambda: None)
    assert w.run(frames=7) == 1
    assert sys.starts == [0, 1, 2, 0, 1, 2, 0]


def test_timed_window_ends_on_a_whole_cycle():
    sys = Counter()
    w = run.Window(sys, 0, steps=1, cycle=4, sync=lambda: None)
    assert w.run(seconds=0.0) == 4
    assert len(w.frame_s) == len(w.call_s) == 4 and w.wall_s > 0


def test_program_repeats_its_cycle_bit_for_bit(tiny):
    """A cycle run twice ends where one ends: the program leaves the start
    state it is handed as it was."""
    from benchmark.program import Program
    cell = tiny("tiny_dense")
    cfg = cell.config["config"]
    system = Program(cell.config)
    start = system.start(traffic.make_inputs(cell.traffic, cfg, 9, "cpu",
                                             cell.root))
    once = run.Window(system, start, 2, 2, lambda: None).run(frames=2)
    twice = run.Window(system, start, 2, 2, lambda: None).run(frames=4)
    for k, v in system.fields(once).items():
        assert torch.equal(v, system.fields(twice)[k]), k


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def test_idle_share_and_gaps_from_a_synthetic_trace(tmp_path):
    events = [
        _ev("bench_window", "user_annotation", 0.0, 100.0),
        _ev("aten::index", "cpu_op", 10.0, 20.0),
        _ev("run_info", "user_annotation", 40.0, 50.0),
        _ev("void pass2_kernel<0, false>(float*)", "kernel", 0.0, 10.0, 7),
        _ev("elementwise_kernel", "kernel", 30.0, 10.0, 7),
        _ev("Memcpy DtoH", "gpu_memcpy", 90.0, 20.0, 7),   # clipped at 100
        _ev("outside", "kernel", 150.0, 10.0, 7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace.summarise(trace.load(str(path)), "bench_window",
                        [r"^pass2_kernel"])
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["by_category"][trace.HAND] == pytest.approx(10e-6)
    assert s["by_category"]["elementwise"] == pytest.approx(10e-6)
    assert s["by_category"]["memcpy and memset"] == pytest.approx(10e-6)
    # gaps 10-30 (inside aten::index), 40-90 (inside run_info)
    assert s["gaps"] == pytest.approx({"aten::index": 20e-6,
                                       "run_info": 50e-6})
    assert trace.top(s["by_op"], 1)[0][0] in ("pass2_kernel",
                                              "elementwise_kernel",
                                              "Memcpy DtoH")
