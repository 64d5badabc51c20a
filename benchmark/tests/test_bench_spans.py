"""The reduction of the program's spans (``spans.py``) on synthetic
traces: exact counts, host, self and idle times, the idle of the spans and
outside them summing to the window's idle time as ``trace.summarise``
reads it, spans clipped to the window, other threads left out."""

import pytest

from benchmark import spans, trace


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


EVENTS = [
    _ev("bench_window", "user_annotation", 0.0, 100.0),
    _ev("frame_run", "user_annotation", 9.0, 72.0),
    _ev("psph.frame", "user_annotation", 10.0, 70.0),
    _ev("psph.step", "cpu_op", 12.0, 28.0),
    _ev("psph.forces", "cpu_op", 15.0, 20.0),
    _ev("aten::empty", "cpu_op", 16.0, 2.0),
    _ev("psph.kernel.pass2", "cpu_op", 20.0, 5.0),
    _ev("psph.step", "cpu_op", 42.0, 28.0),
    _ev("psph.forces", "user_annotation", 45.0, 15.0),
    _ev("psph.measure", "user_annotation", 85.0, 10.0),
    _ev("psph.frame", "user_annotation", 0.0, 100.0, tid=2),
    _ev("pairwise_pass1_kernel", "kernel", 0.0, 14.0, 7),
    _ev("pass2_kernel", "kernel", 22.0, 8.0, 7),
    _ev("elementwise_kernel", "kernel", 50.0, 5.0, 7),
    _ev("Memcpy DtoH", "gpu_memcpy", 75.0, 15.0, 7),
]
IDLE = [(14.0, 22.0), (30.0, 50.0), (55.0, 75.0), (90.0, 100.0)]
# name: (count, host, self, idle) in us
EXPECTED = {
    "psph.frame": (1, 70.0, 14.0, 7.0),
    "psph.step": (2, 56.0, 21.0, 19.0),
    "psph.forces": (2, 35.0, 30.0, 20.0),
    "psph.kernel.pass2": (1, 5.0, 5.0, 2.0),
    "psph.measure": (1, 10.0, 10.0, 5.0),
}


def test_exact_numbers_of_a_synthetic_trace():
    s = spans.reduce(EVENTS, 0.0, 100.0, 1, IDLE)
    assert set(s["by_name"]) == set(EXPECTED)
    for name, (count, host, self_, idle) in EXPECTED.items():
        r = s["by_name"][name]
        assert r["count"] == count, name
        assert (r["host_s"], r["self_s"], r["idle_s"]) == pytest.approx(
            (host * 1e-6, self_ * 1e-6, idle * 1e-6), abs=1e-15), name
    assert s["outside_s"] == pytest.approx(5e-6, abs=1e-15)
    assert s["program_host_s"] == pytest.approx(80e-6, abs=1e-15)


def test_idle_sums_to_the_windows_idle():
    summary = trace.summarise(EVENTS, "bench_window", [r"^pass2_kernel"])
    s = spans.reduce(EVENTS, 0.0, 100.0, 1, IDLE)
    put_down = sum(r["idle_s"] for r in s["by_name"].values()) \
        + s["outside_s"]
    assert put_down == pytest.approx(
        summary["window_s"] - summary["busy_s"], abs=1e-12)


def test_spans_are_clipped_to_the_window_and_their_parent():
    events = [
        _ev("psph.frame", "user_annotation", -10.0, 40.0),   # [0, 30)
        _ev("psph.step", "user_annotation", 20.0, 30.0),     # cut at 30
        _ev("psph.measure", "user_annotation", 90.0, 20.0),  # [90, 100)
        _ev("psph.build", "user_annotation", 120.0, 5.0),    # outside
    ]
    s = spans.reduce(events, 0.0, 100.0, 1, [(0.0, 100.0)])
    want = {"psph.frame": (1, 30.0, 20.0, 20.0),
            "psph.step": (1, 10.0, 10.0, 10.0),
            "psph.measure": (1, 10.0, 10.0, 10.0)}
    assert set(s["by_name"]) == set(want)
    for name, r in s["by_name"].items():
        got = (r["count"], r["host_s"] * 1e6, r["self_s"] * 1e6,
               r["idle_s"] * 1e6)
        assert got == pytest.approx(want[name]), name
    assert s["outside_s"] * 1e6 == pytest.approx(60.0)
    assert s["program_host_s"] * 1e6 == pytest.approx(40.0)


def test_no_program_span_reads_nothing():
    events = [e for e in EVENTS if not e["name"].startswith("psph.")]
    s = spans.reduce(events, 0.0, 100.0, 1, IDLE)
    assert s["by_name"] == {} and s["program_host_s"] == 0.0
    assert s["outside_s"] == pytest.approx(58e-6)
