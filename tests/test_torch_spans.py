"""The program's spans (``utils/profiling``) on the CPU.

- While no profiler records, a span is one shared null context and makes
  no ``record_function``.
- Under ``utils/profiling.trace`` a tiny ``jupiter_3k`` frame (with the
  frame's diagnostics and a checkpoint) and a tiny ``jupiter_100k`` frame
  of one cached chunk (rebuild, Newton h, RESPA far kicks, the
  centre-of-mass correction) export every span of their layers, each
  inside the span the code opens it in, and leave the state bit for bit
  as an untraced run does.
- A kernel wrapper's span is taken on its CUDA path only.
- The two readers of a trace's spans, ``tools.trace_summary --by-span``
  and the benchmark's ``spans.py``, give the same exact numbers on one
  synthetic trace, and the idle they put down sums to the window's.
"""

import json

import pytest
import torch

from benchmark import spans as bench_spans
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.models import ics, planet
from planetmodel_sph_tpu_torch.ops.cuda import groups2, launch, pairwise
from planetmodel_sph_tpu_torch.tools import trace_summary
from planetmodel_sph_tpu_torch.utils import checkpoint, diagnostics
from planetmodel_sph_tpu_torch.utils import profiling

DENSE = tc.jupiter_3k(n=64)
CACHED = tc.jupiter_100k(n=512, nbr_group_size=32, nbr_group_level=2,
                         radius=20.0, particle_radius=4.0, rebuild_every=4,
                         respa_every=2, sort_every=8)
# each span and the spans it may sit in directly (None: no program span)
NESTING = {
    "dense_frame": {
        "psph.frame": {None}, "psph.step": {"psph.frame"},
        "psph.forces": {"psph.step"}, "psph.eos": {"psph.forces"},
        "psph.measure": {None}, "psph.checkpoint": {None}},
    "cached_chunk": {
        "psph.frame": {None}, "psph.chunk": {"psph.frame"},
        "psph.rebuild": {"psph.chunk"}, "psph.solve_h": {"psph.rebuild"},
        "psph.build": {"psph.rebuild", "psph.solve_h"},
        "psph.permute": {"psph.chunk"}, "psph.step": {"psph.chunk"},
        "psph.forces": {"psph.step"}, "psph.eos": {"psph.forces"},
        "psph.far_kick": {"psph.chunk"},
        "psph.com_correct": {"psph.forces", "psph.far_kick"},
        "psph.measure": {None}, "psph.checkpoint": {None}},
}


def _frame(case, tmp):
    """The case's primed state and a function that runs one frame of it,
    its diagnostics and a checkpoint: (state, diagnostics)."""
    cfg = DENSE if case == "dense_frame" else CACHED
    steps = 2 if case == "dense_frame" else 4
    state = planet.prime(ics.jupiter(cfg, device="cpu"),
                         cfg.replace(rebuild_every=1, respa_every=1))

    def run():
        out, info = planet.run_info(state, cfg, steps)
        d = diagnostics.measure(out, cfg)
        checkpoint.save(str(tmp / "ck.npz"), out, cfg, steps)
        assert int(info["nbr_overflow"]) == 0 == int(info["tree_overflow"])
        return out, d
    return run


@pytest.fixture(scope="module", params=sorted(NESTING))
def traced(request, tmp_path_factory):
    """(case, untraced result, traced result, the trace's events)."""
    tmp = tmp_path_factory.mktemp(request.param)
    run = _frame(request.param, tmp)
    plain = run()
    with profiling.trace(str(tmp / "trace")) as logdir:
        under = run()
    with open(f"{logdir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    return request.param, plain, under, events


def _program_spans(events):
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in trace_summary.HOST_CATS
            and e.get("name", "").startswith(profiling.PREFIX)]


def _innermost_parent(e, spans):
    t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
    around = [p for p in spans if p is not e and p["tid"] == e["tid"]
              and float(p["ts"]) <= t0
              and float(p["ts"]) + float(p["dur"]) >= t1
              and float(p["dur"]) >= float(e["dur"])]
    # the innermost: the shortest, the latest opened of equal ones
    return min(around, key=lambda p: (float(p["dur"]), -float(p["ts"])),
               default=None)


def test_span_is_one_shared_null_context_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"a record function {name!r} with no profiler")
    monkeypatch.setattr(profiling, "_RECORD", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert profiling.span(profiling.FRAME) is profiling.span(profiling.STEP)
    with profiling.span(profiling.FORCES):
        pass
    add_one = profiling.spanned(profiling.EOS)(lambda x: x + 1)
    assert add_one(torch.ones(2)).tolist() == [2.0, 2.0]


def test_span_records_under_a_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ctx = profiling.span(profiling.FRAME)
        assert ctx is not profiling.span(profiling.FRAME)
        with ctx:
            pass
    assert profiling.span(profiling.FRAME) is profiling.span(profiling.STEP)
    assert [e.key for e in prof.key_averages()].count(profiling.FRAME) == 1


def test_every_span_of_the_layers_is_exported(traced):
    case, _, _, events = traced
    names = {e["name"] for e in _program_spans(events)}
    assert names == set(NESTING[case])


def test_spans_nest_as_the_code_opens_them(traced):
    case, _, _, events = traced
    spans = _program_spans(events)
    for e in spans:
        parent = _innermost_parent(e, spans)
        got = parent["name"] if parent is not None else None
        assert got in NESTING[case][e["name"]], (e["name"], got)


def test_spans_count_the_work(traced):
    case, _, _, events = traced
    count = {}
    for e in _program_spans(events):
        count[e["name"]] = count.get(e["name"], 0) + 1
    if case == "dense_frame":
        assert count["psph.step"] == 2 == count["psph.forces"]
    else:
        # one chunk of 4 steps, RESPA every 2: a far kick to seed the
        # chunk and one a period; the sorted layout in and out
        assert count["psph.rebuild"] == 1 == count["psph.chunk"]
        assert count["psph.step"] == 4 == count["psph.forces"]
        assert count["psph.far_kick"] == 3
        assert count["psph.permute"] == 2


def test_profiler_leaves_the_bits(traced):
    _, (out, d), (out_t, d_t), _ = traced
    for k, v in vars(out).items():
        if isinstance(v, torch.Tensor):
            got = getattr(out_t, k).numpy().tobytes()
            assert v.numpy().tobytes() == got, k
    for k, v in d.items():
        assert v.numpy().tobytes() == d_t[k].numpy().tobytes(), k


def test_by_span_reads_the_real_trace(traced):
    case, _, _, events = traced
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans, outside, program = trace_summary.by_span(complete)
    assert set(spans) == set(NESTING[case])
    assert spans["psph.frame"]["count"] == 1
    assert all(r["self_us"] <= r["host_us"] + 1e-6 for r in spans.values())
    _, _, busy, window = trace_summary.summarise(complete)
    assert 0.0 < program <= window
    assert sum(r["idle_us"] for r in spans.values()) + outside == \
        pytest.approx(window - busy, abs=1.0)


@pytest.mark.parametrize("module, wrapper, name", [
    *[(groups2, k, k) for k in groups2.KERNELS],
    (pairwise, "pass1", "pairwise_pass1"),
    (pairwise, "pass2", "pairwise_pass2")])
def test_kernel_wrappers_span_their_cuda_path(module, wrapper, name):
    fn = getattr(module, wrapper)
    assert launch.SPANS[name] == "psph.kernel." + name
    seen = []

    class Card:                    # a first argument that says it is CUDA
        is_cuda = True

    probe = launch.spanned(name)(lambda first: seen.append(first))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        probe(Card())
        probe(torch.zeros(1))                      # the plain path
    names = [e.key for e in prof.key_averages()]
    assert names.count(launch.SPANS[name]) == 1 and len(seen) == 2
    # the wrapper itself is the decorated one
    assert fn.__wrapped__.__name__ == wrapper


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


# a window of 100 us on thread 1: frame [10, 80) with two steps, a kernel
# wrapper in the first step's forces, measure [85, 95) (spans of both
# categories); device busy [0, 14), [22, 30), [50, 55), [75, 90): idle
# 58 us
SYNTHETIC = [
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
    _ev("psph.frame", "user_annotation", 0.0, 100.0, tid=2),  # not ours
    _ev("pairwise_pass1_kernel", "kernel", 0.0, 14.0, 7),
    _ev("pass2_kernel", "kernel", 22.0, 8.0, 7),
    _ev("elementwise_kernel", "kernel", 50.0, 5.0, 7),
    _ev("Memcpy DtoH", "gpu_memcpy", 75.0, 15.0, 7),
]
# name: (count, host, self, idle) in us
EXPECTED = {
    "psph.frame": (1, 70.0, 14.0, 7.0),
    "psph.step": (2, 56.0, 21.0, 19.0),
    "psph.forces": (2, 35.0, 30.0, 20.0),
    "psph.kernel.pass2": (1, 5.0, 5.0, 2.0),
    "psph.measure": (1, 10.0, 10.0, 5.0),
}
OUTSIDE, PROGRAM, IDLE = 5.0, 80.0, 58.0


def _read(reader, tmp_path):
    """(table {name: (count, host, self, idle) us}, outside us, program
    us) by the reader `reader`."""
    if reader == "tool":
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"traceEvents": SYNTHETIC}))
        spans, outside, program = trace_summary.by_span(
            trace_summary.load(str(path)))
        return ({k: (r["count"], r["host_us"], r["self_us"], r["idle_us"])
                 for k, r in spans.items()}, outside, program)
    idle = [(14.0, 22.0), (30.0, 50.0), (55.0, 75.0), (90.0, 100.0)]
    s = bench_spans.reduce(SYNTHETIC, 0.0, 100.0, 1, idle)
    return ({k: (r["count"], r["host_s"] * 1e6, r["self_s"] * 1e6,
                 r["idle_s"] * 1e6) for k, r in s["by_name"].items()},
            s["outside_s"] * 1e6, s["program_host_s"] * 1e6)


@pytest.mark.parametrize("reader", ["tool", "benchmark"])
def test_span_table_of_a_synthetic_trace(reader, tmp_path):
    table, outside, program = _read(reader, tmp_path)
    assert set(table) == set(EXPECTED)
    for name, want in EXPECTED.items():
        assert table[name][0] == want[0], name
        assert table[name][1:] == pytest.approx(want[1:], abs=1e-9), name
    assert outside == pytest.approx(OUTSIDE, abs=1e-9)
    assert program == pytest.approx(PROGRAM, abs=1e-9)
    # the idle put down to the spans and outside them is the window's
    assert sum(r[3] for r in table.values()) + outside == \
        pytest.approx(IDLE, abs=1e-6)


def test_by_span_prints_the_table(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": SYNTHETIC}))
    assert trace_summary.main([str(path), "--by-span"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = {ln.split()[-1]: ln.split()[:4] for ln in out
            if ln.split() and ln.split()[-1].startswith("psph.")}
    assert rows["psph.step"] == ["2", "0.056", "0.021", "0.019"]
    assert rows["psph.forces"] == ["2", "0.035", "0.030", "0.020"]
    assert any("device idle outside the program's spans 0.005 ms" in ln
               and "hold 0.080 ms" in ln for ln in out)
    assert any(ln.startswith("device idle 58.0% of the traced window")
               for ln in out)


def test_a_trace_without_program_spans():
    events = [e for e in SYNTHETIC if not e["name"].startswith("psph.")]
    spans, outside, program = trace_summary.by_span(events)
    assert spans == {} and program == 0.0
    assert outside == pytest.approx(IDLE)
    s = bench_spans.reduce(events, 0.0, 100.0, 1, [(14.0, 22.0),
                                                   (30.0, 50.0),
                                                   (55.0, 75.0),
                                                   (90.0, 100.0)])
    assert s["by_name"] == {} and s["program_host_s"] == 0.0
    assert s["outside_s"] == pytest.approx(IDLE * 1e-6)
