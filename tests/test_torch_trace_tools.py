"""The port's trace and stage tools on the CPU: ``tools.profile_block``
prints every stage label of the reference's ``tools/profile_block.py``
(read from its source text, never imported: it imports JAX) with a finite
checksum; ``tools.trace_summary`` on a synthetic Chrome trace gives exact
totals, order, categories, sources and idle share, its categories summing
to the total; ``tools.trace_run`` traces a tiny chunk and summarises it.
No device time is measured here."""

import json
import math
import os
import re

import pytest

from planetmodel_sph_tpu_torch.tools import (profile_block, trace_run,
                                             trace_summary)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--n", "1024", "--k", "1", "--windows",
        "8,32,32"]


def _reference_labels():
    src = open(os.path.join(ROOT, "tools", "profile_block.py")).read()
    return re.findall(r'timed\("([^"]+)"', src)


def test_profile_block_prints_every_reference_stage(capsys):
    labels = _reference_labels()
    assert len(labels) == 10
    assert profile_block.main(TINY) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("n=1024  bsz=64  W=8 Wp=32  chunk=512")
    assert lines[1].startswith("groups=") and "accept frac=" in lines[1]
    for label in labels:
        (line,) = [ln for ln in lines if ln.startswith(label + " ")]
        ms, checksum = re.search(r"([\d.]+) ms\s+\(checksum (\S+)\)",
                                 line).groups()
        assert float(ms) >= 0 and math.isfinite(float(checksum)), line


def test_profile_block_only_filters_stages(capsys):
    assert profile_block.main(TINY + ["--only", "pass1,unsort"]) == 0
    out = capsys.readouterr().out
    assert "pass1 kernel" in out and "unsort (inverse" in out
    assert "forces (full)" not in out and "p2p kernel" not in out


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=0, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# a forces frame launching pass2 through its wrapper (ops/cuda: skipped
# for the source) and an index kernel; device ops on stream 7, the first
# two overlapping
SYNTH = [
    _ev("planetmodel_sph_tpu_torch/ops/structure.py(853): forces",
        "python_function", 0, 100),
    _ev("planetmodel_sph_tpu_torch/ops/cuda/groups2.py(560): pass2",
        "python_function", 10, 20),
    _ev("cudaLaunchKernel", "cuda_runtime", 15, 2, corr=7),
    _ev("cudaLaunchKernel", "cuda_runtime", 40, 2, corr=8),
    _ev("aten::index", "cpu_op", 39, 5),
    _ev("void pass2_kernel<true>(Pass2Args)", "kernel", 20, 30, 7, 7),
    _ev("void at::native::index_elementwise_kernel<128, 4>(int)",
        "kernel", 45, 10, 7, 8),
    _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 60, 5, 7),
    _ev("void at::native::vectorized_elementwise_kernel<4>(int)",
        "kernel", 70, 3, 7),
    _ev("void at::native::vectorized_elementwise_kernel<4>(int)",
        "kernel", 80, 3, 7),
    _ev("void cub::DeviceRadixSortOnesweepKernel<int>(int)", "kernel",
        120, 2, 7),
    _ev("void at::native::reduce_kernel<512, 1>(int)", "kernel", 130, 7, 7),
    _ev("void (anonymous namespace)::CatArrayBatchedCopy<float>(int)",
        "kernel", 48, 4, 8),
    _ev("ncclDevKernel_AllReduce(int)", "kernel", 140, 1, 7),
    dict(ph="M", name="process_name", pid=0),
]


def test_trace_summary_totals_order_categories_and_idle(tmp_path, capsys):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": SYNTH}))
    ops, total, busy, window = trace_summary.summarise(
        trace_summary.load(str(tmp_path)))
    assert total == 30 + 10 + 5 + 3 + 3 + 2 + 7 + 4 + 1
    assert window == 141
    # pass 2 [20, 50), the index kernel [45, 55) and the copy [48, 52)
    # overlap: [20, 55) busy
    assert busy == 35 + 5 + 3 + 3 + 2 + 7 + 1
    cats = {trace_summary.short_name(n): (o["category"], o["occ"],
                                          o["source"])
            for n, o in ops.items()}
    assert cats == {
        "pass2_kernel<true>": ("hand kernels", 1, "ops/structure.py:853"),
        "at::native::index_elementwise_kernel<128, 4>": (
            "gathers and index ops", 1, "ops/structure.py:853"),
        "Memcpy HtoD ": ("memcpy and memset", 1, ""),
        "at::native::vectorized_elementwise_kernel<4>": ("elementwise", 2,
                                                          ""),
        "cub::DeviceRadixSortOnesweepKernel<int>": ("sorts", 1, ""),
        "at::native::reduce_kernel<512, 1>": ("reductions", 1, ""),
        "CatArrayBatchedCopy<float>": ("copies", 1, ""),
        "ncclDevKernel_AllReduce": ("other", 1, "")}
    agg = trace_summary.by_category(ops)
    assert list(agg) == list(trace_summary.CATEGORIES[:2]) + [
        "reductions", "elementwise", "memcpy and memset", "copies", "sorts",
        "other"]
    assert sum(agg.values()) == total

    assert trace_summary.main([str(path), "--top", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "total device self time: 0.065 ms over 8 ops"
    assert "pass2_kernel" in out[2] and "ops/structure.py:853" in out[2]
    assert "index_elementwise" in out[3] and "reduce_kernel" in out[4]
    assert len(out) == 6 and out[5] == ("device idle 60.3% of the traced "
                                        "window (0.056 ms busy of 0.141 ms)")
    assert trace_summary.main([str(path), "--by-category"]) == 0
    rows = capsys.readouterr().out.splitlines()[1:-1]
    assert [r.split("%  ")[1] for r in rows] == list(agg)
    assert sum(float(r.split()[0]) for r in rows) == pytest.approx(0.065)


def test_trace_summary_idle_share_of_the_untraced_run(tmp_path, capsys):
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": SYNTH}))
    # written after the trace: the directory's trace is still trace.json
    (tmp_path / trace_summary.UNTRACED).write_text(json.dumps(
        dict(steps=2, ms_per_step=0.0448)))
    assert trace_summary.main([str(tmp_path), "--by-category"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == ("device idle 60.3% of the traced window (0.056 ms "
                       "busy of 0.141 ms)")
    # 56 us busy of 2 x 44.8 us untraced
    assert out[-1] == ("device idle 37.5% of the untraced run (0.056 ms "
                       "busy of 2 steps at 0.0448 ms a step untraced)")


def test_trace_run_traces_a_tiny_chunk(tmp_path, capsys):
    out = str(tmp_path / "tr")
    assert trace_run.main(["--device", "cpu", "--ck", "", "--out", out,
                           "--steps", "1", "--preset",
                           "n=512,nbr_window=8,p2p_window=32,"
                           "m2p_window=32"]) == 0
    text = capsys.readouterr().out
    assert re.search(r"warm: [\d.]+ ms/step = [\d.]+ steps/s on cpu", text)
    assert f"trace -> {out}/trace.json" in text
    assert "total device self time: 0.000 ms over 0 ops" in text
    assert "device idle 100.0% of the traced window" in text
    assert re.search(r"device idle 100.0% of the untraced run \(0.000 ms "
                     r"busy of 1 steps at [\d.]+ ms a step untraced\)", text)
    assert any(e.get("cat") == "python_function"
               for e in trace_summary.load(out))
