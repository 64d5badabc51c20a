"""A cell, a traffic mix and a per-layer metric that a later change adds
are new files that the harness finds by name, with no edit."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import registry, run
from benchmark.tests.tree import make_tree


def test_new_cell_and_metric_files_are_found(tmp_path):
    root, here, bench = make_tree(str(tmp_path))
    tr = registry.load_json(os.path.join(here, "workloads",
                                         "tiny_ball.json"))
    tr.update(frame_steps=5, trace_frames=2)
    with open(os.path.join(here, "workloads", "tiny_ball_5.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(here, "limits", "later_cell.json"), "w") as f:
        json.dump(registry.load_json(os.path.join(
            here, "limits", "tiny_dense.json")), f)
    with open(os.path.join(here, "metrics", "later.metric.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.trace['steps'])\n")
    bench["workloads"].append(dict(name="later_cell", config="tiny_ball",
                                   traffic="tiny_ball_5", chips=1,
                                   why="test"))
    bench["per_layer"].append(dict(
        name="later.metric", unit="steps", better="higher",
        source="device_trace", layer="runner",
        moves="particle_steps_per_s", workloads=["later_cell"]))
    cell = registry.cell("later_cell", root=root, here=here, bench=bench)
    assert cell.traffic["frame_steps"] == 5
    assert [m["name"] for m in cell.per_layer] == ["later.metric"]
    result = run.run(cell, 11, 0.3, True, "cpu")
    assert result["metrics"]["later.metric"]["value"] == 10.0
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        registry.cell("no_such_cell")


def test_no_card_no_result(tmp_path):
    """Without a card (and in a directory that holds only BENCHMARK.json
    and the benchmark's files) the command exits non-zero and prints no
    result."""
    import shutil
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "dense32k", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
