"""The cell on the card, as the driver runs it (a short window)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import registry


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["dense32k"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, workload, trace):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        workload, "--seed", str(2**31 + 9), "--seconds",
                        "3", "--trace", str(trace)],
                       cwd=registry.ROOT, capture_output=True, text=True,
                       timeout=1200, env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
