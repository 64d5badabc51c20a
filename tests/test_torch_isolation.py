"""The port stands alone: no module of ``planetmodel_sph_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package; entry points default to
the card and refuse to fall back to the CPU; the smoke run refuses to run
without a card or outside the repository."""

import ast
import inspect
import os
import shutil
import subprocess
import sys

import pytest
import torch

from planetmodel_sph_tpu_torch import bench, cli, state
from planetmodel_sph_tpu_torch.models import ics
from planetmodel_sph_tpu_torch.parallel import mesh
from planetmodel_sph_tpu_torch.runtime import snapshot
from planetmodel_sph_tpu_torch.tools import drift100k, drift_probe
from planetmodel_sph_tpu_torch.tools import equilibrium_run, microbench
from planetmodel_sph_tpu_torch.tools import roofline, rotating_l_check
from planetmodel_sph_tpu_torch.tools import halo_collision, halo_debug
from planetmodel_sph_tpu_torch.tools import ksweep, ksweep2, micro_gather
from planetmodel_sph_tpu_torch.tools import neighbors_of, profile_build
from planetmodel_sph_tpu_torch.tools import scaling_bench, settle_ball
from planetmodel_sph_tpu_torch.tools import profile_block, span_stats
from planetmodel_sph_tpu_torch.tools import trace_run
from planetmodel_sph_tpu_torch.utils import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "planetmodel_sph_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "planetmodel_sph_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, files in os.walk(PKG):
        if d == PKG:
            dirs[:] = [x for x in dirs if x != "build"]    # build outputs
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_package():
    names = {os.path.relpath(p, PKG) for p in _sources()}
    assert {"ops/structure.py", "ops/cuda/groups2.py", "models/planet.py",
            "runtime/snapshot.py", "ops/cuda/pairwise.py", "ops/dense.py",
            "ops/kernels.py", "models/ics.py", "cli.py", "bench.py",
            "config.py", "ops/cuda/build.py", "ops/cuda/launch.py",
            "ops/gravity.py", "ops/grouping.py", "ops/eos.py",
            "ops/cuda/probes.py", "tools/roofline.py",
            "tools/microbench.py", "utils/checkpoint.py",
            "tools/drift100k.py", "tools/rotating_l_check.py",
            "tools/equilibrium_run.py", "tools/drift_probe.py",
            "utils/profiling.py", "utils/render.py", "utils/liveview.py",
            "runtime/native.py", "parallel/mesh.py", "parallel/dp.py",
            "parallel/halo.py", "tools/halo_collision.py",
            "tools/settle_ball.py", "tools/halo_debug.py",
            "tools/profile_build.py", "tools/scaling_bench.py",
            "tools/neighbors_of.py", "tools/span_stats.py",
            "tools/ksweep.py", "tools/ksweep2.py",
            "tools/micro_gather.py", "tools/profile_block.py",
            "tools/trace_run.py", "tools/trace_summary.py",
            "utils/debug_nans.py"} <= names
    assert os.path.exists(os.path.join(PKG, "runtime", "psph_io.cpp"))


def test_every_kernel_has_its_source_signature_and_counter():
    """Each kernel the wrappers launch is an entry point of a source in
    csrc/ (its own, or the one ``build.SOURCE`` names) with a C signature
    and a launch counter, and the sources include nothing but the CUDA
    runtime and the package's own header."""
    from planetmodel_sph_tpu_torch.ops.cuda import build, groups2, launch
    from planetmodel_sph_tpu_torch.ops.cuda import pairwise, probes
    names = set(groups2.KERNELS) | set(pairwise.KERNELS) | set(
        probes.KERNELS)
    assert names == set(build.SIGNATURES) == set(launch.LAUNCHES)
    assert {"pass1_sym", "p2p", "probe_gather"} <= names
    assert len(names) == 13
    assert len({build.source(n) for n in names}) == 12
    for n in names:
        src = open(os.path.join(PKG, "csrc", build.source(n) + ".cu")).read()
        assert f'extern "C" int psph_{n}(' in src
        inc = [ln.split()[1] for ln in src.splitlines()
               if ln.startswith("#include")]
        assert set(inc) <= {'"common.cuh"', "<cuda_runtime.h>",
                            "<cstdint>"}, (n, inc)


@pytest.mark.parametrize("fn", [state.from_numpy, state.zeros,
                                snapshot.load, checkpoint.load,
                                roofline.measure_dispatch,
                                roofline.measure_hbm, roofline.measure_vpu,
                                roofline.measure_launch,
                                microbench.bench_gathers,
                                microbench.bench_kernel_tiles,
                                bench.run_bench, bench.bench_lines,
                                ics.jupiter, ics.polytrope,
                                ics.two_planet_collision,
                                ics.rotating_planet, mesh.placement,
                                mesh.make_mesh, mesh.spawn])
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("call", [
    lambda: ics.jupiter(state.SimConfig(n=8)),
    lambda: ics.polytrope(state.SimConfig(n=8)),
    lambda: ics.rotating_planet(state.SimConfig(n=8)),
    lambda: ics.two_planet_collision(state.SimConfig(n=8)),
    lambda: bench.run_bench(preset="jupiter_3k", n=8, steps=1),
    lambda: cli.main(["run", "--n", "8", "--steps", "1"]),
    lambda: cli.main(["bench", "--n", "8", "--steps", "1"]),
    lambda: roofline.main(["--smoke"]),
    lambda: microbench.main(["--g", "8"]),
    lambda: checkpoint.load(snapshot.__file__),
    lambda: bench.main(["--lines"]),
    lambda: drift100k.main(["--out", "out/never"]),
    lambda: rotating_l_check.main([]),
    lambda: equilibrium_run.main(["--out", "out/never"]),
    lambda: drift_probe.main([]),
    lambda: cli.main(["run", "--n", "8", "--steps", "1", "--serve", "0"]),
    lambda: settle_ball.main(["--out", "out/never.psph"]),
    lambda: halo_collision.main(["--out", "out/never"]),
    lambda: halo_debug.main([]),
    lambda: profile_build.main([]),
    lambda: scaling_bench.main([]),
    lambda: neighbors_of.main([]),
    lambda: span_stats.main([]),
    lambda: ksweep.main([]),
    lambda: ksweep2.main([]),
    lambda: micro_gather.main([]),
    lambda: profile_block.main([]),
    lambda: trace_run.main([]),
], ids=["jupiter", "polytrope", "rotating_planet", "two_planet_collision",
        "bench_cold_start", "cli_run", "cli_bench", "tools_roofline",
        "tools_microbench", "checkpoint_load", "bench_lines",
        "tools_drift100k", "tools_rotating_l_check",
        "tools_equilibrium_run", "tools_drift_probe", "cli_serve",
        "tools_settle_ball", "tools_halo_collision", "tools_halo_debug",
        "tools_profile_build", "tools_scaling_bench", "tools_neighbors_of",
        "tools_span_stats", "tools_ksweep", "tools_ksweep2",
        "tools_micro_gather", "tools_profile_block", "tools_trace_run"])
def test_new_entry_points_raise_without_a_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_cli_device_flag_defaults_to_cuda():
    src = inspect.getsource(cli.main)
    assert src.count('"--device", default="cuda"') == 2     # run and bench


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state.zeros(state.SimConfig(n=4))
    assert state.resolve_device("cpu").type == "cpu"


def _smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _smoke(ROOT, env)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _smoke(str(tmp_path), env)
    assert r.returncode != 0 and r.stdout == ""
