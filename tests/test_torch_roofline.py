"""The port's tools against the reference's: ``tools.roofline.count_work``
equals ``tools/roofline.py``'s slot for slot on the ``--smoke``
configuration (n = 2048), also with particle-exact SPH lists and with the
supergroup far tier, and both tools run to their end on the CPU at tiny
sizes (``python -m ... --device cpu``)."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu.models import ics as jics
from planetmodel_sph_tpu.ops import structure as js
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.ops import structure as ts
from planetmodel_sph_tpu_torch.tools import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = dict(n=2048, neighbor_mode="grid", gravity_solver="tree",
             nbr_group_level=3, nbr_window=128, p2p_window=128,
             m2p_window=128, rebuild_every=4, grad_p_mode="grad_h",
             h_mode="newton")


def _reference_roofline():
    spec = importlib.util.spec_from_file_location(
        "reference_roofline", os.path.join(ROOT, "tools", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_roof = _reference_roofline()


@pytest.fixture(scope="module")
def smoke_state():
    st = jics.jupiter(jc.SimConfig(**SMOKE))
    return {k: np.array(getattr(st, k)) for k in ("pos", "h", "mass")}


@pytest.mark.parametrize("extra", [
    {}, dict(sph_exact_window=512), dict(sg_blocks=2, blk_window=128)],
    ids=["smoke", "exact_lists", "supergroups"])
def test_count_work_equals_the_reference(smoke_state, extra):
    kw = dict(SMOKE, **extra)
    jcfg, tcfg = jc.SimConfig(**kw), tc.SimConfig(**kw)
    p, h, m = smoke_state["pos"], smoke_state["h"], smoke_state["mass"]
    jst = jax.jit(lambda a, b, c: js.build(a, b, c, jcfg))(p, h, m)
    tst = ts.build(torch.from_numpy(p), torch.from_numpy(h),
                   torch.from_numpy(m), tcfg)
    ref = ref_roof.count_work(jcfg, jst)
    out = roofline.count_work(tcfg, tst)
    assert out == ref
    assert out["sph_slots"] > 0 and out["far_slots"] > 0
    if extra.get("sg_blocks"):
        assert out["blk_slots"] > 0
    assert roofline.OPS == ref_roof.OPS


def test_modeled_floor_is_the_reference_arithmetic():
    cfg = tc.jupiter_100k()
    w = dict(sph_slots=3e8, p2p_slots=2e8, ring_slots=1e8, far_slots=3e8,
             blk_slots=0.0, gather_bytes=4e8)
    fl = roofline.modeled_floor(cfg, w, vpu=5e13, hbm=3e12, launch=4e-6)
    ops = (3e8 * (26 + 40) + 2e8 * 38 + 4e8 * (12 + 28))
    assert fl["vpu"] == pytest.approx(ops / 5e13)
    assert fl["hbm"] == pytest.approx(4e8 / 3e12)
    assert fl["launch"] == pytest.approx(1.2e-5)
    assert fl["amort"] == pytest.approx(3 * 3e8 * 26 / 5e13 / 32)
    assert fl["total"] == pytest.approx(sum(v for k, v in fl.items()
                                            if k != "total"))


def _run(args, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_roofline_smoke_runs_on_the_cpu(tmp_path):
    out = str(tmp_path / "roof.json")
    r = _run(["planetmodel_sph_tpu_torch.tools.roofline", "--smoke",
              "--device", "cpu", "--steps", "2", "--json", out], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "modeled per-step floor" in r.stdout and "measured" in r.stdout
    res = json.load(open(out))
    assert res["device"] == "cpu" and res["work"]["groups"] > 0
    assert res["floor_s"] > 0 and res["measured_s"] > 0
    assert res["launches_per_step"] == {}     # plain versions on the CPU


def test_microbench_runs_on_the_cpu(tmp_path):
    r = _run(["planetmodel_sph_tpu_torch.tools.microbench", "--device",
              "cpu", "--k", "1", "--g", "24", "--w", "8", "--navg", "3"],
             tmp_path)
    assert r.returncode == 0, r.stderr
    for label in ("gather packed-interleaved", "gather probe_gather kernel",
                  "pass1-style SG=1", "pass1-style SG=8", "Gpair/s"):
        assert label in r.stdout, label


def test_tools_refuse_without_a_card(monkeypatch):
    from planetmodel_sph_tpu_torch.tools import microbench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        roofline.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        microbench.main(["--g", "8"])
