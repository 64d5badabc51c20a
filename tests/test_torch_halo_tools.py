"""The port's halo tools (``tools.settle_ball``, ``tools.halo_collision``,
``tools.halo_debug``) and the developer tools (``profile_build``,
``scaling_bench``, ``neighbors_of``, ``span_stats``, ``ksweep``,
``ksweep2``, ``micro_gather``) on the CPU at tiny sizes.

The collision protocol's configurations equal the root
``tools/halo_collision.py``'s field for field. The rest run end to end
here with narrowed windows (the protocol's 768/512/512 are capacities, and
the plain versions on the CPU sweep every slot of a window), on 8 gloo
ranks for the two halo tools, and must print their lines; the rates they
print here are the CPU's, no device number."""

import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from planetmodel_sph_tpu_torch.tools import halo_collision, halo_debug
from planetmodel_sph_tpu_torch.tools import ksweep, ksweep2, micro_gather
from planetmodel_sph_tpu_torch.tools import neighbors_of, profile_build
from planetmodel_sph_tpu_torch.tools import scaling_bench, settle_ball
from planetmodel_sph_tpu_torch.tools import span_stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 512
NARROW = ["--set", "nbr_window=64", "--set", "p2p_window=64", "--set",
          "m2p_window=64"]


def _root_halo_collision(monkeypatch):
    """The root tools/halo_collision.py as a module; its import-time
    environment changes are undone after the test."""
    for k in ("XLA_FLAGS", "JAX_PLATFORMS"):
        monkeypatch.setenv(k, os.environ.get(k, ""))
    spec = importlib.util.spec_from_file_location(
        "root_tools_halo_collision",
        os.path.join(ROOT, "tools", "halo_collision.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [32768, 2048])
def test_protocol_configs_equal_the_reference(n, monkeypatch):
    ref = _root_halo_collision(monkeypatch)
    pairs = [(halo_collision.build_cfg(n), ref.build_cfg(n))]
    pairs += [(halo_collision.settle_cfg(pairs[0][0], n // 2, mult=m),
               ref.settle_cfg(pairs[0][1], n // 2, mult=m)) for m in (1, 3)]
    for got, want in pairs:
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert set(g) == set(w)
        assert {k: g[k] for k in g if g[k] != w[k]} == {}, \
            {k: (g[k], w[k]) for k in g if g[k] != w[k]}
    cfg = pairs[0][0]
    assert (cfg.n, cfg.dp_mode, cfg.halo_ring_radius, cfg.halo_chunk,
            cfg.nbr_window, cfg.p2p_window, cfg.m2p_window, cfg.nbr_sub,
            cfg.sph_refined_window) == (n, "halo", 3, 16, 768, 512, 512,
                                        16, 0)


@pytest.fixture(scope="module")
def ball(tmp_path_factory):
    """A ball from settle_ball at n = N (4 settle steps, 2 probe steps,
    narrow windows): (path, its printed lines, exit code)."""
    path = str(tmp_path_factory.mktemp("halo") / "ball.psph")
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = settle_ball.main(["--device", "cpu", "--n", str(N), "--steps",
                               "4", "--probe-steps", "2", "--out", path]
                              + NARROW)
    return path, buf.getvalue(), rc


def test_settle_ball_writes_the_ball(ball):
    path, out, rc = ball
    assert rc == 0 and os.path.exists(path)
    assert f"settled ball n={N // 2}: over=(0, 0) finite=True" in out
    assert "settled-ball occupancy (x1 cutoffs, unbounded windows)" in out
    assert "leg-window probe (2 steps @ x1): over=(0, 0)" in out
    assert f"ball -> {path}" in out


def test_halo_collision_runs_on_cpu_ranks(ball, tmp_path, capfd):
    out = str(tmp_path / "hc")
    rec = str(tmp_path / "inputs.pt")
    rc = halo_collision.main([
        "--device", "cpu", "--n", str(N), "--ball-ck", ball[0], "--steps",
        "8", "--segment", "4", "--leg1-segments", "1", "--out", out,
        "--record-inputs", rec] + NARROW)
    text = capfd.readouterr().out
    s = json.load(open(os.path.join(out, "summary.json")))
    assert rc == (0 if s["match_vs_replicated"] else 2)
    assert "leg1 seg 0: rep finite=True over=(0,0)  halo finite=True " \
        "over=(0,0)" in text and "leg1 match-vs-replicated" in text
    assert s["leg1_overflow"] == {"leg1_replicated": [0, 0],
                                  "leg1_halo": [0, 0]}
    assert s["leg2_overflow"] == [0, 0] and s["leg2_finite"]
    assert s["ranks"] == 8 and s["backend"] == "gloo"
    assert 0 <= s["pair_duplicates"] < N and s["dpos_p99"] < 1e-3 * s["scale"]
    rows = [json.loads(ln) for ln in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [4, 8]
    # the plain versions ran (no kernel launches on the CPU); rank 0
    # recorded each windowed kernel the halo step calls
    assert set(s["launches"]) == {"leg1_replicated", "leg1_halo", "leg2"}
    assert not any(v for leg in s["launches"].values() for v in leg.values())
    inputs = torch.load(rec, weights_only=False)
    assert {"filter_sph", "pass1_gradh", "pass2", "gravity_fused",
            "p2p"} <= set(inputs)


def test_halo_collision_refuses_a_ball_of_another_size(ball, tmp_path):
    assert halo_collision.main(["--device", "cpu", "--n", str(2 * N),
                                "--ball-ck", ball[0], "--out",
                                str(tmp_path)]) == 4


def test_halo_debug_runs_on_cpu_ranks(ball, capfd):
    assert halo_debug.main([str(N), ball[0], "--device", "cpu",
                            "--segments", "1"] + NARROW) == 0
    text = capfd.readouterr().out
    assert "halo-layout occupancy (unbounded): sph " in text
    assert "seg 0: rep finite=True over=(0,0)  halo finite=True " \
        "over=(0,0)" in text


TOOLS = {
    "profile_build": (profile_build, ["--n", "1000", "--k", "1"],
                      ["build (full)", "morton encode+argsort",
                       "cell_groups (incl sort)",
                       "block stats + [G,NB] geometry", "_compact_rows"]),
    "scaling_bench": (scaling_bench, ["--dense-n", "200,400", "--grid-n",
                                      "", "--steps", "2"],
                      ["'n': 200, 'pipeline': 'dense+direct",
                       "'n': 400, 'pipeline': 'dense+direct"]),
    "neighbors_of": (neighbors_of, ["--n", "512", "--particle", "17",
                                    "--set", "neighbor_mode=grid", "--set",
                                    "gravity_solver=tree"],
                     ["dense oracle:", "window pipeline: group",
                      "OK: window candidates cover the oracle exactly"]),
    "span_stats": (span_stats, ["--ck", "BALL", "--xw", "64"],
                   ["SPH exact window (particle ids):", "P2P window",
                    "M2P ring window", "span avg="]),
    "ksweep": (ksweep, ["--n", "512", "--steps", "1", "--warm", "1",
                        "--sub", "32", "--k", "8"],
               ["sub=32 K= 8:", "steps/s", "over=(0,0,0)"]),
    "ksweep2": (ksweep2, ["--ck", "BALL", "--var", "base", "--var",
                          "xwk16bf", "--steps", "1", "--windows",
                          "32,32,32"],
                ["checkpoint at step 4", "base        :", "steps/s",
                 "xwk16bf: FAILED"]),
    "micro_gather": (micro_gather, ["--g", "8", "--wx", "16", "--wc", "64",
                                    "--n", "1024", "--nsub", "64", "--w",
                                    "8", "--k", "2"],
                     ["packed [1024,6] row-gather -> [8,16]",
                      "same, Morton-local ids",
                      "take_along_axis [8,64]->[,16] x6",
                      "entry-gather [64,160] (640B rows) -> [8,8]"]),
}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_developer_tool_prints_its_lines(name, ball, tmp_path, capfd):
    mod, argv, lines = TOOLS[name]
    argv = [ball[0] if a == "BALL" else a for a in argv]
    if name == "scaling_bench":
        argv += ["--json", str(tmp_path / "s.json")]
    assert mod.main(["--device", "cpu"] + argv) == 0
    text = capfd.readouterr().out
    for ln in lines:
        assert ln in text, (ln, text[-2000:])
    if name == "scaling_bench":
        rep = json.load(open(tmp_path / "s.json"))
        assert rep["device"] == "cpu" and len(rep["rows"]) == 2
