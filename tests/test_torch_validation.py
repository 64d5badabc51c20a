"""The port's long-horizon tools (``planetmodel_sph_tpu_torch/tools``:
drift100k, rotating_l_check, equilibrium_run, drift_probe) and the bench
lines, against the root ``tools/`` and ``bench.py`` of the JAX package, on
the CPU at small sizes.

The whole drift tool runs in both packages from the same file: the 2,048
particles of the settled 100k state nearest its centre of mass (as
``chip_smoke.py`` phase 6 selects them) written as ``state.psph`` at step 0
into two run directories, then ``--settle 0 --target 16 --chunk 8 --set
n=2048``: both resume from that file (the two packages' initial conditions
draw different random streams), and their JSONL rows must agree within
rtol 1e-4 (the tolerance of ``test_torch_planet.py::
test_diagnostics_match_jax``) with equal overflow counters."""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu_torch import bench as tbench
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.models import planet as tp
from planetmodel_sph_tpu_torch.runtime import snapshot as tsnap
from planetmodel_sph_tpu_torch.state import FIELDS, from_numpy
from planetmodel_sph_tpu_torch.tools import drift100k as tdrift
from planetmodel_sph_tpu_torch.tools import drift_probe as tprobe
from planetmodel_sph_tpu_torch.tools import equilibrium_run as teq
from planetmodel_sph_tpu_torch.tools import rotating_l_check as trot
from test_torch_snapshot import native_lib  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(ROOT, "docs", "results", "drift100k_r5ship")
SMALL_N = 2048


def _root_tool(name, monkeypatch):
    """The root tools/<name>.py as a module (its import-time setdefault of
    the JAX cache directory kept out of the repository)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small():
    """(header, arrays) of the settled state's SMALL_N innermost particles,
    their config at n = SMALL_N, written at step 0."""
    header, arrays = tsnap.read(os.path.join(R5, "state.psph"))
    pos = arrays["pos"].astype(np.float64)
    m = arrays["mass"].astype(np.float64)
    com = (m[:, None] * pos).sum(axis=0) / m.sum()
    idx = np.sort(np.argsort(((pos - com) ** 2).sum(axis=1),
                             kind="stable")[:SMALL_N])
    arrays = {k: v[idx] for k, v in arrays.items()}
    header = dict(header, step=0,
                  config=dict(header["config"], n=SMALL_N))
    header["fields"] = [dict(f, shape=[SMALL_N] + f["shape"][1:])
                        for f in header["fields"]]
    return header, arrays


def _write_small(small, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tsnap.write_numpy(path, small[0], list(small[1].values()))
    return path


# ---- the ship gate --------------------------------------------------------

def test_ship_gate_on_the_r5_ship_run(monkeypatch, capsys):
    ref = _root_tool("drift100k", monkeypatch)
    jsonl = os.path.join(R5, "metrics.jsonl")
    assert ref.ship_gate(jsonl) == 0
    want = capsys.readouterr().out
    assert tdrift.ship_gate(jsonl) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("SHIP GATE [PASS]: |dE|/|E| = 1.54e-05")
    g = tdrift.gate_numbers(jsonl)
    assert g["overflow"] == 0 and g["spin_per_10k"] == pytest.approx(
        1.38e-5, rel=5e-3)


def _row(step, e, p=1e-5, over=0, spin=True):
    r = dict(step=step, phase="drift", total_energy=e, momentum_mag=p,
             nbr_overflow=over, tree_overflow=0)
    if spin:
        r.update(angular_momentum_x=0.0, angular_momentum_y=0.0,
                 angular_momentum_z=1e-3 * step, inertia_com=6e4)
    return r


@pytest.mark.parametrize("rows,code", [
    ([_row(0, -100.0), _row(10_000, -100.5)], 2),         # |dE|/|E| 5e-3
    ([dict(_row(0, -1.0), phase="settle"), _row(500, -1.0)], 1),
    ([_row(0, -100.0), _row(500, -100.0, over=3)], 2),
    ([_row(0, -100.0, spin=False), _row(10_000, -100.001, spin=False)], 0),
    ([_row(0, -100.0), _row(10_000, -100.0, p=2e-3)], 2),
], ids=["energy_fails", "one_drift_row", "overflow", "pre_r5_rows",
        "momentum_fails"])
def test_ship_gate_synthetic(rows, code, tmp_path, monkeypatch, capsys):
    ref = _root_tool("drift100k", monkeypatch)
    jsonl = str(tmp_path / "m.jsonl")
    with open(jsonl, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    assert ref.ship_gate(jsonl) == code
    want = capsys.readouterr().out
    assert tdrift.ship_gate(jsonl) == code
    assert capsys.readouterr().out == want


# ---- build_cfg ------------------------------------------------------------

EXACT = ["sph_exact_window=896", "fuse_p2p_sph=false",
         "fuse_p2p_residual=false"]


@pytest.mark.parametrize("sets", [[], EXACT], ids=["preset", "exact"])
@pytest.mark.parametrize("widen", [1.0, 1.25, 2.0])
@pytest.mark.parametrize("settle", [True, False], ids=["settle", "drift"])
def test_build_cfg_matches_the_reference(settle, widen, sets, monkeypatch):
    ref = _root_tool("drift100k", monkeypatch)
    args = tdrift.parse_args(sum((["--set", s] for s in sets), []))
    ns = argparse.Namespace(**vars(args))
    got = dataclasses.asdict(tdrift.build_cfg(args, settle, widen))
    want = dataclasses.asdict(ref.build_cfg(ns, settle, widen))
    assert got == want
    if sets:
        assert got["sph_exact_window"] == -(-int(896 * widen) // 16) * 16


def test_drift_tool_refuses_the_reference_results(tmp_path):
    with pytest.raises(SystemExit, match="docs/results"):
        tdrift.main(["--out", os.path.join(ROOT, "docs", "results", "x"),
                     "--device", "cpu"])
    assert not os.path.exists(os.path.join(ROOT, "docs", "results", "x"))


# ---- the whole drift tool --------------------------------------------------

DRIVE = ["--settle", "0", "--target", "16", "--chunk", "8", "--set",
         f"n={SMALL_N}"]


def test_drift_tool_matches_the_reference(small, native_lib, tmp_path,
                                            monkeypatch, capsys):
    # native_lib: the reference reads and writes its checkpoints through
    # the JAX package's native library, built for this process alone
    ref = _root_tool("drift100k", monkeypatch)
    out = {w: str(tmp_path / w) for w in ("ref", "port")}
    for d in out.values():
        _write_small(small, os.path.join(d, "state.psph"))
    monkeypatch.setattr(sys, "argv", ["drift100k.py", "--out", out["ref"]]
                        + DRIVE)
    code_ref = ref.main()
    assert tdrift.main(["--out", out["port"], "--device", "cpu"]
                       + DRIVE) == code_ref
    log = capsys.readouterr().out
    assert "phase drift: 16 steps" in log and "SHIP GATE" in log
    rows = {w: [json.loads(ln) for ln in open(os.path.join(d,
                                                           "metrics.jsonl"))]
            for w, d in out.items()}
    assert [r["step"] for r in rows["port"]] == [8, 16]
    for a, b in zip(rows["port"], rows["ref"]):
        assert set(a) == set(b)
        for k, v in b.items():
            if k in ("nbr_overflow", "tree_overflow", "step", "phase",
                     "window_widen"):
                assert a[k] == v, k
            else:
                np.testing.assert_allclose(a[k], v, rtol=1e-4, err_msg=k)
    # the checkpoint of the last chunk, read back by the port
    _, cfg, step = tsnap.load(os.path.join(out["port"], "state.psph"),
                              device="cpu")
    assert step == 16 and cfg.n == SMALL_N and cfg.nbr_window == 240


def test_drift_retry_widens_and_resets_in_the_drift_phase(small, tmp_path,
                                                          capsys):
    """A drift chunk that overflows is retried with every window x1.25
    from the state before it; the chunk after a clean widened one runs at
    the preset's windows again."""
    out = str(tmp_path / "run")
    _write_small(small, os.path.join(out, "state.psph"))
    tdrift.main(["--out", out, "--device", "cpu", "--settle", "0",
                 "--target", "4", "--chunk", "4", "--windows", "48,112,128",
                 "--set", f"n={SMALL_N}", "--set", "rebuild_every=4",
                 "--set", "respa_every=4"])
    log = capsys.readouterr().out
    rows = [json.loads(ln) for ln in open(os.path.join(out,
                                                       "metrics.jsonl"))]
    # nbr_window 48 drops a few pairs of this state, 64 (x1.25) none
    assert "step 0: overflow (2, 0) -> windows x1.25 (drift phase), chunk " \
        "retried" in log
    assert "step 4: widened chunk clean -> windows back to preset" in log
    assert rows[0]["window_widen"] == 1.25
    assert all(r["nbr_overflow"] == 0 == r["tree_overflow"] for r in rows)


def test_a_chunk_leaves_its_input_unchanged(small):
    """The retry starts again from the state before the chunk: no step of
    a cached span (sorted chunks, RESPA, a reused grouping) writes into
    the caller's tensors."""
    cfg = tc.from_dict(small[0]["config"]).replace(
        rebuild_every=2, respa_every=2, sort_every=4)
    state = from_numpy(small[1], device="cpu")
    before = {k: getattr(state, k).clone() for k in FIELDS}
    out, info = tp.run_info(state, cfg, 4)
    assert not torch.equal(out.pos, state.pos)
    for k in FIELDS:
        assert torch.equal(getattr(state, k), before[k]), k


# ---- the other tools, end to end on the CPU -------------------------------

def test_rotating_l_check_runs(small, tmp_path, capsys):
    ck = _write_small(small, str(tmp_path / "s.psph"))
    out = str(tmp_path / "rot.json")
    assert trot.main(["--ck", ck, "--steps", "2", "--chunk", "1", "--widen",
                      "1.5", "--out", out, "--device", "cpu"]) == 0
    summary = json.load(open(out))
    assert [r["step"] for r in summary["rows"]] == [1, 2]
    assert summary["overflow"] == 0 and summary["l_mag_0"] > 0
    assert np.isfinite(summary["l_rel_drift_per_10k"])


def test_rotating_spin_and_widen_match_the_reference(small, monkeypatch):
    """The spin about the centre of mass and the widened windows, against
    the reference's expressions (``tools/rotating_l_check.py:56-70``) on
    the same arrays."""
    import jax.numpy as jnp
    state = from_numpy(small[1], device="cpu")
    got = trot.spin_up(state, 0.01).vel.numpy()
    m = jnp.asarray(small[1]["mass"])
    pos = jnp.asarray(small[1]["pos"])
    com = jnp.sum(m[:, None] * pos, axis=0) / jnp.sum(m)
    r = pos - com
    want = small[1]["vel"] + 0.01 * np.asarray(jnp.stack(
        [-r[:, 1], r[:, 0], jnp.zeros_like(r[:, 0])], axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    cfg = tc.jupiter_100k()
    w = trot.widened(cfg, 1.5)
    assert (w.nbr_window, w.p2p_window, w.m2p_window,
            w.sph_refined_window) == (368, 176, 192, 128)
    assert trot.widened(cfg, 1.0) is cfg


def test_drift_probe_runs_from_a_settled_file(small, tmp_path, capsys):
    ck = _write_small(small, str(tmp_path / "s.psph"))
    out = str(tmp_path / "probe.jsonl")
    assert tprobe.main(["--probe", "ctrl", "--steps", "4", "--chunk", "2",
                        "--settled", ck, "--out", out, "--set",
                        f"n={SMALL_N}", "--device", "cpu"]) == 0
    (row,) = [json.loads(ln) for ln in open(out)]
    assert set(row) == {"probe", "drift_rel", "per10k", "chunk_dE", "vmax",
                        "secs"}
    assert row["probe"] == "ctrl" and len(row["chunk_dE"]) == 2
    assert "reusing settled state" in capsys.readouterr().out


def test_drift_probe_ladder_is_the_reference(monkeypatch):
    ref = _root_tool("drift_probe", monkeypatch)
    assert tprobe.PROBES == ref.PROBES and tprobe.BASE == ref.BASE


@pytest.mark.parametrize("preset", ["jupiter_3k", "gradh"])
def test_equilibrium_run_writes_its_artifacts(preset, tmp_path, capsys):
    out = str(tmp_path / "eq")
    assert teq.main(["--preset", preset, "--steps", "2", "--every", "1",
                     "--out", out, "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["equilibrium.png",
                                       "equilibrium_diags.npz",
                                       "equilibrium_state.psph",
                                       "profile.json"]
    prof = json.load(open(os.path.join(out, "profile.json")))
    assert prof["preset"] == preset and prof["steps"] == 2
    assert len(prof["profile"]) == 16
    with np.load(os.path.join(out, "equilibrium_diags.npz")) as z:
        assert z["total_energy"].shape == (2,)
    assert "energy drift over 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("preset", teq.PRESETS)
def test_equilibrium_presets_match_the_reference(preset):
    import planetmodel_sph_tpu as psph
    want = {"gradh": lambda: psph.default(n=3000, grad_p_mode="grad_h",
                                          h_mode="newton"),
            "gradh_100k": lambda: psph.jupiter_100k(grad_p_mode="grad_h",
                                                    h_mode="newton"),
            "default": lambda: psph.default(n=3000)}.get(
        preset, lambda: getattr(jc, preset)())()
    assert dataclasses.asdict(teq.preset_config(preset)) == \
        dataclasses.asdict(want)


# ---- the bench lines ------------------------------------------------------

def test_bench_lines_rescale_line_two_and_survive_a_failure(monkeypatch):
    calls = []

    def fake(device="cuda", **kw):
        calls.append(kw)
        if kw.get("preset") == "jupiter_3k":
            return {"metric": "particle_steps_per_sec_n3000",
                    "value": 3e5, "vs_baseline": 2.0}
        raise RuntimeError("no state")

    monkeypatch.setattr(tbench, "run_bench", fake)
    one, two = tbench.bench_lines("cpu", card="X, 700.00 W")
    assert calls == [dict(preset="jupiter_3k", n=3000, steps=200),
                     dict(checkpoint_path=tbench.SETTLED, steps=64)]
    assert one["vs_baseline"] == 2.0 and one["card"] == "X, 700.00 W"
    assert two == {"metric": "particle_steps_per_sec_n100000", "value": 0.0,
                   "unit": "particle-steps/s", "vs_baseline": 0.0,
                   "error": "RuntimeError: no state", "card": "X, 700.00 W"}

    monkeypatch.setattr(tbench, "run_bench", lambda device="cuda", **kw: {
        "value": 1.2e7, "vs_baseline": 80.0})
    _, two = tbench.bench_lines("cpu")
    assert two["vs_baseline"] == 1.2e7 / 6e6 and "card" not in two


def test_bench_lines_print_two_json_lines(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "run_bench", lambda device="cuda", **kw: (
        _ for _ in ()).throw(ValueError("boom")))
    assert tbench.main(["--lines", "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["metric"] for ln in lines] == [
        "particle_steps_per_sec_n3000", "particle_steps_per_sec_n100000"]
