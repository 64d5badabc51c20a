"""The port's command line (``planetmodel_sph_tpu_torch.cli``) on the CPU:
a run with diagnostics, metrics and a checkpoint, a resume that continues
the step count, the cold-start bench, and the refusal by name of every
option the port does not serve."""

import json

import pytest
import torch

from planetmodel_sph_tpu_torch import bench, cli
from planetmodel_sph_tpu_torch.runtime import snapshot

RUN = ["run", "--device", "cpu", "--n", "256", "--steps", "4",
       "--diag-every", "2"]


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_run_checkpoint_and_resume(tmp_path, capsys):
    metrics = str(tmp_path / "m.jsonl")
    ck = str(tmp_path / "x.psph")
    assert cli.main(RUN + ["--metrics-jsonl", metrics,
                           "--checkpoint", ck]) == 0
    rows = _rows(metrics)
    assert [r["step"] for r in rows] == [2, 4]
    assert {"total_energy", "neighbors_avg", "momentum_mag",
            "nbr_overflow"} <= set(rows[0])
    state, cfg, step = snapshot.load(ck, device="cpu")
    assert step == 4 and cfg.n == 256 and cfg.neighbor_mode == "dense"
    assert bool(torch.isfinite(state.pos).all())
    err = capsys.readouterr().err
    assert "4 steps in" in err and "energy drift" in err

    # the resume continues the step count and appends to the same trail,
    # with a diagnosed remainder chunk (3 = 2 + 1)
    assert cli.main(["run", "--device", "cpu", "--restore", ck, "--steps",
                     "3", "--diag-every", "2", "--metrics-jsonl", metrics,
                     "--checkpoint", ck]) == 0
    assert [r["step"] for r in _rows(metrics)] == [2, 4, 6, 7]
    assert snapshot.load(ck, device="cpu")[2] == 7
    # the resumed run continues the first one: same particles, advanced
    state7 = snapshot.load(ck, device="cpu")[0]
    assert not torch.equal(state7.pos, state.pos)


def test_run_is_deterministic_and_seed_matters(tmp_path):
    out = []
    for seed in ("1", "1", "2"):
        m = str(tmp_path / f"m{len(out)}.jsonl")
        assert cli.main(RUN + ["--seed", seed, "--metrics-jsonl", m]) == 0
        out.append(_rows(m)[-1]["total_energy"])
    assert out[0] == out[1] != out[2]


@pytest.mark.parametrize("extra", [
    ["--ic", "rotating_planet", "--omega", "0.1", "--av", "1.0",
     "--balsara"],
    ["--ic", "two_planet_collision", "--separation", "60", "--n", "101",
     "--integrator", "staggered_euler", "--set", "dt_mode=cfl"],
    ["--gravity", "none", "--freeze-velocity", "--dt", "0.01",
     "--set", "kernel_deriv_sign_bug=true"],
])
def test_run_options_of_the_ported_paths(extra, tmp_path):
    m = str(tmp_path / "m.jsonl")
    assert cli.main(RUN + extra + ["--metrics-jsonl", m]) == 0
    last = _rows(m)[-1]
    assert last["step"] == 4 and last["total_energy"] == last["total_energy"]


def test_bench_prints_one_json_line(capsys):
    assert cli.main(["bench", "--device", "cpu", "--n", "128", "--steps",
                     "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "particle_steps_per_sec_n128"
    assert res["operating_point"] == "early_transient"
    assert res["device"] == "cpu" and res["n"] == 128
    assert res["overflow"] == {"nbr_overflow": 0, "tree_overflow": 0}
    assert res["value"] == pytest.approx(128 * res["steps_per_sec"])


def test_bench_cold_start_refuses_unknown_preset():
    with pytest.raises(ValueError, match="parity"):
        bench.run_bench(preset="parity", n=64, steps=1, device="cpu")


@pytest.mark.parametrize("extra,word", [
    (["--render", "x.png"], "--render"),
    (["--render-every", "5"], "--render-every"),
    (["--serve", "0"], "--serve"),
    (["--devices", "2"], "--devices"),
    (["--eos", "adiabatic"], "--eos"),
    (["--materials", "basalt,ice"], "--materials"),
    (["--checkpoint", "x.npz"], "npz"),
    (["--restore", "x.npz"], "npz"),
])
def test_unported_flags_exit_nonzero_naming_the_flag(extra, word):
    with pytest.raises(SystemExit) as e:
        cli.main(RUN + extra)
    assert e.value.code not in (0, None) and word in str(e.value.code)


@pytest.mark.parametrize("extra,word", [
    (["--gravity", "tree"], "gravity_solver"),
    (["--set", "eos_mode=tillotson"], "eos_mode"),
    (["--set", "rebuild_every=8"], "rebuild_every"),
    (["--ic", "differentiated_planet"], "tillotson"),
    (["--neighbor", "grid"], "neighbor_mode='grid'"),
])
def test_unported_configurations_exit_nonzero_naming_the_option(
        extra, word, capsys):
    assert cli.main(RUN + extra) != 0
    assert word in capsys.readouterr().err


@pytest.mark.parametrize("preset", ["auto", "parity", "basalt_impact"])
def test_unported_presets_are_not_offered(preset):
    with pytest.raises(SystemExit) as e:
        cli.main(["run", "--device", "cpu", "--preset", preset])
    assert e.value.code == 2


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "--n", "64", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["bench", "--n", "64", "--steps", "1"])
