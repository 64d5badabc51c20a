"""The port's command line (``planetmodel_sph_tpu_torch.cli``) on the CPU:
a run with diagnostics, metrics and a checkpoint, a resume that continues
the step count, the cold-start bench, and the refusal by name of every
option the port does not serve."""

import json
import os

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
    with pytest.raises(ValueError, match="collision"):
        bench.run_bench(preset="collision", n=64, steps=1, device="cpu")
    with pytest.raises(ValueError, match="ic="):
        bench.run_bench(preset="parity", n=64, steps=1, device="cpu",
                        ic="rotating_planet")


GRID = ["--neighbor", "grid", "--gravity", "tree", "--n", "512", "--set",
        "nbr_group_size=32", "--set", "nbr_group_level=2", "--set",
        "radius=20.0", "--set", "particle_radius=4.0"]


@pytest.mark.parametrize("extra", [
    ["--preset", "parity", "--n", "256"],
    ["--preset", "auto", "--n", "256"],
    GRID,
    GRID + ["--av", "1.0"],
    GRID + ["--av", "1.0", "--balsara", "--set", "grad_p_mode=grad_h",
            "--set", "h_mode=newton"],
    GRID + ["--set", "fuse_p2p_sph=true", "--set", "rebuild_every=2",
            "--set", "respa_every=2", "--set", "softening_mode=receiver_h"],
    ["--neighbor", "grid", "--gravity", "none", "--n", "256", "--set",
     "nbr_group_level=2"],
    ["--gravity", "tree", "--n", "256", "--set", "grad_p_mode=grad_h",
     "--set", "nbr_group_level=2"],
], ids=["parity", "auto", "grid_tree", "grid_tree_av",
        "grid_tree_gradh_av_balsara", "grid_fused_cached_respa",
        "grid_no_gravity", "dense_gradh_tree"])
def test_run_options_this_slice_opened(extra, tmp_path, capsys):
    m = str(tmp_path / "m.jsonl")
    assert cli.main(["run", "--device", "cpu", "--steps", "4",
                     "--diag-every", "2", "--metrics-jsonl", m] + extra) == 0
    last = _rows(m)[-1]
    assert last["step"] == 4 and last["total_energy"] == last["total_energy"]
    assert last["nbr_overflow"] == 0 == last["tree_overflow"]
    assert 5.0 < last["neighbors_avg"] < 150.0
    assert "WARNING" not in capsys.readouterr().err


def test_parity_preset_is_the_reference_quirks():
    cfg = cli._build_cfg(cli.argparse.Namespace(
        n=None, seed=None, dt=None, integrator=None, gravity=None,
        neighbor=None, freeze_velocity=False, av=None, balsara=False,
        eos=None, set=[], preset="parity"))
    assert (cfg.grad_p_mode, cfg.softening_mode, cfg.integrator,
            cfg.gravity_solver, cfg.neighbor_mode, cfg.n) == (
        "reference_asymmetric", "receiver_h", "staggered_euler", "tree",
        "dense", 3000)
    assert cfg.kernel_deriv_sign_bug


def test_bench_set_overrides_preset_and_checkpoint(tmp_path, capsys):
    """`bench --set K=V` on a cold start and from a state file: the
    overrides reach the config, and a loaded state is primed again under
    it."""
    assert cli.main(["bench", "--device", "cpu", "--n", "256", "--steps",
                     "2", "--preset", "parity", "--set",
                     "nbr_group_level=2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["n"] == 256 and res["steps_per_sec"] > 0
    ck = str(tmp_path / "g.psph")
    assert cli.main(["run", "--device", "cpu", "--steps", "2",
                     "--checkpoint", ck] + GRID) == 0
    capsys.readouterr()
    assert bench.main(["--device", "cpu", "--checkpoint", ck, "--steps",
                       "2", "--warmup-steps", "0", "--set",
                       "grad_p_mode=reference_asymmetric", "--set",
                       "rebuild_every=2", "--set", "fuse_p2p_sph=true"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["operating_point"] == "settled" and res["n"] == 512
    assert res["overflow"] == {"nbr_overflow": 0, "tree_overflow": 0}
    with pytest.raises(ValueError, match="kernel_gb"):
        bench.main(["--device", "cpu", "--checkpoint", ck, "--set",
                    "kernel_gb=0"])
    # the supergroup tier on the state file, and the evolved internal
    # energy: u is filled from the polytropic relation at the stored density
    assert bench.main(["--device", "cpu", "--checkpoint", ck, "--steps",
                       "2", "--warmup-steps", "0", "--set", "sg_blocks=4",
                       "--set", "blk_window=64", "--set",
                       "eos_mode=adiabatic", "--set", "av_alpha=1.0",
                       "--set", "av_beta=2.0"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["overflow"] == {"nbr_overflow": 0, "tree_overflow": 0}


@pytest.mark.parametrize("extra,word", [
    (["--devices", "2", "--set", "dp_mode=halo"], "dp_mode"),
    (["--materials", "basalt,ice"], "--materials"),
    (["--materials", "basalt", "--ic", "two_planet_collision"],
     "--materials"),
])
def test_unported_flags_exit_nonzero_naming_the_flag(extra, word):
    with pytest.raises(SystemExit) as e:
        cli.main(RUN + extra)
    assert e.value.code not in (0, None) and word in str(e.value.code)


@pytest.mark.parametrize("cmd", [RUN, ["bench", "--device", "cpu", "--n",
                                       "64", "--steps", "1"]],
                         ids=["run", "bench"])
@pytest.mark.parametrize("platform", ["cpu", "tpu"])
def test_platform_is_refused_pointing_at_device(cmd, platform):
    """The reference's --platform (a JAX backend switch, given before the
    subcommand) exits non-zero naming itself and --device, before any
    work."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", platform] + cmd)
    msg = str(e.value.code)
    assert "--platform" in msg and "--device" in msg


def _png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("flag", ["--render", "--render-every", "--animate",
                                  "--serve"])
def test_rendering_and_viewer_flags_produce_their_artifact(
        flag, tmp_path, monkeypatch, capsys):
    """Each flag the port once refused runs and produces its artifact: the
    final PNG, the frames, the GIF, a /diag.json served during the run
    (read from inside the run loop, where the viewer holds the chunk's
    diagnostics)."""
    import urllib.request
    frames = tmp_path / "frames"
    extra = {
        "--render": ["--render", str(tmp_path / "x.png"),
                     "--render-color-by", "id", "--render-quiver"],
        "--render-every": ["--render-every", "2", "--render-every-dir",
                           str(frames)],
        "--animate": ["--render-every", "1", "--render-every-dir",
                      str(frames), "--animate", str(tmp_path / "x.gif"),
                      "--animate-fps", "5"],
        "--serve": ["--serve", "0"],
    }[flag]
    served = []
    real_control = cli._viewer_control

    def control(viewer, cfg):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{viewer.port}/diag.json", timeout=10) as r:
            served.append(json.loads(r.read()))
        return real_control(viewer, cfg)

    monkeypatch.setattr(cli, "_viewer_control", control)
    assert cli.main(RUN + extra) == 0
    if flag == "--render":
        assert _png(tmp_path / "x.png")
    elif flag == "--render-every":
        assert sorted(os.listdir(frames)) == ["frame_00000.png",
                                              "frame_00001.png"]
        assert all(_png(frames / f) for f in os.listdir(frames))
    elif flag == "--animate":
        assert len(os.listdir(frames)) == 4
        with open(tmp_path / "x.gif", "rb") as f:
            assert f.read(6) == b"GIF89a"
    else:
        assert [d["step"] for d in served] == [2, 4]
        assert served[0]["paused"] is False
        assert served[0]["neighbors_avg"] > 0
        assert "live view -> http://127.0.0.1:" in capsys.readouterr().err


def test_animate_needs_frames():
    with pytest.raises(SystemExit) as e:
        cli.main(RUN + ["--animate", "x.gif"])
    assert "--animate" in str(e.value.code)


@pytest.mark.parametrize("extra,word", [
    (["--gravity", "tree", "--set", "kernel_gb=0"], "kernel_gb"),
    (["--set", "eos_mode=isothermal"], "eos_mode"),
    (["--gravity", "tree", "--set", "multipole_order=3"],
     "multipole_order"),
    (["--ic", "differentiated_planet"], "tillotson"),
    (["--neighbor", "grid"], "gravity_solver='direct'"),
    (["--neighbor", "grid", "--gravity", "tree", "--set",
      "sph_exact_window=512", "--set", "fuse_p2p_sph=true"],
     "sph_exact_window"),
    (["--neighbor", "grid", "--gravity", "tree", "--set",
      "grav_pair_dtype=float16"], "grav_pair_dtype"),
    (["--neighbor", "grid", "--gravity", "tree", "--set",
      "sorted_chunks=false", "--set", "dtype=bfloat16"], "dtype"),
])
def test_unported_configurations_exit_nonzero_naming_the_option(
        extra, word, capsys):
    assert cli.main(RUN + extra) != 0
    assert word in capsys.readouterr().err


@pytest.mark.parametrize("preset", ["impact", "collision"])
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


IMPACT = ["--preset", "basalt_impact", "--ic", "two_planet_collision",
          "--materials", "basalt,ice", "--separation", "1.1e7",
          "--approach-speed", "3e5", "--n", "256"]


@pytest.mark.parametrize("extra", [
    ["--eos", "adiabatic", "--n", "256"],
    ["--eos", "adiabatic", "--av", "1.0", "--n", "256", "--set",
     "grad_p_mode=grad_h"],
    GRID + ["--eos", "adiabatic", "--av", "1.0", "--set",
            "grad_p_mode=grad_h", "--set", "h_mode=newton", "--set",
            "fuse_p2p_sph=true", "--set", "fuse_p2p_residual=true", "--set",
            "rebuild_every=2"],
    GRID + ["--eos", "adiabatic", "--set", "sg_blocks=4", "--set",
            "blk_window=64"],
    IMPACT,
    ["--preset", "basalt_impact", "--ic", "differentiated_planet",
     "--materials", "iron,basalt", "--n", "256"],
    GRID + ["--eos", "tillotson", "--ic", "two_planet_collision",
            "--materials", "basalt,ice", "--av", "1.0", "--set",
            "g_const=6.674e-8", "--set", "total_mass=2.8e21", "--set",
            "radius=5e6", "--set", "particle_radius=1.45e6", "--set",
            "u0=1e9", "--set", "h_max=5e6", "--separation", "1.1e7",
            "--approach-speed", "3e5", "--dt", "0.05", "--set",
            "nbr_window=192"],
], ids=["eos_adiabatic_dense", "eos_adiabatic_dense_gradh_av",
        "eos_adiabatic_grid_merged_cached", "eos_adiabatic_supergroups",
        "preset_basalt_impact_materials", "differentiated_planet",
        "eos_tillotson_grid_two_materials"])
def test_run_energy_options_this_slice_opened(extra, tmp_path, capsys):
    """--eos, --materials, --ic differentiated_planet and --preset
    basalt_impact run a few steps; the internal energy is the evolved one."""
    m = str(tmp_path / "m.jsonl")
    assert cli.main(["run", "--device", "cpu", "--steps", "4",
                     "--diag-every", "2", "--metrics-jsonl", m] + extra) == 0
    last = _rows(m)[-1]
    assert last["step"] == 4 and last["total_energy"] == last["total_energy"]
    assert last["nbr_overflow"] == 0 == last["tree_overflow"]
    assert last["internal_energy"] > 0.0
    assert "WARNING" not in capsys.readouterr().err


def test_eos_flag_and_preset_reach_the_config():
    ns = dict(n=None, seed=None, dt=None, integrator=None, gravity=None,
              neighbor=None, freeze_velocity=False, av=None, balsara=False,
              set=[])
    cfg = cli._build_cfg(cli.argparse.Namespace(
        eos="tillotson", preset="jupiter_3k", **ns))
    assert cfg.eos_mode == "tillotson" and cfg.evolves_u
    cfg = cli._build_cfg(cli.argparse.Namespace(
        eos=None, preset="basalt_impact", **ns))
    assert (cfg.eos_mode, cfg.dt_mode, cfg.n, cfg.u0) == (
        "tillotson", "cfl", 4096, 1e9)


def test_bench_basalt_impact_cold_start(capsys):
    assert bench.main(["--device", "cpu", "--preset", "basalt_impact",
                       "--n", "256", "--ic", "two_planet_collision",
                       "--materials", "basalt,ice", "--separation", "1.1e7",
                       "--approach-speed", "3e5", "--steps", "2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["n"] == 256 and res["operating_point"] == "early_transient"
    assert cli.main(["bench", "--device", "cpu", "--preset",
                     "basalt_impact", "--n", "128", "--ic",
                     "differentiated_planet", "--steps", "1"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "n"] == 128


def test_state_from_a_polytropic_run_gets_a_thermal_state():
    """A polytropic run never updates u, so its state file carries the
    initial conditions' u: switching the evolved energy on starts u from
    the polytropic relation at the stored density (same pressure for
    gamma = 2); a state that already evolves u keeps it."""
    from planetmodel_sph_tpu_torch import config as tc
    from planetmodel_sph_tpu_torch import state as tstate
    from planetmodel_sph_tpu_torch.ops import eos as eos_ops
    poly = tc.jupiter_3k(n=8)
    st = tstate.zeros(poly, device="cpu")
    st = st.replace(rho=torch.linspace(0.5, 2.0, 8), u=torch.full((8,), 9.0))
    adia = poly.replace(eos_mode="adiabatic")
    out = bench.with_thermal_state(st, poly, adia)
    assert torch.equal(out.u, poly.eos_k * st.rho)
    assert torch.allclose(eos_ops.pressure_cfg(out.rho, adia, u=out.u),
                          eos_ops.pressure_cfg(st.rho, poly))
    assert bench.with_thermal_state(st, adia, adia).u is st.u
    assert bench.with_thermal_state(st, poly, poly).u is st.u


def test_devices_runs_the_data_parallel_path(tmp_path, capfd):
    """--devices 2 on the CPU: two gloo ranks started by the command, rank
    0 logging the steps/s line "(dp x2)", the diagnostics rows, the metrics
    trail, the checkpoint and the drift line."""
    metrics = str(tmp_path / "m.jsonl")
    ck = str(tmp_path / "dp.psph")
    assert cli.main(["run", "--device", "cpu", "--n", "512", "--devices",
                     "2", "--steps", "4", "--diag-every", "2",
                     "--metrics-jsonl", metrics, "--checkpoint", ck]) == 0
    err = capfd.readouterr().err
    assert "4 steps in" in err and "(dp x2)" in err
    assert "energy drift:" in err and "WARNING" not in err
    rows = _rows(metrics)
    assert [r["step"] for r in rows] == [2, 4]
    assert rows[-1]["nbr_overflow"] == 0 == rows[-1]["tree_overflow"]
    state, cfg, step = snapshot.load(ck, device="cpu")
    assert step == 4 and cfg.n == 512 and state.n == 512
    assert bool(torch.isfinite(state.pos).all())


def test_devices_refusals(capfd):
    """An n the ranks cannot share exits 2; the halo layout on dense
    neighbours (which it cannot serve) and the frame options are refused by
    name."""
    assert cli.main(["run", "--device", "cpu", "--n", "511", "--devices",
                     "2", "--steps", "2"]) == 2
    assert "not divisible by 2" in capfd.readouterr().err
    with pytest.raises(SystemExit) as e:
        cli.main(RUN + ["--devices", "4", "--set", "dp_mode=halo"])
    assert "dp_mode=halo" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        cli.main(RUN + ["--devices", "2", "--render-every", "2"])
    assert "--devices" in str(e.value.code) \
        and "--render-every" in str(e.value.code)
