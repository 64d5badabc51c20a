"""``cli run --debug-nans`` on the CPU (``utils/debug_nans.py``).

The reference's flag sets ``jax_debug_nans``: a NaN in an output of a
jitted computation raises ``FloatingPointError`` naming the first
primitive that made one. The port checks each chunk's state and, on a NaN,
re-runs the chunk with every op and kernel wrapper checked. These tests
hold: a clean run with the flag gives the bits of one without it; a state
with one planted NaN mass stops the run (chunks and frames, one device and
two gloo ranks) with ``FloatingPointError`` naming the field, the step and
the first op or kernel, with no checkpoint written, where the JAX package
raises ``FloatingPointError`` on the same state; on the grid path a
kernel wrapper that puts out a NaN is named.
"""

import os

import jax
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu.models import planet as jplanet
from planetmodel_sph_tpu.utils import checkpoint as jcheckpoint
from planetmodel_sph_tpu_torch import cli
from planetmodel_sph_tpu_torch.utils import checkpoint

RUN = ["run", "--device", "cpu", "--n", "512", "--steps", "4",
       "--diag-every", "2"]
GRID = ["--neighbor", "grid", "--gravity", "tree", "--set",
        "nbr_group_level=2", "--set", "nbr_group_size=32"]


def _same_files(a, b):
    fa, fb = np.load(a), np.load(b)
    return sorted(fa.files) == sorted(fb.files) and all(
        np.array_equal(fa[k], fb[k]) for k in fa.files)


@pytest.fixture(scope="module")
def nan_state(tmp_path_factory):
    """A dense run's checkpoint (npz) after 2 steps, and the same state
    with the mass of particle 17 made NaN."""
    d = tmp_path_factory.mktemp("dn")
    clean, bad = str(d / "clean.npz"), str(d / "nan.npz")
    assert cli.main(RUN[:-4] + ["--steps", "2", "--checkpoint", clean]) == 0
    state, cfg, step = checkpoint.load(clean, device="cpu")
    state.mass[17] = float("nan")
    checkpoint.save(bad, state, cfg, step)
    return clean, bad


@pytest.mark.parametrize("extra", [[], GRID], ids=["dense", "grid"])
def test_clean_run_gives_the_same_bits_with_the_flag(extra, tmp_path):
    outs = []
    for flag in ([], ["--debug-nans"]):
        ck = str(tmp_path / f"x{len(outs)}.npz")
        m = str(tmp_path / f"m{len(outs)}.jsonl")
        assert cli.main(RUN[:-4] + extra + flag + [
            "--steps", "2", "--diag-every", "1", "--checkpoint", ck,
            "--metrics-jsonl", m]) == 0
        outs.append((ck, open(m).read()))
    assert _same_files(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


@pytest.mark.parametrize("extra", [[], ["--render-every", "1"]],
                         ids=["chunks", "frames"])
def test_planted_nan_stops_the_run_naming_field_step_and_op(
        extra, nan_state, tmp_path):
    _, bad = nan_state
    ck = str(tmp_path / "never.npz")
    if extra:
        extra = extra + ["--render-every-dir", str(tmp_path / "frames")]
    with pytest.raises(FloatingPointError) as e:
        cli.main(["run", "--device", "cpu", "--restore", bad, "--steps",
                  "4", "--diag-every", "2", "--debug-nans",
                  "--checkpoint", ck] + extra)
    msg = str(e.value)
    assert "mass" in msg and "global step 3" in msg, msg
    assert "step 1 of the chunk" in msg and "came out of" in msg, msg
    assert not os.path.exists(ck)
    # the reference raises too, on the same state
    jstate, jcfg, _ = jcheckpoint.load(bad)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jplanet.run(jstate, jcfg, 2).pos)


def test_without_the_flag_a_nan_runs_on(nan_state, capfd):
    _, bad = nan_state
    assert cli.main(["run", "--device", "cpu", "--restore", bad, "--steps",
                     "2", "--diag-every", "2"]) == 0
    assert "step 4:" in capfd.readouterr().err


def test_grid_path_names_the_kernel_wrapper(monkeypatch, tmp_path):
    """A windowed kernel that puts out a NaN on the grid + tree step (here
    pass 2, made to, on its first target): the re-run checks each kernel
    wrapper of ops/cuda/groups2.py as it returns and names it, with the
    step."""
    from planetmodel_sph_tpu_torch.ops.cuda import groups2 as gk2
    clean = str(tmp_path / "g.npz")
    assert cli.main(RUN[:-4] + GRID + ["--steps", "1", "--checkpoint",
                                       clean]) == 0
    pass2 = gk2.pass2

    def faulty(*a, **kw):
        out = pass2(*a, **kw)
        out[0][0] = float("nan")
        return out
    monkeypatch.setattr(gk2, "pass2", faulty)
    with pytest.raises(FloatingPointError) as e:
        cli.main(["run", "--device", "cpu", "--restore", clean, "--steps",
                  "1", "--diag-every", "1", "--debug-nans", "--checkpoint",
                  str(tmp_path / "never.npz")])
    msg = str(e.value)
    assert "the pass2 kernel wrapper (its plain version on the CPU) at " \
        "step 1 of the chunk (global step 2)" in msg, msg
    assert "grad_p" in msg and "after the chunk of steps 2-2" in msg, msg
    assert not os.path.exists(tmp_path / "never.npz")


def test_every_rank_stops_under_devices(nan_state):
    """--devices 2: both gloo ranks check each chunk, all-reduce the
    verdict, re-run it and raise, instead of waiting in a collective."""
    _, bad = nan_state
    with pytest.raises(Exception) as e:
        cli.main(["run", "--device", "cpu", "--restore", bad, "--steps",
                  "2", "--diag-every", "2", "--devices", "2",
                  "--debug-nans"])
    msg = str(e.value)
    assert "FloatingPointError: --debug-nans: NaN in the state's " in msg
    assert " on rank " in msg and "(global step 3)" in msg, msg
    assert torch.distributed.is_initialized() is False
