"""npz checkpoints (``utils/checkpoint.py``) of the port against the JAX
package's: a file either package writes loads in the other with every
field bit for bit, the config and the step; ``load`` tells PSPH1 from npz
by the magic, drops config keys it does not know and back-fills state
fields the file lacks; the CLI writes and resumes from an npz."""

import dataclasses
import json

import numpy as np
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu import state as jstate
from planetmodel_sph_tpu.utils import checkpoint as jck
from planetmodel_sph_tpu_torch import cli
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.runtime import snapshot as tsnap
from planetmodel_sph_tpu_torch.utils import checkpoint as tck

KW = dict(n=300, neighbor_mode="grid", gravity_solver="tree",
          sph_exact_window=512, eos_mode="adiabatic", h_solve_window=768)


def _arrays(n=300, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for f in dataclasses.fields(jstate.ParticleState):
        if f.name in ("n_neighbors", "n_direct", "n_approx", "matid"):
            out[f.name] = rng.integers(0, 99, n).astype(np.int32)
        elif f.name in ("pos", "vel", "grad_p", "grad_phi", "accel"):
            out[f.name] = rng.normal(size=(n, 3)).astype(np.float32)
        else:
            out[f.name] = rng.uniform(0.1, 2.0, n).astype(np.float32)
    return out


def _same(state, arrays):
    for k, v in arrays.items():
        a = np.asarray(getattr(state, k))
        assert a.dtype == v.dtype and a.shape == v.shape, k
        np.testing.assert_array_equal(a, v, err_msg=k)


def test_npz_round_trip_in_the_port(tmp_path):
    arrays = _arrays()
    cfg = tc.SimConfig(**KW)
    path = str(tmp_path / "ck")              # no suffix: written as named
    tck.save(path, tstate.from_numpy(arrays, device="cpu"), cfg, step=12)
    state, cfg2, step = tck.load(path, device="cpu")
    assert step == 12 and cfg2 == cfg
    _same(state, arrays)


def test_jax_npz_loads_in_the_port(tmp_path):
    arrays = _arrays(seed=1)
    jcfg = jc.SimConfig(**KW)
    path = str(tmp_path / "jax.npz")
    jck.save(path, jstate.ParticleState(**arrays), jcfg, step=5)
    state, cfg, step = tck.load(path, device="cpu")
    assert step == 5
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _same(state, arrays)


def test_port_npz_loads_in_jax(tmp_path):
    arrays = _arrays(seed=2)
    cfg = tc.SimConfig(**KW)
    path = str(tmp_path / "port.npz")
    tck.save(path, tstate.from_numpy(arrays, device="cpu"), cfg, step=9)
    state, jcfg, step = jck.load(path)
    assert step == 9
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    _same(state, arrays)


def test_load_detects_psph_by_its_magic(tmp_path):
    arrays = _arrays(seed=3)
    cfg = tc.SimConfig(**KW)
    st = tstate.from_numpy(arrays, device="cpu")
    a = str(tmp_path / "a.psph")
    tck.save(a, st, cfg, step=3)              # .psph: PSPH1
    assert open(a, "rb").read(5) == b"PSPH1"
    b = str(tmp_path / "b.bin")
    tsnap.save(b, st, cfg, step=4)             # PSPH1 under another name
    for path, want in ((a, 3), (b, 4)):
        state, cfg2, step = tck.load(path, device="cpu")
        assert step == want and cfg2 == cfg
        _same(state, arrays)


def test_load_drops_unknown_keys_and_backfills_fields(tmp_path):
    arrays = _arrays(seed=4)
    for k in ("u", "du_dt", "matid", "balsara"):
        del arrays[k]
    raw = dict(dataclasses.asdict(tc.SimConfig(**KW)), tree_leaf_size=16)
    path = str(tmp_path / "old.npz")
    with open(path, "wb") as f:
        np.savez(f, __config__=np.frombuffer(json.dumps(raw).encode(),
                                             dtype=np.uint8),
                 __step__=np.asarray(2, np.int64), **arrays)
    state, cfg, step = tck.load(path, device="cpu")
    assert step == 2 and cfg == tc.SimConfig(**KW)
    rho = torch.from_numpy(arrays["rho"])
    torch.testing.assert_close(state.u, cfg.eos_k * rho / (
        cfg.eos_gamma - 1.0), rtol=1e-6, atol=0)
    assert float(state.du_dt.abs().sum()) == 0.0
    assert bool((state.balsara == 1.0).all())
    assert state.matid.dtype == torch.int32


def test_cli_npz_checkpoint_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "run.npz")
    run = ["run", "--device", "cpu", "--n", "256", "--steps", "4",
           "--diag-every", "2"]
    assert cli.main(run + ["--checkpoint", ck]) == 0
    state, cfg, step = tck.load(ck, device="cpu")
    assert step == 4 and cfg.n == 256
    jst, jcfg, jstep = jck.load(ck)          # the reference reads it too
    assert jstep == 4 and jcfg.n == 256
    np.testing.assert_array_equal(np.asarray(jst.pos), state.pos.numpy())
    assert cli.main(["run", "--device", "cpu", "--restore", ck, "--steps",
                     "2", "--diag-every", "2", "--checkpoint", ck]) == 0
    state6, _, step6 = tck.load(ck, device="cpu")
    assert step6 == 6 and not torch.equal(state6.pos, state.pos)
    assert "restored" in capsys.readouterr().err
