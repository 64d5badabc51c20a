"""The port's pure-numpy PSPH1 reader and writer against the JAX package's
native one (``runtime/psph_io.cpp`` through ctypes): files written by
either are read by the other, and the in-repo settled 100k state reads
correctly."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from planetmodel_sph_tpu import config as jc
from planetmodel_sph_tpu import state as jstate
from planetmodel_sph_tpu.runtime import native
from planetmodel_sph_tpu.runtime import snapshot as jsnap
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch import state as tstate
from planetmodel_sph_tpu_torch.runtime import snapshot as tsnap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTLED = os.path.join(ROOT, "docs", "results", "drift100k_r5ship",
                       "state.psph")


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


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The JAX package's native PSPH1 library, built for this test process
    alone. Its loader compiles straight into one file beside its source,
    and after a failed load never tries again: test processes that start
    at once (pytest-xdist) load a file that another one is still writing
    and lose the library ("native runtime unavailable"). Here it builds
    into a directory of this process's own, and the loader's state is
    restored afterwards."""
    path = str(tmp_path_factory.mktemp("jax_native") / "_psph_io.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "lib_path", lambda: path)
        mp.setattr(native, "_LIB", None)
        mp.setattr(native, "_TRIED", False)
        lib = native.load()
        if lib is None:
            pytest.fail("the JAX package's native PSPH1 library did not "
                        "build")
        yield lib


def test_port_writes_jax_reads(tmp_path, native_lib):
    arrays = _arrays()
    path = str(tmp_path / "port.psph")
    tsnap.save(path, tstate.from_numpy(arrays, device="cpu"),
               tc.jupiter_100k(n=300), step=17)
    st, cfg, step = jsnap.load(path)
    assert step == 17 and cfg == jc.jupiter_100k(n=300)
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(st, k)), v, k)


def test_jax_writes_port_reads(tmp_path, native_lib):
    arrays = _arrays(seed=1)
    path = str(tmp_path / "jax.psph")
    st = jstate.ParticleState(**{k: jnp.asarray(v)
                                 for k, v in arrays.items()})
    assert jsnap.save(path, st, jc.jupiter_3k(), step=5)
    out, cfg, step = tsnap.load(path, device="cpu")
    assert step == 5 and cfg == tc.jupiter_3k()
    for k, v in arrays.items():
        np.testing.assert_array_equal(getattr(out, k).numpy(), v, k)
    # byte for byte the same file
    again = str(tmp_path / "again.psph")
    tsnap.save(again, out, cfg, step=5)
    assert open(again, "rb").read() == open(path, "rb").read()


def test_settled_100k_state_reads(native_lib):
    header, arrays = tsnap.read(SETTLED)
    assert header["step"] == 12000 and header["format"] == "PSPH1"
    assert [f["name"] for f in header["fields"]] == list(arrays)
    st, cfg, step = tsnap.load(SETTLED, device="cpu")
    assert st.n == cfg.n == 100_000 and step == 12000
    assert cfg.rebuild_every == 32 and cfg.respa_every == 32
    ref, jcfg, _ = jsnap.load(SETTLED)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    for f in dataclasses.fields(jstate.ParticleState):
        a, b = getattr(st, f.name), np.asarray(getattr(ref, f.name))
        assert a.dtype == torch.from_numpy(b).dtype, f.name
        np.testing.assert_array_equal(a.numpy(), b, f.name)
    assert bool(torch.isfinite(st.pos).all()) and float(st.mass.min()) > 0


def test_corrupt_frame_refused(tmp_path):
    path = str(tmp_path / "bad.psph")
    arrays = _arrays(n=50)
    tsnap.save(path, tstate.from_numpy(arrays, device="cpu"), tc.default())
    raw = bytearray(open(path, "rb").read())
    raw[-40] ^= 0xFF                       # inside the last field's data
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        tsnap.read(path)
    open(path, "wb").write(b"NOTPSPH" + bytes(raw[7:]))
    with pytest.raises(IOError, match="not a PSPH1"):
        tsnap.read(path)
