"""The port's native PSPH1 writer and reader (``runtime/psph_io.cpp``
through ``runtime/native.py``): the C++ writer and the numpy writer give
byte-identical files, both readers give back the same arrays and refuse
the same corruptions, the JAX package's ``runtime/snapshot.load`` reads
the port's files, and ``utils/checkpoint.save`` of a ``.psph`` path goes
through the native writer. The library builds with g++ at first use; the
tests that need it are skipped only where g++ is absent, and the numpy
writer then writes the same bytes (checked against the reference's
files in ``test_torch_snapshot.py``)."""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from planetmodel_sph_tpu.runtime import snapshot as jsnap
from planetmodel_sph_tpu_torch import config as tc
from planetmodel_sph_tpu_torch.runtime import native
from planetmodel_sph_tpu_torch.runtime import snapshot as tsnap
from planetmodel_sph_tpu_torch.state import from_numpy
from planetmodel_sph_tpu_torch.utils import checkpoint

from test_torch_snapshot import _arrays, native_lib  # noqa: F401

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ is absent: the native PSPH1 "
                                "writer cannot be built here")


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, "g++ is present but the library did not build"
    return lib


def _header(arrays, step=3, cfg=None):
    return {"format": "PSPH1", "step": step,
            "config": dataclasses.asdict(cfg or tc.jupiter_100k(n=300)),
            "fields": [{"name": k, "dtype": str(a.dtype),
                        "shape": list(a.shape)} for k, a in arrays.items()]}


def test_library_builds_into_the_build_directory(lib):
    path = native.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.dirname(native.SRC)), "build")
    assert not [f for f in os.listdir(os.path.dirname(native.SRC))
                if f.endswith(".so")]


@pytest.mark.parametrize("n", [1, 300, 4097])
def test_native_and_numpy_writers_give_the_same_bytes(lib, n, tmp_path):
    arrays = _arrays(n=n, seed=n)
    hdr = _header(arrays)
    a, b = str(tmp_path / "native.psph"), str(tmp_path / "numpy.psph")
    tsnap.write_native(lib, a, hdr, list(arrays.values()))
    tsnap.write_numpy(b, hdr, list(arrays.values()))
    assert open(a, "rb").read() == open(b, "rb").read()
    for read in (tsnap.read_numpy, lambda p: tsnap.read_native(lib, p)):
        h, got = read(a)
        assert h == hdr and list(got) == list(arrays)
        for k, v in arrays.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, k)


def test_reference_reads_the_native_files(lib, native_lib, tmp_path):
    arrays = _arrays(seed=5)
    path = str(tmp_path / "port.psph")
    checkpoint.save(path, from_numpy(arrays, device="cpu"),
                    tc.jupiter_3k(), 11)
    st, cfg, step = jsnap.load(path)
    assert step == 11 and cfg.n == 3000
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(getattr(st, k)), v, k)
    # and the port reads it back through either reader
    state, cfg2, step2 = checkpoint.load(path, device="cpu")
    assert step2 == 11 and cfg2 == tc.jupiter_3k()
    np.testing.assert_array_equal(state.pos.numpy(), arrays["pos"])


def test_native_reader_refuses_corruption(lib, tmp_path):
    arrays = _arrays(n=50)
    path = str(tmp_path / "bad.psph")
    tsnap.write_native(lib, path, _header(arrays), list(arrays.values()))
    raw = bytearray(open(path, "rb").read())
    raw[-40] ^= 0xFF                       # inside the last field's data
    open(path, "wb").write(bytes(raw))
    for read in (tsnap.read_numpy, lambda p: tsnap.read_native(lib, p)):
        with pytest.raises(IOError, match="corrupt"):
            read(path)
    open(path, "wb").write(b"NOTPSPH" + bytes(raw[7:]))
    for read in (tsnap.read_numpy, lambda p: tsnap.read_native(lib, p)):
        with pytest.raises(IOError, match="not a PSPH1"):
            read(path)


def test_write_goes_through_the_native_writer(lib, tmp_path, monkeypatch):
    """`snapshot.write` takes the native library when it loads, and numpy
    without it; the two files are the same bytes."""
    arrays = _arrays(n=64)
    calls = []
    monkeypatch.setattr(tsnap, "write_native",
                        lambda *a: calls.append("native") or
                        tsnap.write_numpy(*a[1:]))
    tsnap.write(str(tmp_path / "a.psph"), _header(arrays),
                list(arrays.values()))
    assert calls == ["native"]
    monkeypatch.setattr(native, "load", lambda: None)
    tsnap.write(str(tmp_path / "b.psph"), _header(arrays),
                list(arrays.values()))
    assert calls == ["native"]
    assert open(tmp_path / "a.psph", "rb").read() == \
        open(tmp_path / "b.psph", "rb").read()
