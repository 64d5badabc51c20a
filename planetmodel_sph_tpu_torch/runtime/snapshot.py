"""PSPH1 snapshots (PyTorch port).

Byte-compatible with the JAX package's native writer
(``planetmodel_sph_tpu/runtime/psph_io.cpp``), little-endian:

    [8]  magic "PSPH1\\n\\0\\0"
    [8]  u64 header_len, [header_len] JSON header (step, config, fields)
    per field: [8] u64 nbytes, [nbytes] raw data, [4] u32 CRC32 (zlib)
    [8]  u64 trailer 0x50535048454E4421 ("PSPHEND!")

Files are written and read through the port's own copy of that writer
(``runtime/psph_io.cpp``, built with g++ at first use: ``runtime/native.py``),
whose background thread streams each frame with its CRC while the next is
queued. Where it cannot be built, numpy writes and reads the same bytes.
The first write of a process says which writer ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import struct
import sys
import zlib

import numpy as np
import torch

from . import native
from .. import config as config_mod
from ..state import ParticleState, resolve_device, to_numpy
from ..utils.checkpoint import _fill_missing

MAGIC = b"PSPH1\n\0\0"
TRAILER = 0x50535048454E4421
_MAX_HEADER = 64 << 20
_ANNOUNCED = False


def _announce(lib) -> None:
    global _ANNOUNCED
    if not _ANNOUNCED:
        _ANNOUNCED = True
        which = (f"the native writer ({native.lib_path()})" if lib is not None
                 else "the numpy writer (the native one did not build)")
        print(f"PSPH1 snapshots through {which}", file=sys.stderr,
              flush=True)


def _frames(arrays):
    return [np.ascontiguousarray(a) for a in arrays]


def write_numpy(path: str, header: dict, arrays) -> None:
    """Write a header dict and a list of numpy arrays as PSPH1 frames."""
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for a in _frames(arrays):
            data = a.tobytes()
            f.write(struct.pack("<Q", len(data)))
            f.write(data)
            f.write(struct.pack("<I", zlib.crc32(data) & 0xFFFFFFFF))
        f.write(struct.pack("<Q", TRAILER))


def write_native(lib, path: str, header: dict, arrays) -> None:
    """The same file through the native writer `lib` (``native.load()``)."""
    frames = _frames(arrays)
    w = lib.psph_writer_open(path.encode(), json.dumps(header).encode())
    if not w:
        raise IOError(f"cannot open {path} for writing")
    ok = True
    for a in frames:
        ok &= lib.psph_writer_write(
            w, a.ctypes.data_as(ctypes.c_void_p), a.nbytes) == 0
    # close whatever happened: joins the flush thread, releases the file
    ok &= lib.psph_writer_close(w) == 0
    if not ok:
        raise IOError(f"native PSPH1 write failed: {path}")


def write(path: str, header: dict, arrays) -> None:
    """Write a PSPH1 file through the native writer, or numpy without it."""
    lib = native.load()
    _announce(lib)
    if lib is None:
        write_numpy(path, header, arrays)
    else:
        write_native(lib, path, header, arrays)


def read_numpy(path: str):
    """Read a PSPH1 file -> (header dict, {field name: numpy array}).
    Raises IOError on a bad magic, a short frame or a CRC mismatch."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise IOError(f"not a PSPH1 snapshot: {path}")
        (hlen,) = struct.unpack("<Q", f.read(8))
        if hlen > _MAX_HEADER:
            raise IOError(f"corrupt PSPH1 header length {hlen}: {path}")
        header = json.loads(f.read(hlen).decode())
        out = {}
        for spec in header["fields"]:
            raw = f.read(8)
            if len(raw) != 8:
                raise IOError(f"truncated frame for {spec['name']}")
            (n,) = struct.unpack("<Q", raw)
            dtype = np.dtype(spec["dtype"])
            expect = int(np.prod(spec["shape"], dtype=np.int64)) \
                * dtype.itemsize
            if n != expect:
                raise IOError(f"corrupt frame for field {spec['name']}: "
                              f"{n} bytes, expected {expect}")
            data = f.read(n)
            crc = f.read(4)
            if len(data) != n or len(crc) != 4 or \
                    struct.unpack("<I", crc)[0] != zlib.crc32(data):
                raise IOError(f"corrupt frame for field {spec['name']}")
            out[spec["name"]] = np.frombuffer(data, dtype=dtype).reshape(
                spec["shape"]).copy()
    return header, out


def read_native(lib, path: str):
    """:func:`read_numpy` through the native reader `lib`: the same result
    and the same errors."""
    r = lib.psph_reader_open(path.encode())
    if not r:
        raise IOError(f"not a PSPH1 snapshot: {path}")
    try:
        hlen = lib.psph_reader_header(r, None, 0)
        buf = ctypes.create_string_buffer(hlen + 1)
        lib.psph_reader_header(r, buf, hlen + 1)
        header = json.loads(buf.value.decode())
        out = {}
        for spec in header["fields"]:
            a = np.empty(spec["shape"], dtype=np.dtype(spec["dtype"]))
            got = lib.psph_reader_next(r, a.ctypes.data_as(ctypes.c_void_p),
                                       a.nbytes)
            if got != a.nbytes:
                raise IOError(f"corrupt frame for field {spec['name']} "
                              f"(rc={got})")
            out[spec["name"]] = a
        return header, out
    finally:
        lib.psph_reader_close(r)


def read(path: str):
    """Read a PSPH1 file -> (header dict, {field name: numpy array}),
    through the native reader where it builds."""
    lib = native.load()
    return read_numpy(path) if lib is None else read_native(lib, path)


def save(path: str, state: ParticleState, cfg, step: int = 0) -> None:
    """Write a state and its config as a PSPH1 snapshot."""
    arrays = to_numpy(state)
    header = {
        "format": "PSPH1",
        "step": step,
        "config": dataclasses.asdict(cfg),
        "fields": [{"name": k, "dtype": str(a.dtype), "shape": list(a.shape)}
                   for k, a in arrays.items()],
    }
    write(path, header, list(arrays.values()))


def load(path: str, device="cuda"):
    """Read a PSPH1 snapshot -> (state, cfg, step) on `device`."""
    dev = resolve_device(device)
    header, arrays = read(path)
    cfg = config_mod.from_dict(header["config"])
    known = {f.name for f in dataclasses.fields(ParticleState)}
    fields = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()
              if k in known}
    return _fill_missing(fields, cfg), cfg, int(header["step"])
