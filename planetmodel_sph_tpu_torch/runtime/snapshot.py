"""PSPH1 snapshots in pure numpy (PyTorch port).

Byte-compatible with the native writer of the reference
(``planetmodel_sph_tpu/runtime/psph_io.cpp:9-13``), little-endian:

    [8]  magic "PSPH1\\n\\0\\0"
    [8]  u64 header_len, [header_len] JSON header (step, config, fields)
    per field: [8] u64 nbytes, [nbytes] raw data, [4] u32 CRC32 (zlib)
    [8]  u64 trailer 0x50535048454E4421 ("PSPHEND!")
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib

import numpy as np
import torch

from .. import config as config_mod
from ..state import ParticleState, resolve_device, to_numpy
from ..utils.checkpoint import _fill_missing

MAGIC = b"PSPH1\n\0\0"
TRAILER = 0x50535048454E4421
_MAX_HEADER = 64 << 20


def write(path: str, header: dict, arrays) -> None:
    """Write a header dict and a list of numpy arrays as PSPH1 frames."""
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for a in arrays:
            data = np.ascontiguousarray(a).tobytes()
            f.write(struct.pack("<Q", len(data)))
            f.write(data)
            f.write(struct.pack("<I", zlib.crc32(data) & 0xFFFFFFFF))
        f.write(struct.pack("<Q", TRAILER))


def read(path: str):
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
