"""A NumPy reader of PSPH1 snapshots, the repository's state format.

Little-endian: [8] magic "PSPH1\\n\\0\\0", [8] u64 header length, the JSON
header (step, config, fields), then per field [8] u64 byte count, the raw
array and [4] its CRC32 (zlib), then [8] the trailer "PSPHEND!".
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

MAGIC = b"PSPH1\n\0\0"
_MAX_HEADER = 64 << 20


def read(path: str):
    """(header dict, {field name: numpy array}); raises IOError on a bad
    magic, a short frame or a CRC mismatch."""
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
            (nbytes,) = struct.unpack("<Q", raw)
            dtype = np.dtype(spec["dtype"])
            want = int(np.prod(spec["shape"], dtype=np.int64)) * dtype.itemsize
            data = f.read(nbytes)
            crc = f.read(4)
            if (nbytes != want or len(data) != nbytes or len(crc) != 4
                    or struct.unpack("<I", crc)[0] != zlib.crc32(data)):
                raise IOError(f"corrupt frame for field {spec['name']}")
            out[spec["name"]] = np.frombuffer(data, dtype=dtype).reshape(
                spec["shape"]).copy()
    return header, out
