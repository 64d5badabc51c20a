"""Morton (Z-order) codes for spatial sorting (PyTorch port).

10 bits per axis interleaved into a 30-bit code, as in
``planetmodel_sph_tpu.ops.morton``. The bit dilation runs in int64 with
masks (PyTorch has few uint32 operations); every intermediate stays below
2^32, so the codes equal the reference's uint32 arithmetic bit for bit.
"""

from __future__ import annotations

import torch

BITS_PER_AXIS = 10
MAX_LEVEL = BITS_PER_AXIS


def expand_bits(x):
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def encode(pos, lo, hi):
    """30-bit Morton codes (int32) for pos [N,3] within the box [lo, hi]."""
    span = torch.clamp(hi - lo, min=1e-30)
    u = (pos - lo) / span
    q = torch.clamp((u * 1024.0).to(torch.int32), 0, 1023)
    code = (expand_bits(q[:, 0])
            | (expand_bits(q[:, 1]) << 1)
            | (expand_bits(q[:, 2]) << 2))
    return code.to(torch.int32)


def cell_of(code, level):
    """Level-l cell id of a 30-bit code (its 3l-bit prefix)."""
    return code >> (3 * (MAX_LEVEL - level))
