"""Hardware probes of the roofline and microbench tools (PyTorch port).

Counterpart of the four Pallas kernels in ``tools/roofline.py`` and
``tools/microbench.py``. Each has

- a wrapper (:func:`probe_fma`, :func:`probe_launch`, :func:`probe_gather`,
  :func:`probe_pass1_tile`) that checks device, dtype, shape and
  contiguity. For CPU tensors it runs the plain version; for CUDA tensors
  it launches the hand-written kernel (``csrc/probe_*.cu``) on the current
  stream or raises. It never falls back;
- a plain PyTorch version (``*_plain``) of the same function;
- a launch counter, ``LAUNCHES[name]`` (shared with every kernel module,
  see ``launch.py``), incremented only where the wrapper launches.

The kernels compute the probes' functions, not the Pallas block layouts:
the FMA chain and the trivial multiply of the roofline tool, the
window-row gather and the pass-1 tile sweep of the microbench tool.
"""

from __future__ import annotations

import torch

from .launch import (LAUNCHES, is_cuda, launch, need,  # noqa: F401
                     reset_launches)

INV_PI = 1.0 / 3.14159265358979323846
_F32 = torch.float32
KERNELS = ("probe_fma", "probe_launch", "probe_gather", "probe_pass1_tile")
LAUNCH_SCALE = 1.000001


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def probe_fma_plain(x, reps: int):
    """acc = x, then reps times acc = acc * x + x four times (each step
    rounds twice: a multiply and an add)."""
    acc = x
    for _ in range(4 * reps):
        acc = acc * x + x
    return acc


def probe_launch_plain(x):
    return x * LAUNCH_SCALE


def probe_gather_plain(packed, idx):
    """out[g, w, :] = packed[clamp(idx[g, w], 0, nb - 1), :]."""
    return packed[torch.clamp(idx, 0, packed.shape[0] - 1).long()]


def tile_extent(nv, s: int, chunk: int):
    """Slots each instance sums: min(nv, trips * chunk) with trips =
    min(ceil(nv / chunk), s // chunk), the reference's loop bound."""
    trips = torch.clamp(torch.minimum(-(-nv // chunk),
                                      torch.full_like(nv, s // chunk)),
                        min=0)
    return torch.minimum(nv, trips * chunk)


def _spline_w(r2, inv_h):
    """The reference tool's W on the signed q = r * ih (a negative q takes
    the inner branch, the prefactor keeps the sign of ih^3)."""
    r = torch.sqrt(r2)
    q = r * inv_h
    c = INV_PI * inv_h * inv_h * inv_h
    q2 = q * q
    inner = 1.0 - 1.5 * q2 + 0.75 * q2 * q
    t = 2.0 - q
    outer = 0.25 * t * t * t
    return torch.where(q < 1.0, inner,
                       torch.where(q < 2.0, outer, 0.0)) * c


def probe_pass1_tile_plain(nv, tgt, rows, chunk: int = 512, block: int = 32):
    """(rho, sum |m W|) per target, [gb*tb, 1] each: the masked sum over the
    first tile_extent slots of each instance with live > 0.5. Instances go
    `block` at a time so the [block, tb, S] intermediates stay small."""
    tx, ty, tz, tih = tgt
    sx, sy, sz, sm, slv = rows
    gb, s = sx.shape
    tb = tx.shape[0] // gb
    ext = tile_extent(nv, s, chunk)
    width = int(ext.max()) if gb else 0
    slot = torch.arange(width, device=nv.device)
    rho, mag = [], []
    for g0 in range(0, gb, block):
        g1 = min(gb, g0 + block)
        col = lambda c: c[g0 * tb:g1 * tb].reshape(g1 - g0, tb, 1)
        row = lambda r: r[g0:g1, None, :width]
        dxx = col(tx) - row(sx)
        dxy = col(ty) - row(sy)
        dxz = col(tz) - row(sz)
        r2 = dxx * dxx + dxy * dxy + dxz * dxz
        pair = (slot[None, None, :] < ext[g0:g1, None, None]) \
            & (row(slv) > 0.5)
        term = torch.where(pair, row(sm), 0.0) * _spline_w(r2, col(tih))
        rho.append(term.sum(dim=2).reshape(-1, 1))
        mag.append(term.abs().sum(dim=2).reshape(-1, 1))
    if not rho:
        z = torch.zeros((0, 1), dtype=tx.dtype, device=tx.device)
        return z, z.clone()
    return torch.cat(rho), torch.cat(mag)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def probe_fma(x, reps: int):
    """The FMA chain of ``tools/roofline.py _vpu_kernel`` on any f32
    tensor."""
    need("probe_fma", "x", x, x.shape)
    if not is_cuda("probe_fma", [x]):
        return probe_fma_plain(x, reps)
    o = torch.empty_like(x)
    launch("probe_fma", [x, o, x.numel(), int(reps)])
    return o


def probe_launch(x):
    """``o = x * 1.000001`` in one small launch (at most 1,024
    elements). Its host time is what the launch probe measures, so the
    checks that pass on a CUDA tensor take one test each, and the full
    ones (which raise, or take the plain version on the CPU) run only
    where one fails."""
    n = x.numel()
    if not (x.is_cuda and x.dtype is _F32 and x.is_contiguous()
            and n <= 1024):
        need("probe_launch", "x", x, x.shape)
        if n > 1024:
            raise ValueError("probe_launch: at most 1024 elements, one "
                             "block")
        if not is_cuda("probe_launch", (x,)):
            return probe_launch_plain(x)
    o = torch.empty_like(x)
    launch("probe_launch", (x, o, n))
    return o


def probe_gather(packed, idx):
    """Rows of packed [NB, C] through window ids idx [G, W] -> [G, W, C]
    (ids clamped into [0, NB))."""
    nb, width = packed.shape
    need("probe_gather", "packed", packed, (nb, width))
    need("probe_gather", "idx", idx, idx.shape, torch.int32)
    if idx.ndim != 2 or nb == 0:
        raise ValueError("probe_gather: idx must be [G, W] and packed "
                         "non-empty")
    if not is_cuda("probe_gather", [packed, idx]):
        return probe_gather_plain(packed, idx)
    out = torch.empty((*idx.shape, width), dtype=packed.dtype,
                      device=packed.device)
    launch("probe_gather", [packed, idx, out, nb, width, idx.numel()])
    return out


def probe_pass1_tile(nv, tgt, rows, tb: int, chunk: int = 512):
    """The pass-1 tile sweep of ``tools/microbench.py kern``: nv [gb]
    int32, tgt 4 x [gb*tb, 1] (x, y, z, ih), rows 5 x [gb, s] (x, y, z, m,
    live) -> rho [gb*tb, 1]. `tb` targets per instance (64 * SG, at most
    1,024)."""
    gb, s = rows[0].shape
    need("probe_pass1_tile", "nv", nv, (gb,), torch.int32)
    for k, t in enumerate(tgt):
        need("probe_pass1_tile", f"target column {k}", t, (gb * tb, 1))
    for k, r in enumerate(rows):
        need("probe_pass1_tile", f"source row {k}", r, (gb, s))
    if len(tgt) != 4 or len(rows) != 5:
        raise ValueError("probe_pass1_tile: 4 target columns, 5 rows")
    if not 0 < tb <= 1024 or chunk <= 0:
        raise ValueError(f"probe_pass1_tile: tb={tb}, chunk={chunk}")
    if not is_cuda("probe_pass1_tile", [nv, *tgt, *rows]):
        return probe_pass1_tile_plain(nv, tgt, rows, chunk)[0]
    rho = torch.empty((gb * tb, 1), dtype=torch.float32, device=nv.device)
    launch("probe_pass1_tile", [nv, *tgt, *rows, rho, gb, tb, s, chunk])
    return rho
