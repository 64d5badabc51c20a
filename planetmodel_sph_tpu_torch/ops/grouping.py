"""Cell-bounded Morton target grouping (PyTorch port).

Groups are runs of <= bsz consecutive Morton-sorted particles that never
cross a level-lg octree cell; a cell's last group is padded with
duplicates of its last particle, masked by `live`. See
``planetmodel_sph_tpu.ops.grouping`` for the rationale. The sort is stable,
as ``jnp.argsort`` is: Morton codes tie often (1024 cells per axis), and
the tie order decides every group's membership.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import morton

_I32_MAX = 2 ** 31 - 1   # segment_min's identity for empty cells


class Groups(NamedTuple):
    tgt_idx: torch.Tensor     # [G*B] original particle index per slot
    live: torch.Tensor        # [G,B] slot validity (False: duplicate)
    scatter_to: torch.Tensor  # [G*B] original index, or n for dead slots
    order: torch.Tensor       # [N]   the Morton sort (original indices)
    unsort_idx: torch.Tensor  # [N]   the live slot holding each particle


def effective_level(n: int, bsz: int, lg_max: int) -> int:
    lg = lg_max
    while lg > 0 and 8 ** lg > max(1, n // bsz):
        lg -= 1
    return lg


def n_groups_static(n: int, bsz: int, lg_max: int) -> int:
    """Static group count for (n, bsz, lg) — must match cell_groups."""
    lg = effective_level(n, bsz, lg_max)
    tcell_cap = min(n, 8 ** lg)
    return (n + (bsz - 1) * tcell_cap) // bsz + 1


def cell_groups(pos, lo, hi, bsz: int, lg_max: int) -> Groups:
    """Group particles; `lo`/`hi` is the Morton bounding box."""
    n = pos.shape[0]
    dev = pos.device
    lg = effective_level(n, bsz, lg_max)
    tcell_cap = min(n, 8 ** lg)
    n_groups = (n + (bsz - 1) * tcell_cap) // bsz + 1
    i64 = dict(dtype=torch.int64, device=dev)

    code = morton.encode(pos, lo, hi)
    order = torch.sort(code, stable=True).indices
    cid = morton.cell_of(code[order], lg)
    boundary = torch.ones(n, dtype=torch.bool, device=dev)
    boundary[1:] = cid[1:] != cid[:-1]
    seg = torch.cumsum(boundary.to(torch.int64), 0) - 1
    tstart = torch.full((tcell_cap,), _I32_MAX, **i64).scatter_reduce(
        0, seg, torch.arange(n, **i64), reduce="amin")
    tcount = torch.zeros(tcell_cap, **i64).scatter_add(
        0, seg, torch.ones(n, **i64))

    groups_per_cell = -(-tcount // bsz)
    total_groups = groups_per_cell.sum()
    cum_g = torch.cumsum(groups_per_cell, 0) - groups_per_cell
    slots_g = torch.arange(n_groups, **i64)
    gcell = torch.clamp(torch.searchsorted(cum_g, slots_g, right=True) - 1,
                        0, tcell_cap - 1)
    ginner = slots_g - cum_g[gcell]
    gvalid = (slots_g < total_groups) & (ginner < groups_per_cell[gcell])

    member = torch.arange(bsz, **i64)[None, :]
    g_start = (tstart[gcell] + ginner * bsz)[:, None]
    cell_end = (tstart[gcell] + tcount[gcell])[:, None]
    raw_slot = g_start + member
    live = gvalid[:, None] & (raw_slot < cell_end)
    slot = torch.clamp(torch.where(live, raw_slot, cell_end - 1), 0, n - 1)

    tgt_idx = order[slot.reshape(-1)]
    scatter_to = torch.where(live.reshape(-1), tgt_idx,
                             torch.full_like(tgt_idx, n))
    unsort = torch.zeros(n + 1, **i64)
    unsort[scatter_to] = torch.arange(scatter_to.shape[0], **i64)
    i32 = torch.int32
    return Groups(tgt_idx.to(i32), live, scatter_to.to(i32), order.to(i32),
                  unsort[:n].to(i32))
