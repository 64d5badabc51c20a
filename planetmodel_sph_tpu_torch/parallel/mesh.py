"""The data-parallel mesh on ``torch.distributed`` (PyTorch port).

Counterpart of ``planetmodel_sph_tpu/parallel/mesh.py``: a 1-D mesh over
particles. Each rank is a process of its own that holds one shard of the
particles (its targets) and all-gathers the source fields it needs, as
every shard does inside the reference's ``shard_map``. :class:`Mesh` is
what the reference's mesh axis name is to its collectives: the functions
below take it where ``jax.lax`` takes the axis name.

Where the ranks run is chosen by the device, never by catching an error:

- ``device="cuda"``: one rank a card, ``cuda:rank``, over NCCL; more ranks
  than visible cards is refused (see :func:`placement`);
- ``device="cuda:K"``: every rank on card K. NCCL refuses two ranks on one
  card, so more than one rank there goes over gloo, which takes CUDA
  tensors (it stages them through host memory itself). A one-card machine
  runs several ranks this way (:func:`ppermute`'s point-to-point
  messages stage through host memory explicitly there: gloo's ``isend`` /
  ``irecv`` take CPU tensors);
- ``device="cpu"``: gloo, as many ranks as asked for (the reference's
  virtual CPU mesh has as many devices as it is told).

The ranks meet through a ``file://`` store in a temporary directory (no
network), and every collective waits at most the process group's
`timeout_s`: a rank that hangs fails the others instead of stalling them.

The reference's ``particle_sharding`` (a ``NamedSharding``) has no meaning
here: a rank simply holds its rows, :func:`shard_state` cuts them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

DP_AXIS = "dp"
TIMEOUT_S = 600.0          # the default wait of one collective
# a spawned rank's start-up, host clock (time.time()): this module
# imported, the rank's entry into _rank_main, its device set, its process
# group up
STARTUP: dict = {"imported": time.time()}


class Mesh(NamedTuple):
    """One rank's view of the 1-D data-parallel mesh."""
    group: object            # the process group (None: the default one)
    rank: int
    size: int
    device: torch.device
    backend: str


def placement(n_ranks: int, device="cuda"):
    """(backend, [device of each rank]) for `n_ranks` ranks on `device`.

    Refuses loudly rather than truncate: a "mesh of 4" that silently ran
    one rank would make every collective a self-loop (the trap the
    reference's ``make_mesh`` names: duplicated sources, ~Dx densities,
    nothing loudly wrong)."""
    if n_ranks < 1:
        raise ValueError(f"a mesh of {n_ranks} ranks")
    dev = torch.device(device)
    if dev.type == "cpu":
        return "gloo", [torch.device("cpu")] * n_ranks
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: 'cuda', 'cuda:K' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    visible = torch.cuda.device_count()
    if dev.index is None:
        if visible < n_ranks:
            raise ValueError(
                f"make_mesh({n_ranks}) but only {visible} card(s) visible: "
                "one rank a card over NCCL; put the ranks on one card with "
                "device='cuda:0' (gloo) or on the CPU with device='cpu'")
        return "nccl", [torch.device("cuda", r) for r in range(n_ranks)]
    if dev.index >= visible:
        raise ValueError(f"device {device!r} but only {visible} card(s) "
                         "visible")
    # NCCL refuses two ranks on one card: several ranks there take gloo
    return ("nccl" if n_ranks == 1 else "gloo"), [dev] * n_ranks


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """This rank's mesh over the default process group.

    Checks the placement first (so it refuses, as the reference does, a
    count the machine cannot hold, before anything else), then that the
    process group holds exactly `n_devices` ranks (its size when None)."""
    n = n_devices if n_devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    backend, devices = placement(n, device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "start the ranks with parallel.mesh.spawn")
    size, rank = dist.get_world_size(), dist.get_rank()
    if size != n:
        raise ValueError(f"make_mesh({n}) in a process group of {size}")
    if dist.get_backend() != backend:
        raise ValueError(f"{device!r} takes {backend}, the process group "
                         f"runs {dist.get_backend()}")
    return Mesh(None, rank, size, devices[rank], backend)


def _rank_main(rank, fn, size, store_file, device, timeout_s, args):
    """One spawned rank: join the default process group through the file
    store, build the mesh, run fn (its start-up stamped in STARTUP)."""
    STARTUP["entered"] = time.time()
    backend, devices = placement(size, device)
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    else:
        # CPU ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // size))
    STARTUP["device"] = time.time()
    dist.init_process_group(
        backend, init_method=f"file://{store_file}", rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    STARTUP["group"] = time.time()
    try:
        fn(make_mesh(size, device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, device="cuda", args=(),
          timeout_s: float = TIMEOUT_S) -> None:
    """Run ``fn(mesh, *args)`` in `n_ranks` new processes, one a rank
    (SPMD: every rank calls the same function on its own shard), and wait
    for all of them. `fn` must be importable by name (a module-level
    function). Raises when a rank raises; every process ends before this
    returns. On a card, the kernels are built here first (those not built
    yet), so that no two ranks run ``nvcc`` on the same library."""
    import torch.multiprocessing as mp
    placement(n_ranks, device)          # refuse before starting anything
    if torch.device(device).type == "cuda":
        from ..ops.cuda import build
        build.build_all()
    tmp = tempfile.mkdtemp(prefix="psph_dp_")
    try:
        mp.start_processes(
            _rank_main, args=(fn, n_ranks, os.path.join(tmp, "store"),
                              device, timeout_s, tuple(args)),
            nprocs=n_ranks, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the collectives, named as in jax.lax; `axis` is the Mesh
# ---------------------------------------------------------------------------

def axis_index(axis: Mesh) -> int:
    """This rank's index on the mesh."""
    return axis.rank


def axis_size(axis: Mesh) -> int:
    """The number of ranks on the mesh."""
    return axis.size


def ppermute(x, axis: Mesh, perm):
    """``jax.lax.ppermute``: `perm` is a list of (source, destination)
    rank pairs; this rank sends `x` to every destination its rank is the
    source of and returns what its source sent it, zeros where no pair
    names it as a destination. A pair (r, r) copies locally. See
    :func:`ppermutes` for the transport."""
    return ppermutes(x, axis, [perm])[0]


def ppermutes(x, axis: Mesh, perms):
    """``[ppermute(x, axis, p) for p in perms]`` as one exchange: every
    message of every permutation is posted before any is waited for (the
    message of permutation k carries tag k).

    Under NCCL the messages go as one ``batch_isend_irecv``; under gloo as
    ``isend`` / ``irecv`` pairs with every receive posted before any wait,
    so a ring cannot deadlock. Gloo's point-to-point path takes CPU
    tensors only, so on a card the gloo branch stages `x` through host
    memory once and the received messages back in one copy (chosen by
    `axis.backend`)."""
    r = axis.rank
    x = x.contiguous()
    outs, sends, recvs = [], [], []
    for k, perm in enumerate(perms):
        srcs = [s for s, d in perm if d == r]
        if len(srcs) > 1:
            raise ValueError(f"ppermute: rank {r} receives from {srcs}")
        outs.append(x.clone() if srcs == [r] else None)
        sends += [(d, k) for s, d in perm if s == r and d != r]
        if srcs and srcs[0] != r:
            recvs.append((srcs[0], k))
    host = axis.backend != "nccl" and x.device.type != "cpu"
    xs = x.cpu() if host else x
    bufs = torch.empty((len(recvs),) + xs.shape, dtype=xs.dtype,
                       device=xs.device)
    if axis.backend == "nccl":
        ops = [dist.P2POp(dist.isend, x, d, group=axis.group, tag=k)
               for d, k in sends]
        ops += [dist.P2POp(dist.irecv, bufs[i], s, group=axis.group, tag=k)
                for i, (s, k) in enumerate(recvs)]
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = [dist.irecv(bufs[i], s, group=axis.group, tag=k)
                 for i, (s, k) in enumerate(recvs)]
        works += [dist.isend(xs, d, group=axis.group, tag=k)
                  for d, k in sends]
    for w in works:
        w.wait()
    if host and recvs:
        bufs = bufs.to(x.device)
    for i, (_, k) in enumerate(recvs):
        outs[k] = bufs[i]
    return [torch.zeros_like(x) if o is None else o for o in outs]


def all_gather(x, axis: Mesh):
    """Every rank's `x` concatenated along axis 0 in rank order (the
    reference's ``all_gather(x, axis, tiled=True)``): a list gather then
    ``torch.cat``, which every torch version has."""
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x.contiguous(), group=axis.group)
    return torch.cat(parts, dim=0)


def _all_reduce(x, axis: Mesh, op):
    y = x.clone()
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def psum(x, axis: Mesh):
    """The sum of `x` over the ranks (in its own dtype: float64 stays
    float64)."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmin(x, axis: Mesh):
    return _all_reduce(x, axis, dist.ReduceOp.MIN)


def pmax(x, axis: Mesh):
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def shard_state(state, axis: Mesh):
    """This rank's rows [r n/D, (r+1) n/D) of the global state, on the
    rank's device. n must divide by D."""
    n, d, r = state.pos.shape[0], axis.size, axis.rank
    if n % d:
        raise ValueError(f"n={n} does not divide over {d} ranks")
    k = n // d
    return type(state)(**{
        f.name: getattr(state, f.name)[r * k:(r + 1) * k].to(
            axis.device).contiguous()
        for f in dataclasses.fields(state)})


def gather_state(state, axis: Mesh):
    """The global state from every rank's shard (rank order)."""
    return type(state)(**{f.name: all_gather(getattr(state, f.name), axis)
                          for f in dataclasses.fields(state)})
