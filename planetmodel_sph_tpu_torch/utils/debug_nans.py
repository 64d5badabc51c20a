"""``cli run --debug-nans``: stop a run at the first NaN and name where it
came from (the port's counterpart of the reference's ``jax_debug_nans``).

The reference sets JAX's ``jax_debug_nans``: when an output of a jitted
computation holds a NaN, JAX runs that computation again op by op and
raises ``FloatingPointError`` naming the first primitive that made one.
Infinities are not checked (that is ``jax_debug_infs``, which the
reference never sets), and the switch is global, so a data-parallel run
stops too.

The port checks in two stages, so that a clean run pays one read a chunk:

1. at every chunk boundary (a diagnostics chunk of
   ``planet.run_with_diagnostics``, a frame of the command line's frame
   loop, a data-parallel rank's chunk) one ``isnan().any()`` over each
   floating field of the state, read to the host once; the chunk's input
   state is kept as a copy beforehand. Under data parallelism the verdict
   is all-reduced, one int, so every rank takes stage 2 or none does;
2. on a NaN the chunk runs again from its kept input, with the floating
   outputs of every aten op checked (a ``TorchDispatchMode``) and those of
   every kernel wrapper of ``ops/cuda/groups2.py`` and
   ``ops/cuda/pairwise.py`` (a launch enqueues no aten op, so the wrapper's
   outputs are checked as it returns), and the steps counted. Then
   ``FloatingPointError`` names the first op or kernel whose output held a
   NaN, the step within the chunk and the run's global step, and the state
   fields that hold NaN. If the re-run meets no NaN it is raised all the
   same, naming the fields and the chunk. Every rank of a data-parallel
   run re-runs its chunk to the end (its collectives with the others) and
   raises after it, so the ranks stop together.

Ops whose output is not a computed value are not checked: the ``empty``
family (uninitialised memory), views (their values are their base's, which
was checked where it was made), the collectives (complete only after the
op returns; the op that reads their result is checked) and everything
inside a kernel wrapper (its outputs are, as it returns). An op whose NaN
a ``where`` masks out at once is not named (the reference's
``jax_debug_nans`` would name it).

The checks run between chunks, outside any step, so never inside a CUDA
graph capture of a chunk's steps. They only raise: a NaN is never repaired
or carried past. Without the flag none of this runs: no copy, no read, no
dispatch mode, and a run gives the same bits and launch counts.

    python -m planetmodel_sph_tpu_torch.cli run --debug-nans --steps 200
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from ..state import FIELDS

# ops that return uninitialised memory
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "resize_as_", "set_")


def _floats(out):
    return [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
            and t.is_floating_point() and t.numel()]


def _has_nan(out) -> bool:
    """Whether any floating tensor of `out` holds a NaN (one host read)."""
    ts = _floats(out)
    return bool(ts) and bool(torch.stack([torch.isnan(t).any()
                                          for t in ts]).any())


def nan_fields(state) -> list:
    """The floating fields of `state` that hold a NaN: one reduction a
    field, read to the host once."""
    names = [k for k in FIELDS if getattr(state, k).is_floating_point()]
    flags = torch.stack([torch.isnan(getattr(state, k)).any()
                         for k in names]).tolist()
    return [k for k, bad in zip(names, flags) if bad]


def _key(t):
    return (t.data_ptr(), tuple(t.shape))


class _Watch(TorchDispatchMode):
    """Stage 2's dispatch mode: records the first aten op whose floating
    output holds a NaN (``hit``: what, step), outside the kernel wrappers,
    while ``step`` counts the chunk's steps. A hit whose output a
    ``where`` takes directly and masks out is dropped: the pressure factor
    ``where(rho_ok, P / rho^2, 0)`` of the grid step divides 0 by 0 on its
    padding slots in every step of a clean run."""

    def __init__(self):
        super().__init__()
        self.hit = None
        self.made = ()               # the hit's NaN outputs
        self.step = 0
        self.wrapper = None          # the kernel wrapper being run, if any

    def record(self, what, out=()):
        if self.hit is None:
            self.hit = (what, self.step)
            self.made = {_key(t) for t in _floats(out)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.wrapper is not None or func.namespace != "aten":
            return out
        name = func.overloadpacket.__name__
        if (self.hit is not None and name == "where" and self.made
                and any(_key(t) in self.made for t in _floats(args))
                and not _has_nan(out)):
            self.hit, self.made = None, ()
        elif (self.hit is None and not getattr(func, "is_view", False)
                and name not in _UNINITIALISED and _has_nan(out)):
            self.record(f"the aten op {func}", out)
        return out


def _wrappers():
    """(module, attribute, kernel name) of every kernel wrapper the engine
    calls through its module (as ``gk2.pass2(...)``)."""
    from ..ops.cuda import groups2, pairwise
    return ([(groups2, k, k) for k in groups2.KERNELS]
            + [(pairwise, "pass1", "pairwise_pass1"),
               (pairwise, "pass2", "pairwise_pass2")])


@contextlib.contextmanager
def _watching(watch: _Watch):
    """Within the block: the steps counted, every kernel wrapper's outputs
    checked as it returns, every aten op's by `watch`."""
    from ..models import planet
    patched = []

    def counted(fn):
        def step(*a, **kw):
            watch.step += 1
            return fn(*a, **kw)
        return step

    def checked(fn, name):
        def call(*a, **kw):
            outer, watch.wrapper = watch.wrapper, name
            try:
                out = fn(*a, **kw)
            finally:
                watch.wrapper = outer
            if outer is None and watch.hit is None and _has_nan(out):
                where = ("its CUDA kernel" if _floats(out)[0].is_cuda
                         else "its plain version on the CPU")
                watch.record(f"the {name} kernel wrapper ({where})")
            return out
        return call

    try:
        for k in ("step_kdk", "step_staggered"):
            patched.append((planet, k, getattr(planet, k)))
            setattr(planet, k, counted(getattr(planet, k)))
        for mod, attr, name in _wrappers():
            patched.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, checked(getattr(mod, attr), name))
        with watch:
            yield watch
    finally:
        for mod, attr, fn in reversed(patched):
            setattr(mod, attr, fn)


def unchecked(run, state, n_steps: int):
    """The chunk boundary without ``--debug-nans``: ``run(state)``, with
    no copy, no read and no dispatch mode (a :class:`NaNCheck`'s call
    signature)."""
    return run(state)


def _copy(state):
    return type(state)(**{k: getattr(state, k).clone() for k in FIELDS})


class NaNCheck:
    """The check of one run, called at each chunk boundary as
    ``check(run, state, n_steps)``, where ``run(state)`` advances the
    chunk of `n_steps` and returns ``(state, ...)``; returns what `run`
    returned, or raises ``FloatingPointError``. `start_step`: the run's
    global step before its first chunk. `axis`: the data-parallel mesh
    (``parallel/mesh.py``) whose ranks decide together."""

    def __init__(self, start_step: int = 0, axis=None):
        self.step = start_step
        self.axis = axis

    def _any_rank(self, bad: bool) -> bool:
        from ..parallel import mesh as mesh_mod
        flag = torch.tensor([int(bad)], dtype=torch.int32,
                            device=self.axis.device)
        return bool(mesh_mod.pmax(flag, self.axis).item())

    def __call__(self, run, state, n_steps: int):
        kept = _copy(state)
        out = run(state)
        bad = nan_fields(out[0])
        hit = bool(bad)
        if self.axis is not None:
            hit = self._any_rank(hit)
        if hit:
            self._raise(run, kept, n_steps, bad)
        self.step += n_steps
        return out

    def _raise(self, run, kept, n_steps, bad):
        with _watching(_Watch()) as watch:
            run(kept)
        s0 = self.step
        rank = (f" on rank {self.axis.rank}" if self.axis is not None
                else "")
        fields = (", ".join(bad) if bad else "no field (another rank's "
                  "state holds the NaN)")
        head = (f"--debug-nans: NaN in the state's {fields}{rank} after "
                f"the chunk of steps {s0 + 1}-{s0 + n_steps}")
        if watch.hit is None:
            raise FloatingPointError(
                f"{head}; the chunk's re-run from its input met no NaN")
        what, k = watch.hit
        at = (f"step {k} of the chunk (global step {s0 + k})" if k else
              f"the chunk's set-up before its first step (global step "
              f"{s0})")
        raise FloatingPointError(f"{head}: the first NaN came out of {what} "
                                 f"at {at}")
