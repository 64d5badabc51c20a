"""Profiling helpers (PyTorch port of ``planetmodel_sph_tpu.utils.profiling``).

:func:`trace` records the block with ``torch.profiler`` (host activity, and
the card's kernels where one is present) and exports a Chrome trace,
viewable in Perfetto or ``chrome://tracing`` and summarised by
``tools.trace_summary`` (``--by-span`` reads the program's spans).
:func:`steps_per_sec` times a run with the device synchronized before each
clock read, so the time is the device's work and not the enqueue;
:func:`seconds_per_call` times calls of a function with CUDA events after a
warm-up call (the developer tools' timer). ``bench._device_times`` sums a
profiler run's device time by kernel.

The program's spans: :func:`span` (a ``with`` block) and :func:`spanned`
(a whole function) put the program's layers into a trace as host ranges
named ``psph.*`` (the constants below), on the same clock as the card's
kernels. While a profiler records, a span is PyTorch's fast record
function, kept in the trace as a host op (category ``cpu_op``); it costs a
tenth of ``record_function`` (a ``user_annotation``, the fallback where
PyTorch lacks the fast one). While no profiler records, a span is one
check of the profiler's flag and a shared null context: no allocation, no
record function, no device call. A span never synchronizes, reads no
tensor's values and changes no value. The spans count as well as time:
over a traced run, the number of ``psph.kernel.<name>`` spans is the
hand-kernel launches and the number of ``psph.rebuild`` spans the
rebuilds.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time

import torch


# the program's spans, by layer (``tools.trace_summary --by-span`` and the
# benchmark's ``spans.py`` read them); a kernel wrapper's span is
# KERNEL + its launch name (``ops/cuda/launch.SPANS``)
FRAME = "psph.frame"                # models/planet.run_info
STEP = "psph.step"                  # one step of an uncached run or a chunk
CHUNK = "psph.chunk"                # models/planet.run_chunk_cached
REBUILD = "psph.rebuild"            # a chunk's h update and structure
SOLVE_H = "psph.solve_h"            # ops/structure.solve_h_newton
BUILD = "psph.build"                # ops/structure.build
FAR_KICK = "psph.far_kick"          # a RESPA far-tier evaluation
PERMUTE = "psph.permute"            # a chunk's state into or out of order
FORCES = "psph.forces"              # one force evaluation
EOS = "psph.eos"                    # ops/eos.pressure_cfg
COM_CORRECT = "psph.com_correct"    # models/planet.com_correct
MEASURE = "psph.measure"            # utils/diagnostics.measure
CHECKPOINT = "psph.checkpoint"      # utils/checkpoint.save
PREFIX = "psph."                    # every span's name begins so
KERNEL = "psph.kernel."

# torch.profiler.profile sets this module's flag while it records
_PROFILER = torch.autograd.profiler
_NULL = contextlib.nullcontext()
_RECORD = getattr(torch._C._profiler, "_RecordFunctionFast",
                  torch.profiler.record_function)


def span(name: str):
    """A context for the block: a record function named `name` while a
    profiler records, else one shared null context."""
    if _PROFILER._is_profiler_enabled:
        return _RECORD(name)
    return _NULL


def spanned(name: str, cuda_only: bool = False):
    """Decorator: each call of the function inside :func:`span` (name).
    `cuda_only`: only the calls whose first argument is a CUDA tensor (a
    kernel wrapper's path to its kernel; its plain version gets no
    span)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _PROFILER._is_profiler_enabled and (
                    not cuda_only or args[0].is_cuda):
                with _RECORD(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap


def default_logdir() -> str:
    """Where :func:`trace` writes by default: ``psph_trace`` under the
    temporary directory."""
    return os.path.join(tempfile.gettempdir(), "psph_trace")


@contextlib.contextmanager
def trace(logdir: str | None = None, with_stack: bool = False):
    """Profile the block; its Chrome trace goes to ``logdir/trace.json``
    (default: :func:`default_logdir`). `with_stack` records the Python
    frames too (``tools.trace_summary`` names the source line of each
    device op from them), which slows the host several times over.
    Yields `logdir`."""
    logdir = logdir or default_logdir()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                with_stack=with_stack) as prof:
        yield logdir
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(state) -> None:
    dev = state.pos.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def steps_per_sec(run_fn, state, n_steps: int, warmup: int = 1):
    """Time ``run_fn(state, n_steps)`` after an untimed
    ``run_fn(state, warmup)``; returns (steps/s, final state)."""
    out = run_fn(state, warmup)
    _sync(out)
    t0 = time.perf_counter()
    out = run_fn(state, n_steps)
    _sync(out)
    return n_steps / (time.perf_counter() - t0), out


def seconds_per_call(fn, dev, k: int = 1, warmup: int = 1):
    """Seconds a call of ``fn()`` takes, the mean over `k` calls after
    `warmup` untimed ones: on a card between two CUDA events recorded on
    the current stream around the k calls (read after a synchronize), on
    the CPU by the host clock. Returns (seconds, the last call's
    result)."""
    dev = torch.device(dev)
    out = None
    for _ in range(warmup):
        out = fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(k):
            out = fn()
        return (time.perf_counter() - t0) / k, out
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(k):
        out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / k, out
