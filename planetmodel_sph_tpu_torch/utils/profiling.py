"""Profiling helpers (PyTorch port of ``planetmodel_sph_tpu.utils.profiling``).

:func:`trace` records the block with ``torch.profiler`` (host activity, and
the card's kernels where one is present) and exports a Chrome trace,
viewable in Perfetto or ``chrome://tracing`` and summarised by
``tools.trace_summary``. :func:`steps_per_sec` times a
run with the device synchronized before each clock read, so the time is the
device's work and not the enqueue; :func:`seconds_per_call` times calls of
a function with CUDA events after a warm-up call (the developer tools'
timer). ``bench._device_times`` sums a profiler
run's device time by kernel.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


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
