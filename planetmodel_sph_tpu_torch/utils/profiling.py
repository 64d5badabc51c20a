"""Profiling helpers (PyTorch port of ``planetmodel_sph_tpu.utils.profiling``).

:func:`trace` records the block with ``torch.profiler`` (host activity, and
the card's kernels where one is present) and exports a Chrome trace,
viewable in Perfetto or ``chrome://tracing``. :func:`steps_per_sec` times a
run with the device synchronized before each clock read, so the time is the
device's work and not the enqueue. ``bench._device_times`` sums a profiler
run's device time by kernel.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the block; its Chrome trace goes to ``logdir/trace.json``
    (default: ``psph_trace`` under the temporary directory). Yields
    `logdir`."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "psph_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
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
