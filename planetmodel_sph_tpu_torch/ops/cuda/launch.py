"""What every kernel wrapper shares: the argument checks, the launch
through ctypes on the current stream, and the launch counters.

``LAUNCHES[name]`` is incremented in :func:`launch` and nowhere else, so a
run can show that its path went through a kernel; a wrapper that takes its
plain version (CPU tensors) leaves the count alone.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = dict.fromkeys(build.SIGNATURES, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def is_cuda(name, tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises when the
    tensors lie on different devices or on another kind of device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def need(name, what, t, shape, dtype=torch.float32):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} is not contiguous")


def launch(name, args):
    """Launch kernel `name` on the current stream of the first argument's
    device. Tensors pass as pointers, None as a null pointer, Python
    numbers as they are."""
    dev = args[0].device
    fn = build.kernel(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    rc = fn(*conv, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1
