"""What every kernel wrapper shares: the argument checks, the launch
through ctypes on the current stream, and the launch counters.

``LAUNCHES[name]`` is incremented in :func:`launch` and nowhere else, so a
run can show that its path went through a kernel; a wrapper that takes its
plain version (CPU tensors) leaves the count alone. ``BF16_LAUNCHES[name]``
counts, within ``LAUNCHES[name]``, the launches of the kernels' bfloat16
instances (``grav_pair_dtype="bfloat16"``: ``p2p`` and ``gravity_fused``).
``SPANS[name]`` is the span (``utils/profiling``) that :func:`spanned` puts
around a wrapper's CUDA path in a trace: its checks, its output
allocations and the launch.

Every wrapper call pays this path on the host, so it is kept thin:

- the checks read each tensor's attributes once (device index and kind,
  dtype, shape, contiguity), and raise only after a test fails;
- the current stream is read at every launch as the raw handle PyTorch
  keeps for the device (the value Triton's launcher reads), not through a
  ``torch.cuda.Stream`` object; it is never cached, so a launch inside
  ``torch.cuda.stream(s)`` or a CUDA graph capture goes to that stream;
- tensors pass as their data pointers, the rest as they are, straight into
  the ctypes call (the C functions are loaded with ``ctypes.PyDLL``: they
  only enqueue a launch, so the call keeps the GIL).
"""

from __future__ import annotations

import torch

from ...utils import profiling
from . import build

LAUNCHES = dict.fromkeys(build.SIGNATURES, 0)
BF16_LAUNCHES = dict.fromkeys(("p2p", "gravity_fused"), 0)
SPANS = {k: profiling.KERNEL + k for k in LAUNCHES}

_Tensor = torch.Tensor
_LIBS = build._LIBS          # the loaded entry points (build.library swaps)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def reset_launches() -> None:
    for counts in (LAUNCHES, BF16_LAUNCHES):
        for k in counts:
            counts[k] = 0


def spanned(name):
    """Decorator of the wrapper of kernel `name`: its calls on CUDA
    tensors inside the span ``SPANS[name]`` while a profiler records."""
    return profiling.spanned(SPANS[name], cuda_only=True)


def is_cuda(name, tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises when the
    tensors lie on different devices or on another kind of device."""
    first = tensors[0]
    dev, cuda = first.get_device(), first.is_cuda
    if not (cuda or first.is_cpu):
        raise ValueError(f"{name}: unsupported device {first.device}")
    for t in tensors:
        # get_device() is -1 for every kind but CUDA: is_cpu tells a CPU
        # tensor from another kind
        if t.get_device() != dev or t.is_cpu == cuda:
            raise ValueError(f"{name}: tensors on {first.device} and "
                             f"{t.device}")
    return cuda


def need(name, what, t, shape, dtype=torch.float32):
    """Raise unless t has this shape and dtype and is contiguous."""
    if t.dtype is dtype and t.shape == shape and t.is_contiguous():
        return
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} is not contiguous")


def need_all(name, what, tensors, shape, dtype=torch.float32):
    """need() for every tensor of a sequence (`what` k names the k-th),
    in one pass while all pass."""
    for t in tensors:
        if not (t.dtype is dtype and t.shape == shape
                and t.is_contiguous()):
            for k, u in enumerate(tensors):
                need(name, f"{what} {k}", u, shape, dtype)


def launch(name, args, bf16=False):
    """Launch kernel `name` on the current stream of the first argument's
    device. Tensors pass as pointers, None as a null pointer, Python
    numbers as they are. `bf16`: the launch is of the kernel's bfloat16
    instance (counted in BF16_LAUNCHES too)."""
    fn = _LIBS.get(name) or build.kernel(name)
    if _RAW_STREAM is None:
        raise RuntimeError("this PyTorch build has no CUDA")
    rc = fn(*[a.data_ptr() if isinstance(a, _Tensor) else a for a in args],
            _RAW_STREAM(args[0].get_device()))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1
    if bf16:
        BF16_LAUNCHES[name] += 1
