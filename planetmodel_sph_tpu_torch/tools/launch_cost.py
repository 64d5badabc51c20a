"""Where the host time of one kernel wrapper call goes.

    python -m planetmodel_sph_tpu_torch.tools.launch_cost [--reps 10000]
        [--json OUT]

Card only. Times with ``time.perf_counter_ns`` over `reps` calls each, and
prints in microseconds a call:

- the pieces of a ``probe_launch`` call on an [8, 128] tensor: its checks
  (``need``, ``is_cuda``), the output allocation, the current stream read
  two ways (the ``torch.cuda.Stream`` object, and the raw handle that
  Triton's launcher reads), the pointer list, the ctypes call with n = 0
  (the C function skips its launch and returns ``cudaGetLastError``) as
  the package loads it and through ``ctypes.CDLL`` and ``ctypes.PyDLL``,
  the ctypes call that launches, the wrapper without its launch, the whole
  wrapper, and ``torch.mul`` on the same tensor;
- the production ``pass1_gradh`` and ``pass2`` wrappers (grad-h, gravity
  with the merged P2P window; 2,067 groups of 64, SPH window 2,560 slots,
  P2P window 3,584, every nv 0 so the card does no work): the wrapper
  without its launch (``launch.launch`` replaced by a no-op: the checks and
  the allocation), ``launch.launch`` alone on the wrapper's own arguments
  (stream, pointers, ctypes, C launch), the ctypes call with g = 0 (no
  launch) and the whole wrapper.

The card is synchronised every 1,000 calls so that the launch queue never
fills and a number never includes waiting for the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time

import torch

from ..ops.cuda import build, groups2, launch, probes
from ..state import resolve_device

G, B, S, S2 = 2067, 64, 2560, 3584


def per_call_us(fn, reps, sync_every=1000):
    """Median over rounds of 1,000 calls of the host microseconds one
    fn() takes (one warm-up round first)."""
    def round_(n):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        return (t1 - t0) / n / 1e3
    round_(min(sync_every, reps))
    rounds = [round_(min(sync_every, reps - k))
              for k in range(0, reps, sync_every)]
    return statistics.median(rounds)


def _raw_stream(t):
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _without_launch(module, call, reps):
    """Host microseconds of call() with `module`'s launch replaced by a
    no-op: the wrapper's checks and allocation."""
    real = module.launch
    module.launch = lambda name, args: None
    try:
        return per_call_us(call, reps)
    finally:
        module.launch = real


def launch_pieces(reps, dev):
    x = torch.rand((8, 128), device=dev)
    o = torch.empty_like(x)
    fn = build.kernel("probe_launch")
    stream = _raw_stream(x)
    args = [x, o, x.numel()]
    ptr = [x.data_ptr(), o.data_ptr()]
    # the same entry point loaded both ways ctypes offers: CDLL releases
    # the GIL for the call, PyDLL keeps it
    loaded = {}
    for kind in ("CDLL", "PyDLL"):
        f = getattr(getattr(ctypes, kind)(build.lib_path("probe_launch")),
                    "psph_probe_launch")
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
        loaded[kind] = f
    return {
        "need": per_call_us(
            lambda: launch.need("probe_launch", "x", x, x.shape), reps),
        "is_cuda": per_call_us(
            lambda: launch.is_cuda("probe_launch", [x]), reps),
        "empty_like": per_call_us(lambda: torch.empty_like(x), reps),
        "stream_object": per_call_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream, reps),
        "stream_raw": per_call_us(lambda: _raw_stream(x), reps),
        "pointers": per_call_us(
            lambda: [a.data_ptr() if isinstance(a, torch.Tensor) else a
                     for a in args], reps),
        "ctypes_no_launch": per_call_us(
            lambda: fn(ptr[0], ptr[1], 0, stream), reps),
        "cdll_no_launch": per_call_us(
            lambda: loaded["CDLL"](ptr[0], ptr[1], 0, stream), reps),
        "pydll_no_launch": per_call_us(
            lambda: loaded["PyDLL"](ptr[0], ptr[1], 0, stream), reps),
        "ctypes_launch": per_call_us(
            lambda: fn(ptr[0], ptr[1], 1024, stream), reps),
        "wrapper_no_launch": _without_launch(
            probes, lambda: probes.probe_launch(x), reps),
        "wrapper": per_call_us(lambda: probes.probe_launch(x), reps),
        "torch_mul": per_call_us(
            lambda: torch.mul(x, probes.LAUNCH_SCALE), reps),
    }


def _windows(dev):
    """Production-shaped inputs with every nv 0: (nv, pass 1 args, pass 2
    args, pass 2 keywords)."""
    gen = torch.Generator().manual_seed(0)
    rnd = lambda shape: torch.rand(shape, generator=gen).to(dev)  # noqa
    nv = torch.zeros((G,), dtype=torch.int32, device=dev)
    cols = [rnd((G * B, 1)) for _ in range(5)]
    rows = [rnd((G, S)) for _ in range(6)]
    prow = [rnd((G, S2)) for _ in range(5)]
    p1 = (nv, cols[:4], rows[:3] + rows[4:5])
    p2 = (nv, cols, rows)
    kw2 = dict(mode="grad_h", grav=True, nv_p2p=nv.clone(), p2p_rows=prow)
    return p1, p2, kw2


def wrapper_pieces(reps, dev):
    """The production pass1_gradh and pass2 wrappers, piece by piece."""
    p1, p2, kw2 = _windows(dev)
    calls = {"pass1_gradh": lambda: groups2.pass1_gradh(*p1, b=B),
             "pass2": lambda: groups2.pass2(*p2, b=B, **kw2)}
    out = {}
    for name, call in calls.items():
        seen = []
        real = launch.launch
        # keep the first call's arguments only: later outputs are freed
        groups2._launch = lambda n, a: seen or seen.append(a)
        try:
            checks_alloc = per_call_us(call, reps)
        finally:
            groups2._launch = real
        args = seen[0]
        fn = build.kernel(name)
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        g_at = len(conv) - (14 if name == "pass2" else 3)
        idle = list(conv)
        idle[g_at] = 0                       # g = 0: no launch
        stream = _raw_stream(args[0])
        out[name] = {
            "checks_and_alloc": checks_alloc,
            "launch_call": per_call_us(lambda: real(name, args), reps),
            "ctypes_no_launch": per_call_us(lambda: fn(*idle, stream),
                                            reps),
            "wrapper": per_call_us(call, reps),
            "arguments": len(conv) + 1,
        }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="launch_cost")
    ap.add_argument("--reps", type=int, default=10_000)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    build.build_all(["probe_launch", "pass1_gradh", "pass2"])
    rep = {"device": torch.cuda.get_device_name(dev), "reps": args.reps,
           "probe_launch": launch_pieces(args.reps, dev)}
    rep.update(wrapper_pieces(args.reps, dev))
    print(f"host us a call on {rep['device']} ({args.reps} calls each):")
    for name in ("probe_launch", "pass1_gradh", "pass2"):
        print(f"  {name}: " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in rep[name].items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
