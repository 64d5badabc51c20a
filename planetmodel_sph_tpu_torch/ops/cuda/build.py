"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each source ``planetmodel_sph_tpu_torch/csrc/<name>.cu`` compiles with
``nvcc`` into its own shared library with a plain C interface under
``planetmodel_sph_tpu_torch/build/`` (listed in ``.gitignore``), at first
use or when the source is newer than the library. :func:`build_all` starts
one ``nvcc`` per source, all at once, and waits for them together.
Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")

# name -> C argument signature: "p" pointer (incl. the stream), "i" int,
# "f" float. Each C function returns cudaGetLastError() after its launch.
SIGNATURES = {
    "filter_sph": "p" * 13 + "iii" + "p",
    "pass1_gradh": "p" * 12 + "iii" + "p",
    "pass1_sym": "p" * 12 + "iii" + "p",
    # 12 target columns, 13 source rows, 5 P2P rows, nv, nv2, 16 outputs;
    # g, b, s, s2 and seven flags; av_alpha, av_beta, g_const
    "pass2": "p" * 48 + "i" * 11 + "fff" + "p",
    "p2p": "p" * 15 + "iiii" + "f" + "p",
    # 4 target columns, 5 P2P rows, nv_p2p, 10 ring rows, nv_ring, 10 blk
    # rows, nv_blk, 10 far rows, accept, 6 outputs; g, b, sp, sr, sb, nbpad,
    # nm and two flags
    "gravity_fused": "p" * 49 + "i" * 9 + "f" + "p",
    "pairwise_pass1": "p" * 10 + "iiii" + "f" + "p",
    "pairwise_pass2": "p" * 12 + "iiiiii" + "ff" + "p",
    # the tools' probes: x, o, n, reps; x, o, n; packed, idx, out, nb,
    # width, rows; nv, 4 target columns, 5 rows, rho, gb, tb, s, chunk
    "probe_fma": "pp" + "ii" + "p",
    "probe_launch": "pp" + "i" + "p",
    "probe_gather": "ppp" + "iii" + "p",
    "probe_pass1_tile": "p" * 11 + "iiii" + "p",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernels whose output holds an exact decision on r2 (the filter mask, the
# q < 2 counts of the pass 1s) build without multiply-add contraction, so
# r2 and cut*cut round as the plain PyTorch versions' separate ops do and
# knife-edge compares agree; so does the pass-1 tile probe, whose signed
# random-normal terms reach |q|^3 ~ 1e4 and cancel, so that only the order
# of the sum may differ from its plain version's. The pass 2s, p2p and
# gravity_fused count nothing that rounding moves, and their sums are held
# to a tolerance: they keep FMA, as do the other probes (probe_fma measures
# the FMA rate itself).
NO_FMAD = ("filter_sph", "pass1_gradh", "pass1_sym", "pairwise_pass1",
           "probe_pass1_tile")

_LIBS: dict = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str, out: str = BUILD) -> str:
    return os.path.join(out, f"lib{name}.so")


def _stale(name: str, src: str, out: str) -> bool:
    so = lib_path(name, out)
    if not os.path.exists(so):
        return True
    newest = max(os.path.getmtime(os.path.join(src, f))
                 for f in os.listdir(src) if f.endswith((".cu", ".cuh")))
    return os.path.getmtime(so) < newest


def build_all(names=None, force=False, src=CSRC, out=BUILD) -> dict:
    """Compile the named kernels (default: all) in parallel, from the
    sources in `src` into libraries in `out` (another checkout's sources
    build into its own directory, to time the two versions in turns).

    Returns {name: (seconds, ptxas report)}; raises with the compiler's
    output if any build fails."""
    names = list(names or SIGNATURES)
    todo = [n for n in names if force or _stale(n, src, out)]
    if not todo:
        return {}
    os.makedirs(out, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        fmad = ["-fmad=false"] if n in NO_FMAD else []
        cmd = [nvcc, *NVCC_FLAGS, *fmad, "-o", lib_path(n, out),
               os.path.join(src, f"{n}.cu")]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    out, failed = {}, []
    for n, p in procs.items():
        log, _ = p.communicate()
        out[n] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            failed.append(f"--- {n} (rc {p.returncode})\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


_CT = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def load(name: str, path: str):
    """The C entry point ``psph_<name>`` of the library at `path`. The
    library is loaded as a ``ctypes.PyDLL``: a call keeps the GIL, which
    costs less than releasing it for a function that only enqueues a
    launch."""
    fn = getattr(ctypes.PyDLL(path), f"psph_{name}")
    fn.argtypes = [_CT[c] for c in SIGNATURES[name]]
    fn.restype = ctypes.c_int
    return fn


def kernel(name: str):
    """The C entry point ``psph_<name>`` (building the library if needed)."""
    fn = _LIBS.get(name)
    if fn is None:
        build_all([name])
        fn = _LIBS[name] = load(name, lib_path(name))
    return fn


@contextlib.contextmanager
def library(name: str, path: str):
    """Within the block, launches of `name` go to the library at `path`
    (another version of its source, built by :func:`build_all`)."""
    saved = _LIBS.get(name)
    _LIBS[name] = load(name, path)
    try:
        yield
    finally:
        if saved is None:
            _LIBS.pop(name)
        else:
            _LIBS[name] = saved
