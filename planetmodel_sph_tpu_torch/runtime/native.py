"""The native PSPH1 writer and reader (C++ through ctypes), built at first use.

``psph_io.cpp`` (the port's copy of the JAX package's native runtime)
compiles with ``g++ -O2 -shared -fPIC -std=c++17 -pthread`` into
``planetmodel_sph_tpu_torch/build/libpsph_io.so`` the first time a snapshot
is written or read, or again when the source is newer than the library;
never next to the source. :func:`load` returns None where no compiler is
found or the build fails, and :mod:`.snapshot` then writes and reads the
same bytes in numpy.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "psph_io.cpp")
BUILD = os.path.join(os.path.dirname(_HERE), "build")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def lib_path() -> str:
    return os.path.join(BUILD, "libpsph_io.so")


def _build() -> bool:
    """Compile into a file of this process's own, then move it into place
    (processes that build at once never load a half-written library)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib_path()}.{os.getpid()}.tmp"
    cmd = [gxx, "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", SRC,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        os.replace(tmp, lib_path())
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _bind(lib):
    c = ctypes
    for name, res, args in (
            ("psph_writer_open", c.c_void_p, [c.c_char_p, c.c_char_p]),
            ("psph_writer_write", c.c_int, [c.c_void_p, c.c_void_p,
                                            c.c_uint64]),
            ("psph_writer_close", c.c_int, [c.c_void_p]),
            ("psph_reader_open", c.c_void_p, [c.c_char_p]),
            ("psph_reader_header", c.c_int64, [c.c_void_p, c.c_char_p,
                                               c.c_uint64]),
            ("psph_reader_next", c.c_int64, [c.c_void_p, c.c_void_p,
                                             c.c_uint64]),
            ("psph_reader_close", c.c_int, [c.c_void_p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load():
    """The native library (built if needed), or None where it cannot be
    built or loaded. Tried once per process."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = lib_path()
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(SRC)):
            if not _build():
                return None
        try:
            _LIB = _bind(ctypes.CDLL(so))
        except OSError:
            return None
        return _LIB
