"""Build/load the native C++ runtime shared library.

Compiled on demand with g++ from native/src (no external dependencies), cached
next to the sources. The library is optional: every consumer falls back to the
numpy backends when it is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_LIB_PATH = os.path.join(os.path.dirname(__file__), "libbwtmerge_native.so")
_SOURCES = ["codec.cpp", "interleave.cpp", "spill.cpp", "writer.cpp",
            "radecode.cpp"]
_lock = threading.Lock()
_lib = None


def _needs_rebuild() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    for src in _SOURCES:
        path = os.path.join(_SRC_DIR, src)
        if os.path.exists(path) and os.path.getmtime(path) > lib_mtime:
            return True
    return False


def build_library() -> str:
    sources = [os.path.join(_SRC_DIR, s) for s in _SOURCES if os.path.exists(os.path.join(_SRC_DIR, s))]
    if not sources:
        raise RuntimeError("native sources not found")
    # build to a per-process file and rename it into place: processes that
    # start together (test workers) never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fvisibility=hidden", "-o", tmp, *sources, "-pthread",
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            if _needs_rebuild():
                build_library()
            _lib = ctypes.CDLL(_LIB_PATH)
        return _lib
