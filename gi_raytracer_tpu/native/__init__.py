"""Native (C++) host-runtime components with ctypes bindings.

The reference's whole runtime is C++; in this framework the device compute
path is JAX, and the host-side scene pipeline (BVH build, OBJ parse) has
native implementations here — compiled with g++ from the sources in this
directory at first use, into ``_build/`` under a name keyed on a hash of
the sources and flags (so a stale or foreign binary is never loaded), with
NumPy fallbacks when no toolchain exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "_build")
_SRCS = ("bvh_builder.cpp", "obj_loader.cpp")
# portable flags: the build directory may be copied between machines
_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def library_path(build_dir: str = _BUILD_DIR) -> str:
    """Where the library built from the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SRCS:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"_gi_native-{h.hexdigest()[:16]}.so")


def _compile(build_dir: str = _BUILD_DIR) -> str | None:
    """Build the library unless this exact build exists; None when no
    compiler is available."""
    so = library_path(build_dir)
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp]
                       + [os.path.join(_DIR, n) for n in _SRCS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)   # atomic: concurrent builders never see a torn file
        return so
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib():
    """The loaded native library, or None (NumPy fallbacks apply)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _compile()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.gi_build_bvh.restype = ctypes.c_int32
        lib.gi_build_bvh.argtypes = [f32p, f32p, ctypes.c_int32,
                                     ctypes.c_int32, f32p, f32p, i32p, i32p,
                                     i32p, i32p]
        lib.gi_obj_parse.restype = ctypes.c_int32
        lib.gi_obj_parse.argtypes = [ctypes.c_char_p] + \
            [ctypes.POINTER(ctypes.c_int32)] * 4
        lib.gi_obj_fetch.argtypes = [f32p, f32p, f32p, i32p, i32p, i32p]
        lib.gi_obj_free.argtypes = []
        _LIB = lib
        return _LIB


def build_bvh_native(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int):
    """Binned-SAH BVH via the native builder; returns the same arrays as
    scene.bvh.build_bvh or None if the library is unavailable."""
    lib = get_lib()
    if lib is None or len(pmin) == 0:
        return None
    n = len(pmin)
    cap = 2 * n
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    skip = np.empty(cap, np.int32)
    first = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    prim_idx = np.empty(n, np.int32)
    nn = lib.gi_build_bvh(np.ascontiguousarray(pmin, np.float32),
                          np.ascontiguousarray(pmax, np.float32),
                          n, leaf_size, node_min, node_max, skip, first,
                          count, prim_idx)
    if nn <= 0:
        return None
    from ..scene.bvh import BVHArrays
    return BVHArrays(node_min[:nn].astype(np.float64),
                     node_max[:nn].astype(np.float64),
                     skip[:nn], first[:nn], count[:nn], prim_idx)


def load_obj_native(path: str):
    """Raw OBJ arrays (v, vt, vn, fv, ft, fn) or None."""
    lib = get_lib()
    if lib is None:
        return None
    c = [ctypes.c_int32() for _ in range(4)]
    ret = lib.gi_obj_parse(path.encode(), *[ctypes.byref(x) for x in c])
    if ret != 0:
        return None
    n_v, n_vt, n_vn, n_corners = (x.value for x in c)
    v = np.empty((max(n_v, 1), 3), np.float32)
    vt = np.empty((max(n_vt, 1), 2), np.float32)
    vn = np.empty((max(n_vn, 1), 3), np.float32)
    fv = np.empty(max(n_corners, 1), np.int32)
    ft = np.empty(max(n_corners, 1), np.int32)
    fn = np.empty(max(n_corners, 1), np.int32)
    lib.gi_obj_fetch(v, vt, vn, fv, ft, fn)
    lib.gi_obj_free()
    return (v[:n_v], vt[:n_vt], vn[:n_vn],
            fv[:n_corners], ft[:n_corners], fn[:n_corners])
