"""ctypes bindings for the native C++ BVH builder.

Compiles ``bvh_builder.cpp`` on first use (utils/native.py: plain C ABI +
ctypes, content-hash cached .so). Falls back to the numpy builder when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from hijiki.utils.native import shared_object

_SRC = os.path.join(os.path.dirname(__file__), "bvh_builder.cpp")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native builder; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    try:
        lib = ctypes.CDLL(shared_object(_SRC, "bvh_builder", ["-O3", "-march=native"]))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.hijiki_build_bvh.restype = ctypes.c_int32
        lib.hijiki_build_bvh.argtypes = [
            f32p,
            f32p,
            ctypes.c_int32,
            ctypes.c_int32,
            f32p,
            f32p,
            i32p,
            i32p,
            i32p,
            i32p,
        ]
        _lib = lib
        return lib
    except (OSError, RuntimeError):
        _load_failed = True
        return None


def build_bvh_native(aabb_min: np.ndarray, aabb_max: np.ndarray, leaf_size: int = 1):
    """Native binned-SAH build; returns a FlatBVH or None if unavailable."""
    from hijiki.accel.bvh import FlatBVH

    lib = load_library()
    if lib is None:
        return None
    aabb_min = np.ascontiguousarray(aabb_min, dtype=np.float32).reshape(-1, 3)
    aabb_max = np.ascontiguousarray(aabb_max, dtype=np.float32).reshape(-1, 3)
    n = aabb_min.shape[0]
    max_nodes = max(2 * n - 1, 1)
    out_min = np.empty((max_nodes, 3), np.float32)
    out_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    exit_ = np.empty(max_nodes, np.int32)
    order = np.empty(n, np.int32)
    num = lib.hijiki_build_bvh(
        aabb_min, aabb_max, n, leaf_size, out_min, out_max, first, count, exit_, order
    )
    if num < 0:
        return None
    return FlatBVH(
        aabb_min=out_min[:num].copy(),
        aabb_max=out_max[:num].copy(),
        first=first[:num].copy(),
        count=count[:num].copy(),
        exit=exit_[:num].copy(),
        prim_order=order,
    )
