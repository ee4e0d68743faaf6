"""ctypes binding to the C++ BVH builder (``native/frt_native.cpp``).

Port of ``first_raytracer_tpu.accel.native``.  The builder is the NumPy
one of ``accel/build.py`` in C++, with bit-identical output, for the build
speed of large scenes.  The port compiles ``native/frt_native.cpp`` alone
with ``g++`` at first use into ``kernels/build/`` (git-ignored; the file
name carries a hash of the source and flags), as ``kernels/build.py`` does
with nvcc, so it neither needs nor writes the JAX package's
``native/libfrt_native.so``.  ``available()`` is False when no compiler
builds it; ``error()`` says why.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..kernels.build import BUILD_DIR

__all__ = ["available", "error", "build_bvh_native_arrays", "SOURCE"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "frt_native.cpp")
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


@functools.lru_cache(maxsize=None)
def _load():
    """(library, None) once built and loaded, else (None, the reason)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None, "no C++ compiler (g++) found"
    if not os.path.exists(SOURCE):
        return None, f"{SOURCE} is missing"
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode())
    out = os.path.join(BUILD_DIR,
                       f"libfrt_native_{digest.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            return None, f"g++ failed: {proc.stderr[-2000:]}"
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    lib = ctypes.CDLL(out)
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int32)
    lib.frt_bvh_build.restype = ctypes.c_void_p
    lib.frt_bvh_build.argtypes = [fptr, fptr, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int]
    lib.frt_bvh_num_nodes.restype = ctypes.c_int64
    lib.frt_bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.frt_bvh_num_prims.restype = ctypes.c_int64
    lib.frt_bvh_num_prims.argtypes = [ctypes.c_void_p]
    lib.frt_bvh_export.restype = None
    lib.frt_bvh_export.argtypes = [ctypes.c_void_p] + [fptr] * 2 + [iptr] * 4
    lib.frt_bvh_free.restype = None
    lib.frt_bvh_free.argtypes = [ctypes.c_void_p]
    return lib, None


def available() -> bool:
    return _load()[0] is not None


def error():
    """Why the native builder is unavailable (None when it is)."""
    return _load()[1]


def build_bvh_native_arrays(bmin: np.ndarray, bmax: np.ndarray,
                            max_leaf: int, use_sah: bool):
    """The six flat arrays (NumPy) from the native builder."""
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native builder unavailable: {why}")
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int32)
    handle = lib.frt_bvh_build(bmin.ctypes.data_as(fptr),
                               bmax.ctypes.data_as(fptr), bmin.shape[0],
                               max_leaf, int(use_sah))
    try:
        n_nodes = lib.frt_bvh_num_nodes(handle)
        n_prims = lib.frt_bvh_num_prims(handle)
        node_min = np.empty((n_nodes, 3), np.float32)
        node_max = np.empty((n_nodes, 3), np.float32)
        node_first = np.empty(n_nodes, np.int32)
        node_count = np.empty(n_nodes, np.int32)
        node_skip = np.empty(n_nodes, np.int32)
        prim_ids = np.empty(n_prims, np.int32)
        lib.frt_bvh_export(
            handle, node_min.ctypes.data_as(fptr),
            node_max.ctypes.data_as(fptr), node_first.ctypes.data_as(iptr),
            node_count.ctypes.data_as(iptr), node_skip.ctypes.data_as(iptr),
            prim_ids.ctypes.data_as(iptr))
    finally:
        lib.frt_bvh_free(handle)
    return node_min, node_max, node_first, node_count, node_skip, prim_ids
