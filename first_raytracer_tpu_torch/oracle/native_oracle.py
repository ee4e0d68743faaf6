"""ctypes binding to the native (C++) oracle renderer.

Port of ``first_raytracer_tpu.oracle.native_oracle``: a second,
independent implementation of the reference semantics in the reference's
own language (``native/frt_oracle.cpp``: the recursive ``color()`` with the
linear closest-hit scan and per-material scatter), which draws the same
counter-based Threefry uniforms as ``core/rng.py`` in C++.  The tests hold
it, the NumPy oracle (``cpu_oracle.py``) and the port's renderers to one
another, to libm-ulp tolerance.

The port compiles ``native/frt_oracle.cpp`` alone with ``g++`` at first
use into ``kernels/build/`` (git-ignored; the file name carries a hash of
the source and flags), as ``accel/native.py`` builds the BVH builder; it
never loads the JAX package's ``native/libfrt_native.so``.
``available()`` is False when no compiler builds it, and ``error()`` says
why; ``render_oracle_native`` then raises: a caller that asked for the
native oracle never gets the NumPy one.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..core import rng
from ..kernels.build import build_host_library

__all__ = ["available", "error", "render_oracle_native", "SOURCE"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "frt_oracle.cpp")
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def _load():
    """(library, None) once built and loaded, else (None, the reason)."""
    path, why = build_host_library("frt_oracle", SOURCE, FLAGS)
    if path is None:
        return None, why
    lib = ctypes.CDLL(path)
    lib.frt_render_oracle.restype = None
    lib.frt_render_oracle.argtypes = [
        _F32P, _F32P, _I32P, ctypes.c_int64,                 # spheres
        _F32P, _F32P, _F32P, _I32P, ctypes.c_int64,          # triangles
        _I32P, _I32P, _F32P, _F32P, _F32P, _F32P, _F32P,     # materials
        _F32P,                                               # camera (19)
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,      # nx ny spp
        ctypes.c_int32, ctypes.c_float,                      # depth t_min
        ctypes.c_uint32, ctypes.c_uint32,                    # key
        _I64P, ctypes.c_int64, _F32P,                        # rays, out
    ]
    return lib, None


def available() -> bool:
    return _load()[0] is not None


def error():
    """Why the native oracle is unavailable (None when it is)."""
    return _load()[1]


def _f32(a):
    return np.ascontiguousarray(np.asarray(a), np.float32)


def _i32(a):
    return np.ascontiguousarray(np.asarray(a), np.int32)


def render_oracle_native(scene, camera, cfg, seed: int = 0, ray_ids=None):
    """``cpu_oracle.render_oracle`` run by the C++ oracle: the (ny, nx, 3)
    f32 image, top row first, or (R, 3) per-ray radiance when ``ray_ids``
    is given.  Raises ``RuntimeError`` when the oracle cannot be built."""
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {why}")
    s = scene.as_numpy()
    full_image = ray_ids is None
    if full_image:
        ray_ids = np.arange(cfg.num_rays, dtype=np.int64)
    elif hasattr(ray_ids, "detach"):
        ray_ids = ray_ids.detach().cpu().numpy()
    ray_ids = np.ascontiguousarray(ray_ids, np.int64)

    cam = np.concatenate([
        _f32(getattr(camera, f).detach().cpu()).reshape(-1)
        for f in ("origin", "lower_left", "horizontal", "vertical", "u",
                  "v", "lens_radius")])
    k0, k1 = rng.key_words(rng.base_key(seed))

    sph_c, sph_r, sph_m = (_f32(s.sphere_center), _f32(s.sphere_radius),
                           _i32(s.sphere_mat))
    t0, t1, t2 = _f32(s.tri_v0), _f32(s.tri_v1), _f32(s.tri_v2)
    tri_m = _i32(s.tri_mat)
    m_ty, tx_ty = _i32(s.mat_type), _i32(s.tex_type)
    alb, alb2 = _f32(s.albedo), _f32(s.albedo2)
    tsc, fz, ri = _f32(s.tex_scale), _f32(s.fuzz), _f32(s.ref_idx)
    out = np.zeros((len(ray_ids), 3), np.float32)

    def fp(a):
        return a.ctypes.data_as(_F32P)

    def ip(a):
        return a.ctypes.data_as(_I32P)

    lib.frt_render_oracle(
        fp(sph_c), fp(sph_r), ip(sph_m), len(sph_r),
        fp(t0), fp(t1), fp(t2), ip(tri_m), len(tri_m),
        ip(m_ty), ip(tx_ty), fp(alb), fp(alb2), fp(tsc), fp(fz), fp(ri),
        fp(cam), cfg.nx, cfg.ny, cfg.spp, cfg.max_depth,
        float(cfg.t_min), k0, k1, ray_ids.ctypes.data_as(_I64P),
        len(ray_ids), fp(out))

    if full_image:
        img = out.reshape(cfg.ny, cfg.nx, cfg.spp, 3).mean(axis=2)
        return img[::-1].astype(np.float32)
    return out
