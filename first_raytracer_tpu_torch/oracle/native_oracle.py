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

Run as a module, it writes the radiance-sum goldens of the field frames
(sphere_field(20000), sphere_field(5000) and triangle_field(20000) at
800x450 @ 4, depth 50, seed 0) that ``chip_smoke.py`` holds the clustered
megakernel's and the clustered wavefront's frames to, rendering every ray
id of each frame in chunks over threads (a few minutes on 8 cores):

    python -m first_raytracer_tpu_torch.oracle.native_oracle --write-goldens
    # -> first_raytracer_tpu_torch/data/field_goldens_oracle.json
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import hashlib
import json
import os

import numpy as np

from ..core import rng
from ..kernels.build import build_host_library
from ..scene.builders import build_preset

__all__ = ["available", "error", "render_oracle_native", "radiance_sum",
           "write_goldens", "SOURCE", "GOLDENS", "GOLDEN_SCENES"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "frt_oracle.cpp")
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
GOLDENS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "field_goldens_oracle.json")
# (label, preset, builder arguments): the field frames of chip_smoke.py's
# phases 9 and 13 (the presets' own 800x450 @ 4, depth 50).
GOLDEN_SCENES = (
    ("field20000", "sphere-field", dict(n=20000)),
    ("field5000", "sphere-field", dict(n=5000)),
    ("trifield20000", "triangle-field", dict(n=20000)),
)

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


def radiance_sum(scene, camera, cfg, seed=0, threads=None, chunk=1 << 16):
    """The radiance sum of a whole frame: the float64 sum over every ray id
    of the oracle's radiance, every channel (the frame's per-pixel means
    times spp, summed).  Chunks of ``chunk`` ray ids run on ``threads``
    threads (default: every core); the oracle holds no state and ctypes
    lets go of the GIL while it runs."""
    def part(r0):
        ids = np.arange(r0, min(r0 + chunk, cfg.num_rays), dtype=np.int64)
        rad = render_oracle_native(scene, camera, cfg, seed=seed,
                                   ray_ids=ids)
        return float(rad.astype(np.float64).sum())

    with concurrent.futures.ThreadPoolExecutor(
            threads or os.cpu_count() or 1) as pool:
        return sum(pool.map(part, range(0, cfg.num_rays, chunk)))


def write_goldens(path=GOLDENS, scenes=GOLDEN_SCENES, threads=None,
                  chunk=1 << 16):
    """Renders each of ``scenes`` ((label, preset, builder arguments))
    whole through the oracle, seed 0, and writes their radiance sums to
    ``path`` as JSON, each with its scene, shape and seed, and the oracle
    source's SHA-256.  Returns the dict written."""
    if not available():
        raise RuntimeError(f"native oracle unavailable: {error()}")
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    out = {"writer": "python -m first_raytracer_tpu_torch.oracle."
                     "native_oracle --write-goldens",
           "oracle": {"source": "native/frt_oracle.cpp", "sha256": digest,
                      "flags": list(FLAGS)},
           "goldens": {}}
    for label, preset, kwargs in scenes:
        scene, cam, cfg = build_preset(preset, device="cpu", **kwargs)
        total = radiance_sum(scene, cam, cfg, threads=threads, chunk=chunk)
        out["goldens"][label] = {
            "scene": preset, "builder_args": dict(kwargs), "nx": cfg.nx,
            "ny": cfg.ny, "spp": cfg.spp, "max_depth": cfg.max_depth,
            "t_min": cfg.t_min, "seed": 0, "rays": cfg.num_rays,
            "radiance_sum": total}
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--write-goldens", action="store_true", required=True,
                    help="render the field frames and write their goldens "
                         f"to {os.path.relpath(GOLDENS)}")
    ap.parse_args(argv)
    out = write_goldens()
    for label, g in out["goldens"].items():
        print(f"{label}: {g['radiance_sum']!r}")


if __name__ == "__main__":
    main()
