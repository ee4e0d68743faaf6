"""The dense closest hit on the scene's own tensors (K11): the wavefront's
closest hit without an accel.

``dense_hit(scene, origin, direction, t_min, alive=None)`` is the contract
of ``render.integrator.intersect_brute``: for every ray the nearest hit
past ``t_min`` among every sphere and every triangle, ``(prim int32, t
float32, hit bool)``, the lowest global id winning a tie (torch.argmin's
first minimum), triangles numbered from Ns, prim 0 and t = 1e30 on a miss.
With ``alive``, a (R,) bool mask, a ray whose entry is False is not swept
and gets the miss (prim 0, t = 1e30, hit False): ``dense_hit_plain``,
``intersect_brute`` then ``torch.where`` on the mask.  On a CUDA device it
launches K11 (``csrc/dense_hit.cu``), which sweeps only the live rays,
packed into full warps, reads the scene's sphere and triangle tensors at
every launch (no pack, so a scene moved in place is read anew, under a
CUDA graph too) and rounds each pair as torch rounds ``sphere_hit_all``
and ``triangle_hit_all`` on the card: bit-equal to ``dense_hit_plain``
there on every ray.  On the CPU it runs ``dense_hit_plain``.  A tensor on
any other device is refused; a failed build or launch raises, and nothing
falls back.

The JAX package has no Pallas kernel here: XLA fuses its sweep
(``first_raytracer_tpu/render/integrator.py:106``), which torch runs as
some 40 ops over (R, N, 3) temporaries.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["dense_hit", "dense_hit_plain", "REPLACES"]

REPLACES = "first_raytracer_tpu/render/integrator.py:106"


def dense_hit_plain(scene, origin, direction, t_min, alive=None):
    """K11's plain version, torch ops on any device: ``intersect_brute``
    over every ray, then the miss where ``alive`` is False."""
    from ..render.integrator import BIG, intersect_brute
    prim, t, hit = intersect_brute(scene, origin, direction, t_min)
    if alive is None:
        return prim, t, hit
    return (torch.where(alive, prim, 0), torch.where(alive, t, BIG),
            hit & alive)


def _launch_cuda(scene, origin, direction, t_min, alive=None):
    """K11 over the rays (those ``alive`` marks, or all): (prim, t, hit),
    each (R,).  Makes no host read and allocates only its outputs, so a
    CUDA graph can capture it."""
    from . import megakernel
    from .megakernel import _check

    if isinstance(t_min, torch.Tensor):
        raise ValueError("K11 takes t_min as a number, not a tensor")
    dev = origin.device
    ns, nt = scene.num_spheres, scene.num_triangles
    if ns + nt == 0:
        raise ValueError("K11 needs a scene with a primitive")
    if ns + nt >= 2 ** 31:
        raise ValueError(f"{ns} spheres and {nt} triangles: K11 numbers "
                         "primitives in 32 bits")
    R = origin.shape[0]
    f32 = torch.float32
    _check("origin", origin, f32, (R, 3), dev)
    _check("direction", direction, f32, (R, 3), dev)
    if alive is not None:
        _check("alive", alive, torch.bool, (R,), dev)
    for name, shape in (("sphere_center", (ns, 3)), ("sphere_radius", (ns,)),
                        ("tri_v0", (nt, 3)), ("tri_v1", (nt, 3)),
                        ("tri_v2", (nt, 3))):
        _check(f"scene.{name}", getattr(scene, name), f32, shape, dev)
    prim = torch.empty((R,), dtype=torch.int32, device=dev)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    megakernel.launch_entry(
        dev, "frt_dense_hit", scene.sphere_center.data_ptr(),
        scene.sphere_radius.data_ptr(), scene.tri_v0.data_ptr(),
        scene.tri_v1.data_ptr(), scene.tri_v2.data_ptr(), ns, nt,
        origin.data_ptr(), direction.data_ptr(),
        None if alive is None else alive.data_ptr(), R,
        ctypes.c_float(float(t_min)), prim.data_ptr(), t.data_ptr(),
        hit.data_ptr())
    if R:
        dense_hit.launches += 1
        if alive is not None:
            dense_hit.masked_launches += 1
    return prim, t, hit


@torch.no_grad()
def dense_hit(scene, origin, direction, t_min, alive=None):
    """Dense closest hit of rays ``origin + t direction`` (R, 3) over every
    primitive of ``scene``: ``(prim, t, hit)``, the miss for a ray that
    ``alive`` (optional, (R,) bool) marks dead.  Launches K11 for CUDA rays
    (float32 rays and scene, contiguous, ``t_min`` a number) and runs
    ``dense_hit_plain`` for CPU rays; bit-equal either way."""
    dev = origin.device
    if dev.type == "cpu":
        return dense_hit_plain(scene, origin, direction, t_min, alive)
    if dev.type != "cuda":
        raise ValueError(f"no dense closest-hit kernel for device {dev}")
    return _launch_cuda(scene, origin, direction, t_min, alive)


dense_hit.launches = 0  # K11 launches (CUDA path only)
dense_hit.masked_launches = 0  # those of them given a liveness mask
