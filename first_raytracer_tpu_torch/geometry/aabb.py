"""Axis-aligned bounding boxes: the slab test and the host-side boxes.

Port of ``first_raytracer_tpu.geometry.aabb``.  ``aabb_hit`` is the
per-axis ``(min - O) / d`` interval-intersection slab test; a zero direction
component divides to inf (IEEE), which the min/max form handles.  Its first
caller is the flat-BVH walk (``accel/traverse.py``); the clustered kernels
run their own slab test (``slab_gate`` in ``kernels/csrc/mega_common.cuh``).
The NumPy helpers are copied as they are: the per-primitive boxes that the
BVH builder and the clustered packs group.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["aabb_hit", "surrounding_box_np", "sphere_aabb_np",
           "triangle_aabb_np"]


def aabb_hit(origin, inv_direction, box_min, box_max, t_min, t_max):
    """Slab test, broadcast over leading axes.

    ``origin``, ``inv_direction`` (pass ``1 / d``), ``box_min`` and
    ``box_max`` are (..., 3); ``t_min`` and ``t_max`` are scalars or (...,)
    tensors.  Returns (...,) bool: True where the box overlaps
    ``(t_min, t_max)``.  The minima and maxima propagate NaN, as JAX's do.
    """
    t0 = (box_min - origin) * inv_direction
    t1 = (box_max - origin) * inv_direction
    near = torch.minimum(t0, t1)
    far = torch.maximum(t0, t1)
    dev = origin.device
    tn = torch.maximum(near.amax(dim=-1), torch.as_tensor(t_min, device=dev))
    tf = torch.minimum(far.amin(dim=-1), torch.as_tensor(t_max, device=dev))
    return tn <= tf


# --- Host-side (NumPy) box construction -------------------------------------

def surrounding_box_np(min_a, max_a, min_b, max_b):
    """The union of two boxes (NumPy)."""
    return np.minimum(min_a, min_b), np.maximum(max_a, max_b)


def sphere_aabb_np(center, radius):
    """Per-sphere boxes; |radius| handles the negative-radius hollow glass.

    center: (N, 3), radius: (N,) -> (N, 3) mins, (N, 3) maxs.
    """
    r = np.abs(radius)[:, None]
    return center - r, center + r


def triangle_aabb_np(v0, v1, v2, pad: float = 1e-4):
    """Per-triangle boxes, padded so axis-aligned triangles have volume."""
    mn = np.minimum(np.minimum(v0, v1), v2) - pad
    mx = np.maximum(np.maximum(v0, v1), v2) + pad
    return mn, mx
