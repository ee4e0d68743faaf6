"""Axis-aligned bounding boxes built on the host.

Port of the NumPy helpers of ``first_raytracer_tpu.geometry.aabb``, copied
as they are: the per-primitive boxes that the clustered pack
(``kernels/megakernel_clustered.py``) groups into clusters.  The slab test
itself runs inside the clustered kernel (``ClusterScene::gate`` in
``kernels/csrc/megakernel_clustered.cu``); the torch slab test waits for the
BVH, its first caller on tensors.
"""
from __future__ import annotations

import numpy as np

__all__ = ["surrounding_box_np", "sphere_aabb_np", "triangle_aabb_np"]


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
