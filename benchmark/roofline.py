"""The roofline arithmetic of the benchmark: peaks and operation counts.

Frozen copy of the constants and formulas of
``first_raytracer_tpu_torch/utils/roofline.py`` that the per-layer metrics
use (``PEAK_FP32``, ``PEAK_BYTES``, ``SPHERE_OPS``, ``TRIANGLE_OPS``,
``dense_ops``, ``roofline``), so that a change to the port cannot move its
own yardstick.  The counts fed to it are the benchmark's own (segments of
the reference's paths, primitives of the benchmark's scene), never the
kernels' counters.

Peaks: NVIDIA's H100 SXM data sheet, FP32 outside the tensor cores and
HBM3 bandwidth, at the card's full 700 W power limit.
"""
from __future__ import annotations

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one sweep step in K1 (``mega_common.cuh``): a
# (segment, sphere) pair's float prefilter, and a (segment, triangle)
# pair's test.  The float64 root past the prefilter, the shading and the
# draws are left out, so the least time is a lower bound.
SPHERE_OPS, TRIANGLE_OPS = 20, 46


def dense_ops(segments, spheres, triangles=0):
    """FP32 operations of a dense sweep of ``segments`` segments over every
    sphere and triangle of the scene."""
    return segments * (spheres * SPHERE_OPS + triangles * TRIANGLE_OPS)


def least_seconds(ops, nbytes):
    """The least time the card could take: the larger of ``ops`` FP32
    operations over the FP32 peak and ``nbytes`` over the memory rate."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)
