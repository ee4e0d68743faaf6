"""Batched ray-triangle intersection (Möller-Trumbore).

Port of ``first_raytracer_tpu.geometry.triangle``.  The geometric normal
is ``normalize(cross(e1, e2))``, un-flipped: the winding defines the
outward side.  ``triangle_hit_all`` is part of K11's plain version (the
dense sweep, ``kernels/csrc/dense_hit.cu`` on the card).
"""
from __future__ import annotations

import torch

from ..core.vecmath import bound, cross, dot, normalize

__all__ = ["BIG", "triangle_hit_all", "triangle_hit_one", "triangle_normal"]

BIG = 1e30
DET_EPS = 1e-9


def _moller_trumbore(origin, direction, v0, v1, v2, t_min, t_max):
    """MT test on broadcast-compatible shapes; returns (t, hit)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > DET_EPS
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min)
           & (t < t_max))
    return torch.where(hit, t, BIG), hit


def triangle_hit_all(origin, direction, v0, v1, v2, t_min, t_max):
    """(R, Nt) hit distances of R rays against every triangle."""
    dev = origin.device
    t, _ = _moller_trumbore(
        origin[:, None, :], direction[:, None, :],
        v0[None, :, :], v1[None, :, :], v2[None, :, :],
        bound(t_min, dev)[..., None], bound(t_max, dev)[..., None])
    return t


def triangle_hit_one(origin, direction, v0, v1, v2, t_min, t_max):
    """(R,) hit distance against R per-ray triangles."""
    t, _ = _moller_trumbore(origin, direction, v0, v1, v2, t_min, t_max)
    return t


def triangle_normal(v0, v1, v2):
    """Unit geometric normal from the winding; (R, 3)."""
    return normalize(cross(v1 - v0, v2 - v0))
