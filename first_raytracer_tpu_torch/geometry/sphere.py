"""Batched ray-sphere intersection.

Port of ``first_raytracer_tpu.geometry.sphere``: the ``oc = O - C`` quadratic
with unit directions (``a = 1``), near root first, then far root, against
``(t_min, t_max)``.  The normal ``(p - C) / radius`` uses the signed
radius, so a negative radius is a hollow (inward-facing) shell.
``sphere_hit_all`` is part of K11's plain version (the dense sweep,
``kernels/csrc/dense_hit.cu`` on the card, which rounds as torch rounds
these ops there).
"""
from __future__ import annotations

import torch

from ..core.vecmath import bound, dot, point_at

__all__ = ["BIG", "sphere_hit_all", "sphere_hit_one", "sphere_normal"]

BIG = 1e30


def _roots(b, c_coef, t_min, t_max):
    disc = b * b - c_coef
    has_root = disc > 0
    sqrt_disc = torch.sqrt(torch.where(has_root, disc, 0.0))
    t_near = -b - sqrt_disc
    t_far = -b + sqrt_disc
    near_ok = has_root & (t_near > t_min) & (t_near < t_max)
    far_ok = has_root & (t_far > t_min) & (t_far < t_max)
    return torch.where(near_ok, t_near, torch.where(far_ok, t_far, BIG))


def sphere_hit_all(origin, direction, center, radius, t_min, t_max):
    """(R, Ns) hit distances of R rays against every sphere; BIG = miss.

    ``t_min``/``t_max`` are scalars or (R,) tensors.  Uses the same
    ``oc`` form as ``sphere_hit_one`` so hit masks agree between the
    sweep and the per-ray recompute.
    """
    t_min = bound(t_min, origin.device)[..., None]
    t_max = bound(t_max, origin.device)[..., None]
    oc = origin[:, None, :] - center[None, :, :]          # (R, Ns, 3)
    b = torch.sum(oc * direction[:, None, :], dim=-1)
    c_coef = torch.sum(oc * oc, dim=-1) - (radius * radius)[None, :]
    return _roots(b, c_coef, t_min, t_max)


def sphere_hit_one(origin, direction, center, radius, t_min, t_max):
    """(R,) hit distance of R rays against R per-ray spheres; BIG = miss."""
    oc = origin - center
    b = dot(oc, direction)
    c_coef = dot(oc, oc) - radius * radius
    return _roots(b, c_coef, t_min, t_max)


def sphere_normal(origin, direction, t, center, radius):
    """(point, outward normal) at the hit, both (R, 3)."""
    p = point_at(origin, direction, t)
    n = (p - center) / radius[..., None]
    return p, n
