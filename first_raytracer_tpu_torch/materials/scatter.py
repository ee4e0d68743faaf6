"""Masked material scatter: lambertian, metal, dielectric.

Port of ``first_raytracer_tpu.materials.scatter``.  All three materials are
evaluated on every ray and the result is selected by the material type id:

- lambertian: direction ``normalize(N + ball)``; attenuation = texture;
- metal: ``reflect(d, N) + fuzz * ball``, absorbed where it leaves below
  the surface (``dot(dir, N) <= 0``);
- dielectric: Snell refraction with the TIR check, Schlick reflectance with
  the reference's ``cosine = ref_idx * dot(d, N)`` exiting formula, and a
  reflect/refract coin on the 4th uniform; attenuation 1.

Scattered directions are normalized.
"""
from __future__ import annotations

import torch

from ..core.rng import unit_ball_sample
from ..core.vecmath import dot, normalize, reflect, refract, schlick
from ..scene.soa import MAT_DIELECTRIC, MAT_METAL
from ..scene.textures import texture_from_params, texture_value

__all__ = ["scatter", "scatter_from_params", "scatter_rows"]

_NORM_EPS = 1e-20


def scatter(scene, mat_id, direction, hit_p, hit_n, uniforms):
    """Scatter R rays at their hit points.

    Args:
      scene: Scene.
      mat_id: (R,) material id at each hit.
      direction: (R, 3) unit incoming directions.
      hit_p, hit_n: (R, 3) hit point and outward geometric normal.
      uniforms: (R, 4) this bounce's draws (ball u1 u2 u3, coin u4).

    Returns:
      (new_dir (R, 3), attenuation (R, 3), scattered_ok (R,) bool).
    """
    m = mat_id.long()
    return scatter_from_params(
        scene.mat_type[m], scene.fuzz[m], scene.ref_idx[m],
        texture_value(scene, m, hit_p), direction, hit_p, hit_n, uniforms)


def scatter_rows(rows, direction, hit_p, hit_n, uniforms):
    """``scatter`` with each ray's (R, 11) material row given
    (``scene/payload.py``: mtype, fuzz, ref_idx, albedo, albedo2,
    tex_scale, tex_type, the types as floats)."""
    tex = texture_from_params(rows[:, 10].to(torch.int32), rows[:, 3:6],
                              rows[:, 6:9], rows[:, 9], hit_p)
    return scatter_from_params(rows[:, 0].to(torch.int32), rows[:, 1],
                               rows[:, 2], tex, direction, hit_p, hit_n,
                               uniforms)


def scatter_from_params(mtype, fuzz, ref_idx, tex, direction, hit_p, hit_n,
                        uniforms):
    """``scatter`` with the (R,)-shaped material rows given."""
    ball = unit_ball_sample(uniforms[:, 0], uniforms[:, 1], uniforms[:, 2])
    coin = uniforms[:, 3]

    lam_dir = normalize(hit_n + ball, eps=_NORM_EPS)

    reflected = reflect(direction, hit_n)
    metal_raw = reflected + fuzz[:, None] * ball
    metal_ok = dot(metal_raw, hit_n) > 0.0
    metal_dir = normalize(metal_raw, eps=_NORM_EPS)

    d_dot_n = dot(direction, hit_n)
    outside = d_dot_n > 0.0  # travelling along the normal: exiting
    outward_n = torch.where(outside[:, None], -hit_n, hit_n)
    ni_over_nt = torch.where(outside, ref_idx, 1.0 / ref_idx)
    cosine = torch.where(outside, ref_idx * d_dot_n, -d_dot_n)
    refracted, can_refract = refract(direction, outward_n, ni_over_nt)
    reflect_prob = torch.where(can_refract, schlick(cosine, ref_idx), 1.0)
    use_reflect = coin < reflect_prob
    diel_dir = torch.where(use_reflect[:, None],
                           normalize(reflected, eps=_NORM_EPS),
                           normalize(refracted, eps=_NORM_EPS))

    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    new_dir = torch.where(is_diel[:, None], diel_dir,
                          torch.where(is_metal[:, None], metal_dir, lam_dir))
    attenuation = torch.where(is_diel[:, None], 1.0, tex)
    scattered_ok = torch.where(is_metal, metal_ok, True)
    return new_dir, attenuation, scattered_ok
