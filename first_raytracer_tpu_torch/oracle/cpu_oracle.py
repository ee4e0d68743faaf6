"""CPU reference oracle: slow, plainly correct, recursion-shaped.

Port of ``first_raytracer_tpu.oracle.cpu_oracle``: a per-ray *recursive*
NumPy implementation of the reference renderer's semantics (the
recursive ``color()``, per-material scatter, a linear closest-hit scan),
the machine-checkable stand-in for the reference program, against which
the port's wavefront path is held.  It is host code by nature.

It consumes the same uniform variates as the port's renderers: every draw
comes from ``core.rng.precompute_uniforms`` (the counter-based Threefry
keyed by (ray, domain), bit-equal to the JAX package's), so oracle and
renderer sample the same camera jitter, lens points, unit-ball points and
dielectric coins, and a per-ray comparison is meaningful at low spp.

Shared deviations from the C++ reference (mirrored by the renderers):
unit-length ray directions, analytic (not rejection) ball and disk
sampling, float32 arithmetic with the oc-form sphere quadratic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import rng
from ..scene.soa import MAT_LAMBERTIAN, MAT_METAL, TEX_CHECKER, Scene

__all__ = ["render_oracle", "trace_ray_oracle"]

BIG = np.float32(1e30)
F = np.float32


def _normalize(v):
    n = math.sqrt(float(v @ v))
    return (v / F(n)) if n > 0 else v


def _closest_hit(scene: Scene, o, d, t_min):
    """Linear scan over all primitives; returns (prim, t) with prim = -1 on
    a miss.  Mirrors geometry/{sphere,triangle}.py formulas in float32."""
    best_t = BIG
    best = -1
    for i in range(scene.sphere_center.shape[0]):
        c = scene.sphere_center[i]
        r = scene.sphere_radius[i]
        oc = o - c
        b = F(oc @ d)
        c_coef = F(oc @ oc) - r * r
        disc = b * b - c_coef
        if disc > 0:
            sq = F(math.sqrt(float(disc)))
            for t in (-b - sq, -b + sq):
                if t_min < t < best_t:
                    best_t, best = t, i
                    break
    ns = scene.sphere_center.shape[0]
    for i in range(scene.tri_v0.shape[0]):
        v0, v1, v2 = scene.tri_v0[i], scene.tri_v1[i], scene.tri_v2[i]
        e1, e2 = v1 - v0, v2 - v0
        pvec = np.cross(d, e2)
        det = F(e1 @ pvec)
        if abs(det) <= F(1e-9):
            continue
        inv_det = F(1.0) / det
        tvec = o - v0
        u = F(tvec @ pvec) * inv_det
        qvec = np.cross(tvec, e1)
        v = F(d @ qvec) * inv_det
        t = F(e2 @ qvec) * inv_det
        if u >= 0 and v >= 0 and u + v <= 1 and t_min < t < best_t:
            best_t, best = t, ns + i
    return best, best_t


def _hit_data(scene: Scene, o, d, prim, t):
    ns = scene.sphere_center.shape[0]
    p = o + t * d
    if prim < ns:
        n = (p - scene.sphere_center[prim]) / scene.sphere_radius[prim]
        mat = int(scene.sphere_mat[prim])
    else:
        i = prim - ns
        n = _normalize(np.cross(scene.tri_v1[i] - scene.tri_v0[i],
                                scene.tri_v2[i] - scene.tri_v0[i]))
        mat = int(scene.tri_mat[prim - ns])
    return p, n.astype(F), mat


def _texture_value(scene: Scene, mat, p):
    if int(scene.tex_type[mat]) == TEX_CHECKER:
        s = scene.tex_scale[mat]
        sines = math.sin(float(s * p[0])) * math.sin(float(s * p[1])) \
            * math.sin(float(s * p[2]))
        return scene.albedo2[mat] if sines < 0 else scene.albedo[mat]
    return scene.albedo[mat]


def _unit_ball(u):
    """Mirror of core.rng.unit_ball_sample for three uniforms."""
    z = F(1.0) - F(2.0) * u[0]
    r = math.sqrt(max(0.0, 1.0 - float(z) * float(z)))
    phi = 2.0 * math.pi * float(u[1])
    radius = float(u[2]) ** (1.0 / 3.0)
    return np.array([radius * r * math.cos(phi),
                     radius * r * math.sin(phi),
                     radius * float(z)], dtype=F)


def _reflect(v, n):
    return v - F(2.0 * float(v @ n)) * n


def _scatter(scene: Scene, mat, d, p, n, u):
    """Per-material scatter; returns (ok, new_dir, atten)."""
    mtype = int(scene.mat_type[mat])
    ball = _unit_ball(u)
    if mtype == MAT_LAMBERTIAN:
        return True, _normalize(n + ball), _texture_value(scene, mat, p)
    if mtype == MAT_METAL:
        raw = _reflect(d, n) + scene.fuzz[mat] * ball
        if float(raw @ n) <= 0:
            return False, d, np.ones(3, F)
        return True, _normalize(raw), _texture_value(scene, mat, p)
    # dielectric
    ref_idx = scene.ref_idx[mat]
    d_dot_n = F(d @ n)
    if d_dot_n > 0:
        outward, ni_over_nt, cosine = -n, ref_idx, ref_idx * d_dot_n
    else:
        outward, ni_over_nt, cosine = n, F(1.0) / ref_idx, -d_dot_n
    dt = F(d @ outward)  # d is unit
    disc = F(1.0) - ni_over_nt * ni_over_nt * (F(1.0) - dt * dt)
    if disc > 0:
        refracted = ni_over_nt * (d - outward * dt) \
            - outward * F(math.sqrt(float(disc)))
        r0 = (F(1.0) - ref_idx) / (F(1.0) + ref_idx)
        r0 = r0 * r0
        reflect_prob = r0 + (F(1.0) - r0) * (F(1.0) - cosine) ** 5
    else:
        reflect_prob = F(1.0)
    if u[3] < reflect_prob:
        return True, _normalize(_reflect(d, n)), np.ones(3, F)
    return True, _normalize(refracted), np.ones(3, F)


def _sky(d):
    t = F(0.5) * (d[1] + F(1.0))
    return (F(1.0) - t) * np.ones(3, F) + t * np.array([0.5, 0.7, 1.0], F)


def trace_ray_oracle(scene: Scene, o, d, uniforms, depth, max_depth, t_min):
    """The reference's recursive ``color(ray, world, depth)``."""
    prim, t = _closest_hit(scene, o, d, t_min)
    if prim < 0:
        return _sky(d)
    p, n, mat = _hit_data(scene, o, d, prim, t)
    if depth >= max_depth:
        return np.zeros(3, F)
    ok, new_dir, att = _scatter(scene, mat, d, p, n, uniforms[1 + depth])
    if not ok:
        return np.zeros(3, F)
    return att * trace_ray_oracle(
        scene, p, new_dir, uniforms, depth + 1, max_depth, t_min)


def _np(x):
    """A host NumPy copy of a tensor (or array)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def render_oracle(scene, camera, cfg, seed: int = 0, ray_ids=None):
    """Render with the oracle.  Returns (ny, nx, 3) f32 linear, row 0 = top,
    or (R, 3) per-ray radiance when ``ray_ids`` is given explicitly.  The
    scene and camera may lie on any device; the oracle runs on the host."""
    scene = scene.as_numpy()
    cam_origin = _np(camera.origin).astype(F)
    lower_left = _np(camera.lower_left).astype(F)
    horizontal = _np(camera.horizontal).astype(F)
    vertical = _np(camera.vertical).astype(F)
    cu = _np(camera.u).astype(F)
    cv = _np(camera.v).astype(F)
    lens_radius = F(_np(camera.lens_radius))

    full_image = ray_ids is None
    if full_image:
        ray_ids = np.arange(cfg.num_rays, dtype=np.int64)
    else:
        ray_ids = _np(ray_ids).astype(np.int64)
    key = rng.base_key(seed)
    uniforms = rng.precompute_uniforms(
        key, torch.from_numpy(ray_ids), cfg.max_depth).numpy().astype(F)

    t_min = F(cfg.t_min)
    out = np.zeros((len(ray_ids), 3), F)
    for idx, rid in enumerate(ray_ids):
        u = uniforms[idx]
        pixel = rid // cfg.spp
        i = pixel % cfg.nx
        j = pixel // cfg.nx  # bottom-up row, matching render/camera.py
        s = (F(i) + u[0, 0]) / F(cfg.nx)
        t = (F(j) + u[0, 1]) / F(cfg.ny)
        # Lens-disk sample (mirror of core.rng.unit_disk_sample).
        r = math.sqrt(float(u[0, 2]))
        theta = 2.0 * math.pi * float(u[0, 3])
        rd = lens_radius * np.array([r * math.cos(theta),
                                     r * math.sin(theta)], F)
        offset = rd[0] * cu + rd[1] * cv
        o = cam_origin + offset
        d = _normalize(lower_left + s * horizontal + t * vertical
                       - cam_origin - offset)
        out[idx] = trace_ray_oracle(scene, o, d, u, 0, cfg.max_depth, t_min)

    if full_image:
        img = out.reshape(cfg.ny, cfg.nx, cfg.spp, 3).mean(axis=2)
        return img[::-1].astype(F)
    return out
