"""The plain reference path tracer that decides ``correct``.

A straightforward implementation of the book's path tracer (Shirley, *Ray
Tracing in One Weekend*) with the port's conventions, in plain PyTorch:
the thin-lens camera, the sphere hit, the lambertian, metal and dielectric
scatter, the sky, and the bounce loop, keyed by the Threefry draws of
``reference/threefry.py``.  It imports nothing of the program (nor of the
JAX package) and takes only the benchmark's own inputs: the scene's arrays
(``benchmark/scenes.py``) and the camera's parameters, from which it works
out the camera frame again.

Conventions (the port's, which are the JAX package's):

- ray id ``= pixel * spp + sample``, pixel ``= j * nx + i`` with ``j``
  counted from the bottom row;
- closest hit: the near root, else the far root, inside ``(t_min, BIG)``;
  the lowest sphere id wins an exact tie; the normal is ``(p - c) / r``
  with the signed radius;
- trip ``d = 0 .. max_depth``: a miss adds ``throughput * sky`` and ends
  the path; a hit scatters with bounce ``d``'s draws; a metal ray that
  leaves below its surface, or a hit at ``d = max_depth``, ends black.

Everything is computed in ``dtype`` (float64 for the reference; the
control runs the same code in bfloat16).  The closest hit sweeps every
sphere: a float32 prefilter in two matrix products (with TF32 off) keeps
each pair whose discriminant is above minus a bound on its rounding, and
the kept pairs are solved again in ``dtype``, so the prefilter drops only
pairs that cannot hit.
"""
from __future__ import annotations

import math

import torch

from . import threefry

BIG = 1e30
SKY_WHITE = (1.0, 1.0, 1.0)
SKY_BLUE = (0.5, 0.7, 1.0)
MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC = 0, 1, 2
# Elements of a prefilter block (rays x spheres), ~0.5 GB a float32 matrix.
_BLOCK = 1 << 27
# Rays traced together; their state and draws stay a few hundred MB.
_RAYS = 1 << 20


def _dot(a, b):
    return (a * b).sum(-1)


def _normalize(v, eps=0.0):
    n2 = _dot(v, v)[..., None]
    if eps:
        n2 = torch.clamp(n2, min=eps)
    pos = n2 > 0
    return v * torch.where(pos, torch.rsqrt(torch.where(pos, n2, 1.0)), 0.0)


class Reference:
    """The reference over one scene and camera on ``device``.

    ``scene``: numpy arrays ``sphere_center`` (N, 3), ``sphere_radius``
    (N,), ``sphere_mat`` (N,), ``mat_type`` (M,), ``albedo`` (M, 3),
    ``fuzz`` (M,), ``ref_idx`` (M,).  ``camera``: ``lookfrom``,
    ``lookat``, ``vup``, ``vfov``, ``aperture``, ``focus_dist``.
    ``image``: ``nx``, ``ny``, ``spp``, ``t_min``.
    """

    def __init__(self, scene, camera, image, device, dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        self.nx, self.ny, self.spp = (int(image[k]) for k in ("nx", "ny",
                                                               "spp"))
        self.t_min = float(image["t_min"])

        def t(a, dt=dtype):
            return torch.as_tensor(a).to(device=self.device, dtype=dt)

        c64 = t(scene["sphere_center"], torch.float64)
        r64 = t(scene["sphere_radius"], torch.float64)
        self.centers, self.radii = c64.to(dtype), r64.to(dtype)
        self.sphere_mat = t(scene["sphere_mat"], torch.int64)
        self.mat_type = t(scene["mat_type"], torch.int64)
        self.albedo = t(scene["albedo"])
        self.fuzz = t(scene["fuzz"])
        self.ref_idx = t(scene["ref_idx"])
        # The prefilter's right-hand factors: b = [d, d.o] . [-c, 1] and
        # |o - c|^2 - r^2 = [o, 1, |o|^2] . [-2c, |c|^2 - r^2, 1].
        ones = torch.ones_like(r64)[:, None]
        self._pb = torch.cat([-c64, ones], 1).float()
        self._pq = torch.cat([-2 * c64, (_dot(c64, c64) - r64 * r64)[:, None],
                              ones], 1).float()
        self._cnorm = torch.linalg.norm(c64, dim=1)
        self._r2 = r64 * r64
        self._frame(camera)

    def _frame(self, cam):
        """The camera frame, worked out in float64 from its parameters."""
        f64 = dict(dtype=torch.float64, device=self.device)
        lookfrom = torch.tensor(cam["lookfrom"], **f64)
        lookat = torch.tensor(cam["lookat"], **f64)
        vup = torch.tensor(cam["vup"], **f64)
        focus = float(cam["focus_dist"])
        half_h = math.tan(math.radians(float(cam["vfov"])) / 2.0)
        half_w = (self.nx / self.ny) * half_h
        w = _normalize(lookfrom - lookat)
        u = _normalize(torch.linalg.cross(vup, w))
        v = torch.linalg.cross(w, u)
        dt = self.dtype
        self.origin = lookfrom.to(dt)
        self.lower_left = (lookfrom - half_w * focus * u - half_h * focus * v
                           - focus * w).to(dt)
        self.horizontal = (2 * half_w * focus * u).to(dt)
        self.vertical = (2 * half_h * focus * v).to(dt)
        self.u, self.v = u.to(dt), v.to(dt)
        self.lens_radius = float(cam["aperture"]) / 2.0

    # -- camera ---------------------------------------------------------

    def camera_rays(self, seed, ids):
        """(origin, direction) of ray ids (R,) int64."""
        u = threefry.uniforms(seed, ids, 0, self.dtype)
        pixel = ids // self.spp
        i = (pixel % self.nx).to(self.dtype)
        j = (pixel // self.nx).to(self.dtype)
        s = (i + u[:, 0]) / self.nx
        t = (j + u[:, 1]) / self.ny
        r = torch.sqrt(u[:, 2])
        theta = (2.0 * math.pi) * u[:, 3]
        rd0 = self.lens_radius * r * torch.cos(theta)
        rd1 = self.lens_radius * r * torch.sin(theta)
        offset = rd0[:, None] * self.u + rd1[:, None] * self.v
        origin = self.origin + offset
        direction = (self.lower_left + s[:, None] * self.horizontal
                     + t[:, None] * self.vertical - origin)
        return origin, _normalize(direction)

    # -- closest hit ----------------------------------------------------

    def closest_hit(self, o, d):
        """(sphere id (R,) int64, t (R,), hit (R,) bool) of rays (o, d)."""
        R, ns = o.shape[0], self.centers.shape[0]
        win = torch.full((R,), ns, dtype=torch.int64, device=self.device)
        tbest = torch.full((R,), BIG, dtype=torch.float64, device=self.device)
        step = max(256, _BLOCK // max(ns, 1))
        for lo in range(0, R, step):
            hi = min(R, lo + step)
            ri, si = self._candidates(o[lo:hi], d[lo:hi])
            if ri.numel() == 0:
                continue
            t = self._solve(o[lo:hi][ri], d[lo:hi][ri], si).double()
            tb = torch.full((hi - lo,), BIG, dtype=torch.float64,
                            device=self.device)
            tb.scatter_reduce_(0, ri, t, "amin")
            best = (t == tb[ri]) & (t < BIG)
            wid = torch.full((hi - lo,), ns, dtype=torch.int64,
                             device=self.device)
            wid.scatter_reduce_(0, ri, torch.where(best, si, ns), "amin")
            win[lo:hi], tbest[lo:hi] = wid, tb
        hit = win < ns
        return torch.where(hit, win, 0), tbest.to(self.dtype), hit

    def _candidates(self, o, d):
        """The (ray, sphere) pairs whose float32 discriminant is above
        minus a bound on its rounding error: every pair that can hit."""
        o64, d64 = o.double(), d.double()
        a_b = torch.cat([d64, _dot(d64, o64)[:, None]], 1).float()
        a_q = torch.cat([o64, torch.ones_like(o64[:, :1]),
                         _dot(o64, o64)[:, None]], 1).float()
        b = a_b @ self._pb.T
        disc = (a_q @ self._pq.T).neg_().addcmul_(b, b)  # b^2 - (|oc|^2 - r^2)
        del b
        # Every term of the discriminant is at most (|o| + |c|)^2 + r^2;
        # float32 products of five terms round within ~1e-6 of that.
        onorm = torch.linalg.norm(o64, dim=1).max()
        margin = (1e-5 * ((onorm + self._cnorm) ** 2 + self._r2)).float()
        keep = disc > -margin[None, :]
        del disc
        ri, si = keep.nonzero(as_tuple=True)
        return ri, si

    def _solve(self, o, d, si):
        """t of rays against their candidate spheres, in ``dtype``."""
        oc = o - self.centers[si]
        b = _dot(oc, d)
        r = self.radii[si]
        disc = b * b - (_dot(oc, oc) - r * r)
        has = disc > 0
        sq = torch.sqrt(torch.where(has, disc, 0.0))
        tn, tf = -b - sq, -b + sq
        near = has & (tn > self.t_min) & (tn < BIG)
        far = has & (tf > self.t_min) & (tf < BIG)
        return torch.where(near, tn, torch.where(far, tf, BIG))

    # -- shading --------------------------------------------------------

    def scatter(self, d, p, n, mat, u):
        """(new direction, attenuation, scattered) at the hits."""
        mt = self.mat_type[mat]
        fuzz, ref = self.fuzz[mat], self.ref_idx[mat]
        z = 1.0 - 2.0 * u[:, 0]
        rxy = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = (2.0 * math.pi) * u[:, 1]
        rad = torch.pow(u[:, 2], 1.0 / 3.0)
        ball = rad[:, None] * torch.stack(
            [rxy * torch.cos(phi), rxy * torch.sin(phi), z], -1)
        lam = _normalize(n + ball, eps=1e-20)
        dn = _dot(d, n)
        reflected = d - 2.0 * dn[:, None] * n
        metal_raw = reflected + fuzz[:, None] * ball
        metal_ok = _dot(metal_raw, n) > 0.0
        metal = _normalize(metal_raw, eps=1e-20)
        outside = dn > 0.0
        out_n = torch.where(outside[:, None], -n, n)
        eta = torch.where(outside, ref, 1.0 / ref)
        cosine = torch.where(outside, ref * dn, -dn)
        uv = _normalize(d)
        dt = _dot(uv, out_n)
        k = 1.0 - eta * eta * (1.0 - dt * dt)
        can = k > 0
        refr = (eta[:, None] * (uv - out_n * dt[:, None])
                - out_n * torch.sqrt(torch.where(can, k, 0.0))[:, None])
        r0 = ((1.0 - ref) / (1.0 + ref)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - cosine) ** 5
        reflect = u[:, 3] < torch.where(can, schlick, 1.0)
        diel = torch.where(reflect[:, None], _normalize(reflected, eps=1e-20),
                           _normalize(torch.where(can[:, None], refr, 0.0),
                                      eps=1e-20))
        is_m = (mt == MAT_METAL)[:, None]
        is_d = (mt == MAT_DIELECTRIC)[:, None]
        new_d = torch.where(is_d, diel, torch.where(is_m, metal, lam))
        att = torch.where(is_d, torch.ones_like(self.albedo[mat]),
                          self.albedo[mat])
        ok = torch.where(mt == MAT_METAL, metal_ok, True)
        return new_d, att, ok

    def sky(self, d):
        t = 0.5 * (d[:, 1] + 1.0)
        white = torch.tensor(SKY_WHITE, dtype=self.dtype, device=self.device)
        blue = torch.tensor(SKY_BLUE, dtype=self.dtype, device=self.device)
        return (1.0 - t)[:, None] * white + t[:, None] * blue

    # -- paths ----------------------------------------------------------

    def trace(self, seed, ids, max_depth, record_mats=False):
        """Trace ray ids (R,) to the end of their paths.

        Returns ``radiance`` (R, 3) and ``segments`` (R,) int64 (closest-hit
        queries).  With ``record_mats`` also ``mats`` (R, max_depth + 1)
        int64, the material of each trip's attenuating hit (lambertian or
        metal; -1 elsewhere), and ``sky`` (R, 3), the sky a path ends in
        (0 if it ends black), so that the radiance is ``sky`` times the
        product of the albedos of ``mats``."""
        outs = [self._trace(seed, ids[lo:lo + _RAYS], max_depth, record_mats)
                for lo in range(0, ids.shape[0], _RAYS)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def _trace(self, seed, ids, max_depth, record_mats):
        R, dev, dt = ids.shape[0], self.device, self.dtype
        o, d = self.camera_rays(seed, ids)
        thr = torch.ones((R, 3), dtype=dt, device=dev)
        rad = torch.zeros((R, 3), dtype=dt, device=dev)
        segs = torch.zeros((R,), dtype=torch.int64, device=dev)
        out = {}
        if record_mats:
            mats = torch.full((R, max_depth + 1), -1, dtype=torch.int64,
                              device=dev)
            sky = torch.zeros((R, 3), dtype=dt, device=dev)
        live = torch.arange(R, device=dev)
        for depth in range(max_depth + 1):
            if live.numel() == 0:
                break
            segs[live] += 1
            ol, dl = o[live], d[live]
            sid, t, hit = self.closest_hit(ol, dl)
            miss = live[~hit]
            s = self.sky(dl[~hit])
            rad[miss] += thr[miss] * s
            if record_mats:
                sky[miss] = s
            live, ol, dl, sid, t = (x[hit] for x in (live, ol, dl, sid, t))
            p = ol + t[:, None] * dl
            n = (p - self.centers[sid]) / self.radii[sid][:, None]
            mat = self.sphere_mat[sid]
            u = threefry.uniforms(seed, ids[live], 1 + depth, dt)
            new_d, att, ok = self.scatter(dl, p, n, mat, u)
            if depth == max_depth:
                break
            if record_mats:
                mats[live, depth] = torch.where(
                    self.mat_type[mat] == MAT_DIELECTRIC, -1, mat)
            live, p, new_d, att = (x[ok] for x in (live, p, new_d, att))
            thr[live] = thr[live] * att
            o[live], d[live] = p, new_d
        out.update(radiance=rad, segments=segs)
        if record_mats:
            out.update(mats=mats, sky=sky)
        return out

    def pixel_means(self, seed, pixels, max_depth):
        """(P, 3) mean radiance of pixels (P,) int64 over their ``spp``
        samples, and the segments their paths took (a Python int)."""
        s = torch.arange(self.spp, device=self.device)
        ids = (pixels.to(self.device)[:, None] * self.spp + s).reshape(-1)
        out = self.trace(seed, ids, max_depth)
        rad = out["radiance"].reshape(-1, self.spp, 3).mean(1)
        return rad, int(out["segments"].sum())


def path_radiance(albedo, mats, sky):
    """(R, 3) radiance of recorded paths (``Reference.trace`` with
    ``record_mats``) under ``albedo`` (M, 3): ``sky`` times the product of
    the albedos of ``mats``; differentiable in ``albedo``."""
    ones = torch.ones((1, 3), dtype=albedo.dtype, device=albedo.device)
    table = torch.cat([albedo, ones])  # row -1 is the factor 1
    return sky * table[mats].prod(dim=1)
