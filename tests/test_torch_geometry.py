"""Vector math, sphere and triangle hits, and scatter against JAX.

Inputs are the ``random_rays`` fixture and seeded numpy scenes.  Hit masks
must agree exactly; hit distances to 1e-5 relative; scatter, given the same
uniforms, to 1e-5 abs (sqrt, sin/cos and cbrt round differently per libm).
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import vecmath as jv
from first_raytracer_tpu.geometry import sphere as jsph
from first_raytracer_tpu.geometry import triangle as jtri
from first_raytracer_tpu.materials.scatter import scatter as jax_scatter
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import scene_from_numpy
from first_raytracer_tpu_torch.core import vecmath as tv
from first_raytracer_tpu_torch.geometry import sphere as tsph
from first_raytracer_tpu_torch.geometry import triangle as ttri
from first_raytracer_tpu_torch.materials.scatter import scatter

BIG = 1e30


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _spheres(seed=0, n=24):
    r = np.random.RandomState(seed)
    c = (r.randn(n, 3) * 3).astype(np.float32)
    rad = (r.rand(n) * 1.5 + 0.2).astype(np.float32)
    rad[::5] *= -1  # hollow shells
    return c, rad


def _triangles(seed=1, n=24):
    r = np.random.RandomState(seed)
    v0 = (r.randn(n, 3) * 3).astype(np.float32)
    v1 = v0 + r.randn(n, 3).astype(np.float32) * 2
    v2 = v0 + r.randn(n, 3).astype(np.float32) * 2
    return v0, v1.astype(np.float32), v2.astype(np.float32)


def _assert_hits_match(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got < BIG, want < BIG)
    m = want < BIG
    assert m.any()
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-6)


def test_vecmath_matches(random_rays):
    """1e-6 abs on unit-scale inputs."""
    o, d = random_rays
    r = np.random.RandomState(3)
    n = r.randn(*d.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    eta = (r.rand(len(d)) * 1.5 + 0.3).astype(np.float32)
    cos = r.rand(len(d)).astype(np.float32)
    pairs = [
        (tv.dot(_t(o), _t(d)), jv.dot(o, d)),
        (tv.cross(_t(o), _t(d)), jv.cross(o, d)),
        (tv.length(_t(o)), jv.length(o)),
        (tv.normalize(_t(o)), jv.normalize(o)),
        (tv.normalize(_t(o * 0), 1e-20), jv.normalize(o * 0, 1e-20)),
        (tv.point_at(_t(o), _t(d), _t(cos)), jv.point_at(o, d, cos)),
        (tv.reflect(_t(d), _t(n)), jv.reflect(d, n)),
        (tv.schlick(_t(cos), _t(eta)), jv.schlick(cos, eta)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    (rf, ok), (jrf, jok) = (tv.refract(_t(d), _t(n), _t(eta)),
                            jv.refract(d, n, eta))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(rf.numpy(), np.asarray(jrf), rtol=0,
                               atol=1e-6)


def test_sphere_hit_all_and_one(random_rays):
    o, d = random_rays
    c, rad = _spheres()
    got = tsph.sphere_hit_all(_t(o), _t(d), _t(c), _t(rad), 1e-3, BIG)
    want = jsph.sphere_hit_all(o, d, c, rad, 1e-3, BIG)
    _assert_hits_match(got, want)
    k = np.arange(len(o)) % len(c)
    got1 = tsph.sphere_hit_one(_t(o), _t(d), _t(c[k]), _t(rad[k]), 1e-3, BIG)
    want1 = jsph.sphere_hit_one(o, d, c[k], rad[k], 1e-3, BIG)
    _assert_hits_match(got1, want1)


def _near_tangent(seed, n, spread=0.02):
    """Rays aimed within ``spread`` of a radius from each sphere's centre,
    far from the origin: their discriminants are differences of nearly
    equal squares."""
    r = np.random.RandomState(seed)
    c = r.uniform(-50, 50, (n, 3)).astype(np.float32)
    rad = r.uniform(0.2, 5, n).astype(np.float32)
    o = r.uniform(-50, 50, (n, 3)).astype(np.float32)
    u = r.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    d = c + u * (rad * r.uniform(1 - spread, 1 + spread, n))[:, None] - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, c, rad


def _fma(a, b, c):
    """``a * b + c`` rounded once (in float64, then to float32: the
    product is exact there)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _xla_cpu_form(o, d, c, rad, fused_squares):
    """``sphere_hit_one``/``sphere_hit_all`` as XLA's CPU backend compiles
    them under ``jax.jit``: b = oc.d a chain of fused multiply-adds, c =
    |oc|^2 - r^2 with r^2 fused, b^2 - c rounded once, and |oc|^2 fused
    too in ``sphere_hit_all`` alone."""
    oc = o - c
    b = _fma(oc[..., 2], d[..., 2], _fma(oc[..., 1], d[..., 1],
                                         oc[..., 0] * d[..., 0]))
    if fused_squares:
        s = _fma(oc[..., 2], oc[..., 2], _fma(oc[..., 1], oc[..., 1],
                                              oc[..., 0] * oc[..., 0]))
    else:
        s = (oc * oc).sum(-1, dtype=np.float32)
    disc = _fma(b, b, -_fma(-rad, rad, s))
    sq = np.sqrt(np.where(disc > 0, disc, np.float32(0)))
    tn, tf = -b - sq, -b + sq
    return np.where((disc > 0) & (tn > 1e-3), tn,
                    np.where((disc > 0) & (tf > 1e-3), tf, np.float32(BIG)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", ["one", "all"])
def test_sphere_hits_near_tangent_round_as_jax(which, seed):
    """The float32 quadratic on near-tangent rays, far from the origin.

    The port rounds each operation as JAX does op by op: hit masks equal,
    t bit-equal on all but 1 in 1000 rays and those an ulp apart (torch's
    float32 sqrt on the CPU).  Under ``jax.jit`` XLA's CPU backend fuses
    products into multiply-adds, and which ones depends on the program:
    the standalone functions are reproduced by ``_xla_cpu_form`` (all but
    1 in 1000 rays, which XLA rounds otherwise by where they fall in its
    vector loop), and there more than nine in ten near-tangent roots part
    from the op-by-op ones, by up to 5e-4 relative.  The port keeps the
    op-by-op form, which its kernels' plain versions and the JAX tests'
    eager calls share (PERF.md)."""
    n = 20000 if which == "one" else 150
    o, d, c, rad = _near_tangent(seed, n)
    fn = tsph.sphere_hit_one if which == "one" else tsph.sphere_hit_all
    jfn = jsph.sphere_hit_one if which == "one" else jsph.sphere_hit_all
    got = fn(*[_t(x) for x in (o, d, c, rad)], 1e-3, BIG).numpy()
    want = np.asarray(jfn(o, d, c, rad, 1e-3, BIG))
    np.testing.assert_array_equal(got < BIG, want < BIG)
    hits = want < BIG
    assert hits.sum() > 0.9 * n
    assert (got != want).mean() <= 1e-3, (got != want).sum()
    np.testing.assert_allclose(got[hits], want[hits], rtol=1.2e-7)

    jitted = np.asarray(jax.jit(jfn)(o, d, c, rad, 1e-3, BIG))
    if which == "all":
        o, d = o[:, None], d[:, None]
    model = _xla_cpu_form(o, d, c, rad, fused_squares=which == "all")
    assert (model != jitted).mean() <= 1e-3, (model != jitted).sum()
    both = hits & (jitted < BIG)
    assert (jitted[both] != want[both]).mean() > 0.9
    np.testing.assert_allclose(jitted[both], want[both], rtol=5e-4)


def test_sphere_normal_signed_radius(random_rays):
    o, d = random_rays
    c, rad = _spheres()
    k = np.arange(len(o)) % len(c)
    t = np.full(len(o), 0.7, np.float32)
    p, n = tsph.sphere_normal(_t(o), _t(d), _t(t), _t(c[k]), _t(rad[k]))
    jp, jn = jsph.sphere_normal(o, d, t, c[k], rad[k])
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-6)


def test_triangle_hit_all_and_one(random_rays):
    o, d = random_rays
    v0, v1, v2 = _triangles()
    got = ttri.triangle_hit_all(_t(o), _t(d), _t(v0), _t(v1), _t(v2), 1e-3,
                                BIG)
    want = jtri.triangle_hit_all(o, d, v0, v1, v2, 1e-3, BIG)
    _assert_hits_match(got, want)
    k = np.arange(len(o)) % len(v0)
    got1 = ttri.triangle_hit_one(_t(o), _t(d), _t(v0[k]), _t(v1[k]),
                                 _t(v2[k]), 1e-3, BIG)
    want1 = jtri.triangle_hit_one(o, d, v0[k], v1[k], v2[k], 1e-3, BIG)
    _assert_hits_match(got1, want1)
    np.testing.assert_allclose(
        ttri.triangle_normal(_t(v0), _t(v1), _t(v2)).numpy(),
        np.asarray(jtri.triangle_normal(v0, v1, v2)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("preset", ["three-spheres", "camera-effects"])
def test_scatter_matches(random_rays, preset):
    """Every material of the preset, the same uniforms on both sides."""
    js, _, _ = jb.build_preset(preset, nx=8, ny=4, spp=1)
    ts = scene_from_numpy(js.as_numpy())
    o, d = random_rays
    r = np.random.RandomState(4)
    n = r.randn(*d.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u = r.rand(len(d), 4).astype(np.float32)
    mat = (np.arange(len(d)) % js.num_materials).astype(np.int32)
    got = scatter(ts, _t(mat), _t(d), _t(o), _t(n), _t(u))
    want = jax_scatter(js, jnp.asarray(mat), d, o, n, u)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_aabb_helpers_match():
    """The host box helpers equal JAX's on spheres (hollow glass's negative
    radius included) and triangles, and so does the box union."""
    from first_raytracer_tpu.geometry import aabb as jaabb
    from first_raytracer_tpu_torch.geometry import aabb as taabb

    r = np.random.RandomState(9)
    c = r.uniform(-5, 5, (32, 3)).astype(np.float32)
    rad = r.uniform(-1, 1, 32).astype(np.float32)
    v0, v1, v2 = (r.uniform(-5, 5, (32, 3)).astype(np.float32)
                  for _ in range(3))
    for got, want in ((taabb.sphere_aabb_np(c, rad),
                       jaabb.sphere_aabb_np(c, rad)),
                      (taabb.triangle_aabb_np(v0, v1, v2),
                       jaabb.triangle_aabb_np(v0, v1, v2)),
                      (taabb.surrounding_box_np(v0, v1, v2, c),
                       jaabb.surrounding_box_np(v0, v1, v2, c))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_divide_is_correctly_rounded():
    """``vecmath.divide`` (the camera's (i + u) / nx in every plain
    version) rounds as a division: its f32 quotient is the f64 quotient
    rounded once, as in the kernels and in JAX's camera."""
    r = np.random.RandomState(11)
    x = torch.from_numpy((r.rand(4096) * 1200).astype(np.float32))
    for n in (800, 450, 1200, 3):
        got = tv.divide(x, n)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, (x.double() / n).float(), rtol=0,
                                   atol=0)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jnp.asarray(x.numpy()) / n))
