"""The port's wavefront closest hits (K4, K5) against the JAX package's.

The packs are host NumPy copied from JAX and must be equal to JAX's, array
for array.  The plain versions of K4 (``intersect_pallas_reference``) and
K5 (``intersect_clustered_reference``) run on the CPU; JAX's Pallas kernels
run in interpret mode, as its own tests run them.  Bounds: hit masks and
winners equal, t within ``rtol=1e-5, atol=1e-5`` (the two packages compute
each (ray, primitive) t in the same operation order, but XLA may contract
multiply-adds, and a near root ``-b - sqrt(disc)`` of the 100-unit ground
sphere cancels to an absolute error of an ulp of b, 7.6e-6 measured); on
sphere_field(5000) ``rtol=1e-4``, the JAX package's own bound for that
scene (tests/test_clustered.py:56-59), whose camera sits far out.
Within the port, K5's plain version equals K4's on every ray (same t
formula, the same (t, id) winner rule), and the CUDA kernels are held to
both on the card (tests/test_torch_cuda.py).
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.kernels import intersect_clustered as jic
from first_raytracer_tpu.kernels import intersect_pallas as jip
from first_raytracer_tpu.render.integrator import trace_rays as jax_trace
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.kernels import intersect_clustered as tic
from first_raytracer_tpu_torch.kernels import intersect_pallas as tip
from first_raytracer_tpu_torch.render import integrator as tint
from first_raytracer_tpu_torch.render.camera import generate_rays

# The six presets (the fields cut to a size the CPU sweeps quickly) and the
# 5,000-sphere field of the JAX package's own clustered test.
PACK_SCENES = {
    "three-spheres": lambda: jb.three_spheres(),
    "random-spheres": lambda: jb.random_scene(),
    "triangle-mesh": lambda: jb.triangle_scene(),
    "camera-effects": lambda: jb.camera_showcase(),
    "sphere-field": lambda: jb.sphere_field(n=2500),
    "triangle-field": lambda: jb.triangle_field(n=2000),
    "sphere-field-5000": lambda: jb.sphere_field(n=5000),
}


def _rays(n=700, seed=0, lo=-8.0, hi=8.0):
    """Uniform origins in [lo, hi]^3, normal directions
    (tests/test_clustered.py:24-29)."""
    r = np.random.default_rng(seed)
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _single_type(scene, keep):
    """The scene with only its spheres or only its triangles."""
    if keep == "spheres":
        return dataclasses.replace(
            scene, tri_v0=scene.tri_v0[:0], tri_v1=scene.tri_v1[:0],
            tri_v2=scene.tri_v2[:0], tri_mat=scene.tri_mat[:0])
    return dataclasses.replace(
        scene, sphere_center=scene.sphere_center[:0],
        sphere_radius=scene.sphere_radius[:0],
        sphere_mat=scene.sphere_mat[:0])


def _assert_same_hits(got, want, t_rtol=1e-5):
    p1, t1, h1 = (np.asarray(x) for x in got)
    p2, t2, h2 = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_allclose(t1[h1], t2[h1], rtol=t_rtol, atol=1e-5)
    assert (t1[~h1] == 1e30).all() and (p1[~h1] == 0).all()


@pytest.mark.parametrize("name", list(PACK_SCENES))
def test_packs_match_jax(name):
    js = PACK_SCENES[name]()[0]
    ts = scene_from_numpy(js.as_numpy())
    want, got = jip.pack_scene_pallas(js), tip.pack_scene_pallas(ts)
    np.testing.assert_array_equal(got.spheres.numpy(),
                                  np.asarray(want.spheres))
    np.testing.assert_array_equal(got.tris.numpy(), np.asarray(want.tris))
    assert (got.sphere_rows, got.tri_rows) == (want.sphere_rows,
                                               want.tri_rows)
    want, got = jic.pack_scene_clustered(js), tic.pack_scene_clustered(ts)
    for f in ("sph", "tri", "sph_box", "tri_box"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert (got.sph_clusters, got.tri_clusters) == (want.sph_clusters,
                                                    want.tri_clusters)
    # The int32 ids and counts are the f32 gid rows' live slots.
    for f, rows, gid_row in (("sph", 8, 4), ("tri", 16, 9)):
        planes = np.asarray(getattr(want, f)).reshape(-1, rows, 128)
        gid = getattr(got, f"{f}_gid").numpy()
        count = getattr(got, f"{f}_count").numpy()
        live = np.arange(128)[None, :] < count[:, None]
        np.testing.assert_array_equal(gid[live],
                                      planes[:, gid_row][live].astype(int))
        assert (gid[~live] == 0).all()
    assert int(got.sph_count.sum()) == js.num_spheres
    assert int(got.tri_count.sum()) == js.num_triangles


K4_CASES = [("three-spheres", 700), ("triangle-mesh", 512),
            ("random-spheres", 1024), ("camera-effects", 700)]


@pytest.mark.parametrize("name,n_rays", K4_CASES,
                         ids=[c[0] for c in K4_CASES])
def test_plain_k4_matches_jax(name, n_rays):
    js = PACK_SCENES[name]()[0]
    ts = scene_from_numpy(js.as_numpy())
    o, d = _rays(n_rays, 7)
    want = jip.intersect_pallas(js, jip.pack_scene_pallas(js),
                                jnp.asarray(o), jnp.asarray(d), 1e-3,
                                interpret=True)
    got = tip.intersect_pallas(ts, tip.pack_scene_pallas(ts),
                               torch.from_numpy(o), torch.from_numpy(d),
                               1e-3)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    _assert_same_hits(got, want)


@pytest.mark.parametrize("keep", ["spheres", "triangles"])
def test_plain_kernels_single_type_scenes(keep):
    js = _single_type(jb.triangle_scene()[0], keep)
    ts = scene_from_numpy(js.as_numpy())
    o, d = _rays(700, 3)
    want = jip.intersect_pallas(js, jip.pack_scene_pallas(js),
                                jnp.asarray(o), jnp.asarray(d), 1e-3,
                                interpret=True)
    got4 = tip.intersect_pallas(ts, tip.pack_scene_pallas(ts),
                                torch.from_numpy(o), torch.from_numpy(d),
                                1e-3)
    _assert_same_hits(got4, want)
    want5 = jic.intersect_clustered(js, jic.pack_scene_clustered(js),
                                    jnp.asarray(o), jnp.asarray(d), 1e-3,
                                    interpret=True)
    got5 = tic.intersect_clustered(ts, tic.pack_scene_clustered(ts),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   1e-3)
    _assert_same_hits(got5, want5)
    for a, b in zip(got5, got4):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


K5_CASES = [("three-spheres", 128), ("random-spheres", 1),
            ("random-spheres", 7), ("random-spheres", 128),
            ("triangle-mesh", 7), ("camera-effects", 128)]


@pytest.mark.parametrize("name,max_leaf", K5_CASES,
                         ids=[f"{n}-{m}" for n, m in K5_CASES])
def test_plain_k5_matches_jax(name, max_leaf):
    """700 rays: not a multiple of the TPU kernels' 512-ray tile."""
    js = PACK_SCENES[name]()[0]
    ts = scene_from_numpy(js.as_numpy())
    o, d = _rays(700, 0)
    want = jic.intersect_clustered(
        js, jic.pack_scene_clustered(js, max_leaf=max_leaf), jnp.asarray(o),
        jnp.asarray(d), 1e-3, interpret=True)
    pack = tic.pack_scene_clustered(ts, max_leaf=max_leaf)
    got = tic.intersect_clustered(ts, pack, torch.from_numpy(o),
                                  torch.from_numpy(d), 1e-3)
    _assert_same_hits(got, want)
    dense = tip.intersect_pallas(ts, tip.pack_scene_pallas(ts),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 1e-3)
    for a, b in zip(got, dense):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_k5_matches_jax_on_a_large_field():
    """sphere_field(5000), 1024 rays (tests/test_clustered.py:52-60)."""
    js = PACK_SCENES["sphere-field-5000"]()[0]
    ts = scene_from_numpy(js.as_numpy())
    o, d = _rays(1024, 3)
    jpack = jic.pack_scene_clustered(js)
    want = jic.intersect_clustered(js, jpack, jnp.asarray(o), jnp.asarray(d),
                                   1e-3, interpret=True)
    pack = tic.pack_scene_clustered(ts)
    assert pack.sph_clusters > 30
    got = tic.intersect_clustered(ts, pack, torch.from_numpy(o),
                                  torch.from_numpy(d), 1e-3)
    _assert_same_hits(got, want, t_rtol=1e-4)
    dense = tip.intersect_pallas_reference(ts, tip.pack_scene_pallas(ts),
                                           torch.from_numpy(o),
                                           torch.from_numpy(d), 1e-3)
    for a, b in zip(got, dense):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["random-spheres", "triangle-mesh"])
def test_plain_kernels_match_brute_force(name):
    """On the camera's own rays, K4's and K5's plain versions find the
    dense sweep's (``intersect_brute``) winners; t to ``rtol=1e-5`` (the
    sweep sums ``oc * d`` in another order)."""
    js, jc, cfg = jb.build_preset(name, nx=24, ny=12, spp=2)
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    ids = torch.arange(cfg.num_rays)
    o, d = generate_rays(tc, cfg.nx, cfg.ny, cfg.spp, ids,
                         trng.camera_uniforms(trng.base_key(0), ids))
    want = tint.intersect_brute(ts, o, d, 1e-3)
    for got in (tip.intersect_pallas(ts, tip.pack_scene_pallas(ts), o, d,
                                     1e-3),
                tic.intersect_clustered(ts, tic.pack_scene_clustered(ts), o,
                                        d, 1e-3)):
        _assert_same_hits(got, want)


@pytest.mark.parametrize("accel", ["dense", "clustered"])
def test_trace_rays_with_the_kernels_matches_jax(accel):
    """The wavefront integrator on K4's or K5's plain version against
    JAX's integrator on its interpret-mode kernel, three-spheres 40x20 @ 2:
    per-ray radiance within the image bound (``(|a - b| > 1e-3).mean() <
    0.01``, median below 1e-5: the two packages' camera rays and scatter
    differ by ulps, measured 5 of 4800 values beyond 1e-5).  Against the
    port's dense-sweep integrator: ``rtol=1e-5, atol=1e-6``, JAX's bound
    for its own pair (tests/test_clustered.py:148)."""
    js, jc, cfg = jb.three_spheres(nx=40, ny=20, spp=2)
    key = jrng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    if accel == "dense":
        jpack, jfn = jip.pack_scene_pallas(js), jip.intersect_pallas
    else:
        jpack, jfn = jic.pack_scene_clustered(js), jic.intersect_clustered

    def isect(scene, acc, o_, d_, t_min):
        return jfn(scene, acc, o_, d_, t_min, interpret=True)

    want = np.asarray(jax_trace(js, o, d, ids, key, cfg, accel=jpack,
                                intersect_fn=isect))
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    tcfg = tint.RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                             max_depth=cfg.max_depth, t_min=cfg.t_min)
    tids = torch.arange(cfg.num_rays)
    to, td = generate_rays(tc, tcfg.nx, tcfg.ny, tcfg.spp, tids,
                           trng.camera_uniforms(trng.base_key(0), tids))
    tpack = (tip.pack_scene_pallas(ts) if accel == "dense"
             else tic.pack_scene_clustered(ts))
    got = tint.trace_rays(ts, to, td, tids, trng.base_key(0), tcfg,
                          accel=tpack)
    diff = np.abs(got.numpy() - want)
    assert (diff > 1e-3).mean() < 0.01 and np.median(diff) < 1e-5
    brute = tint.trace_rays(ts, to, td, tids, trng.base_key(0), tcfg)
    torch.testing.assert_close(got, brute, rtol=1e-5, atol=1e-6)


def test_default_intersect_dispatch(monkeypatch):
    """``default_intersect`` sends each accel type to its intersector and
    runs it without autograd."""
    from first_raytracer_tpu_torch.accel import traverse
    from first_raytracer_tpu_torch.accel.build import build_bvh

    js = jb.three_spheres()[0]
    ts = scene_from_numpy(js.as_numpy())
    o, d = (torch.from_numpy(x) for x in _rays(64, 1))
    called = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            called.append((name, torch.is_grad_enabled()))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tip, "intersect_pallas",
                        spy("K4", tip.intersect_pallas))
    monkeypatch.setattr(tic, "intersect_clustered",
                        spy("K5", tic.intersect_clustered))
    monkeypatch.setattr(traverse, "intersect_bvh",
                        spy("bvh", traverse.intersect_bvh))
    want = tint.intersect_brute(ts, o, d, 1e-3)
    for accel in (None, tip.pack_scene_pallas(ts),
                  tic.pack_scene_clustered(ts), build_bvh(ts)):
        got = tint.default_intersect(ts, accel, o, d, 1e-3)
        _assert_same_hits(got, want)
    assert called == [("K4", False), ("K5", False), ("bvh", False)]


def test_clustered_counters_on_the_cpu():
    """``return_iters`` on the CPU gives an ungated sweep's counters: every
    cluster and slot of each type, no box tests."""
    js = jb.triangle_scene()[0]
    ts = scene_from_numpy(js.as_numpy())
    pack = tic.pack_scene_clustered(ts, max_leaf=7)
    o, d = (torch.from_numpy(x) for x in _rays(32, 2))
    *_, sweeps = tic.intersect_clustered(ts, pack, o, d, 1e-3,
                                         return_iters=True)
    assert sweeps.shape == (32, 4) and sweeps.dtype == torch.int32
    want = [pack.sph_clusters + pack.tri_clusters, ts.num_spheres,
            ts.num_triangles, 0]
    assert (sweeps == torch.tensor(want, dtype=torch.int32)).all()


def test_guards_and_devices():
    js = jb.three_spheres()[0]
    ts = scene_from_numpy(js.as_numpy())
    for bad in (0, 129):
        with pytest.raises(ValueError):
            tic.pack_scene_clustered(ts, max_leaf=bad)
    o, d = (torch.from_numpy(x) for x in _rays(8, 0))
    for pack, fn in ((tip.pack_scene_pallas(ts), tip.intersect_pallas),
                     (tic.pack_scene_clustered(ts),
                      tic.intersect_clustered)):
        with pytest.raises(ValueError):  # rays on another device
            fn(ts, pack, o.to("meta"), d.to("meta"), 1e-3)
        with pytest.raises(ValueError):  # a device without a kernel
            fn(ts, pack.to("meta"), o.to("meta"), d.to("meta"), 1e-3)
        with pytest.raises(ValueError):  # not (R, 3)
            fn(ts, pack, o[:, :2], d[:, :2], 1e-3)
        assert pack.to("cpu").device == torch.device("cpu")
    before = (tip.intersect_pallas.launches, tic.intersect_clustered.launches)
    tip.intersect_pallas(ts, tip.pack_scene_pallas(ts), o, d, 1e-3)
    tic.intersect_clustered(ts, tic.pack_scene_clustered(ts), o, d, 1e-3)
    # The counters count CUDA launches only.
    assert (tip.intersect_pallas.launches,
            tic.intersect_clustered.launches) == before


# The presets and fields of K5's supergroup checks (the small presets,
# sphere_field(600) and triangle_field(2000)), at three leaf sizes.
SUPER_SCENES = {
    "three-spheres": lambda: jb.three_spheres(),
    "random-spheres": lambda: jb.random_scene(),
    "triangle-mesh": lambda: jb.triangle_scene(),
    "camera-effects": lambda: jb.camera_showcase(),
    "sphere-field-600": lambda: jb.sphere_field(n=600),
    "triangle-field-2000": lambda: jb.triangle_field(n=2000),
}
SUPER_CASES = [(name, leaf) for name in SUPER_SCENES for leaf in (1, 7, 128)]
SUPER_IDS = [f"{n}-{m}" for n, m in SUPER_CASES]


@pytest.mark.parametrize("name,max_leaf", SUPER_CASES, ids=SUPER_IDS)
def test_clustered_pack_keeps_jax_arrays(name, max_leaf):
    """The supergroup level adds arrays and reorders nothing: the first six
    fields equal JAX's at every leaf size, and the kernel's rows are the
    planes' (cx, cy, cz, r*r) and (v0, v1 - v0, v2 - v0), rounded once;
    an empty sphere slot holds (0, 0, 0, -inf), which no ray hits."""
    js = SUPER_SCENES[name]()[0]
    ts = scene_from_numpy(js.as_numpy())
    # The TPU's VMEM budget does not bound the port's pack.
    want = jic.pack_scene_clustered(js, max_leaf=max_leaf,
                                    vmem_budget_bytes=1 << 30)
    got = tic.pack_scene_clustered(ts, max_leaf=max_leaf)
    for f in ("sph", "tri", "sph_box", "tri_box"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert (got.sph_clusters, got.tri_clusters) == (want.sph_clusters,
                                                    want.tri_clusters)
    for f, rows, width in (("sph", 8, 4), ("tri", 16, 12)):
        planes = np.asarray(getattr(want, f)).reshape(-1, rows, 128)
        cols = planes.transpose(0, 2, 1).reshape(-1, rows)  # slot-major
        live = (np.arange(128)[None, :]
                < getattr(got, f"{f}_count").numpy()[:, None]).reshape(-1)
        vec = getattr(got, f"{f}_vec").numpy()
        assert vec.shape == (cols.shape[0], width)
        empty = [0, 0, 0, -np.inf] if f == "sph" else [0] * 12
        assert (vec[~live] == empty).all()
        c = cols[live]
        if f == "sph":
            want_vec = np.stack([c[:, 0], c[:, 1], c[:, 2],
                                 c[:, 3] * c[:, 3]], axis=1)
        else:
            z = np.zeros_like(c[:, 0])
            want_vec = np.stack(
                [c[:, 0], c[:, 1], c[:, 2], z,
                 c[:, 3] - c[:, 0], c[:, 4] - c[:, 1], c[:, 5] - c[:, 2], z,
                 c[:, 6] - c[:, 0], c[:, 7] - c[:, 1], c[:, 8] - c[:, 2], z],
                axis=1)
        np.testing.assert_array_equal(vec[live], want_vec)


@pytest.mark.parametrize("name,max_leaf", SUPER_CASES, ids=SUPER_IDS)
def test_supergroup_boxes_bound_their_clusters(name, max_leaf):
    """Row s of a type's supergroup boxes is the union of cluster boxes
    8 s .. 8 s + 7, the last, partial run included; rows past the true
    clusters stay inverted, so they never pass a slab test."""
    ts = scene_from_numpy(SUPER_SCENES[name]()[0].as_numpy())
    pack = tic.pack_scene_clustered(ts, max_leaf=max_leaf)
    for f in ("sph", "tri"):
        box = getattr(pack, f"{f}_box").numpy()
        sup = getattr(pack, f"{f}_super_box").numpy()
        k = getattr(pack, f"{f}_clusters")
        assert sup.shape == (box.shape[0] // 8, 8)
        kss = -(-k // 8)
        for s in range(kss):
            members = box[8 * s:min(8 * s + 8, k)]
            assert (sup[s, 0:3] <= members[:, 0:3]).all()
            assert (sup[s, 3:6] >= members[:, 3:6]).all()
            np.testing.assert_array_equal(sup[s, 0:3],
                                          members[:, 0:3].min(axis=0))
            np.testing.assert_array_equal(sup[s, 3:6],
                                          members[:, 3:6].max(axis=0))
        assert (sup[kss:, 0:3] == 1e30).all()
        assert (sup[kss:, 3:6] == -1e30).all()


# slab.cuh's widening, in float32 as the kernel computes it.
_NEAR = torch.tensor(1.0) - torch.tensor(4e-6)
_FAR = torch.tensor(1.0) + torch.tensor(4e-6)
_PAD = torch.tensor(1e-6)


def _slab_gate(box, o, iv, t_min, bound):
    """slab.cuh::slab_gate in plain torch: (R, 8) box rows, (R, 3) origins
    and inverse directions, (R,) bounds; True unless the ray surely misses
    the box in [t_min, bound].  torch.minimum and torch.maximum return NaN
    when either operand is NaN, as the kernel's nan_min and nan_max do, so
    a NaN interval passes."""
    t0 = (box[:, 0:3] - o) * iv
    t1 = (box[:, 3:6] - o) * iv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    near = near * _NEAR - _PAD
    far = far * _FAR + _PAD
    return ~(torch.maximum(near, torch.tensor(t_min)) >
             torch.minimum(far, bound))


def _two_level_sweep(pack, o, d, t_min):
    """K5's gated sweep in plain torch: per type, each supergroup's box and
    then the boxes of its clusters slab-tested against each ray's running
    best t, the clusters that pass swept, their hits folded as the
    lexicographic (t, global id) minimum.  Returns (prim, t, box tests per
    ray)."""
    R = o.shape[0]
    iv = 1.0 / d
    t_best = torch.full((R,), 1e30)
    g_best = torch.full((R,), torch.iinfo(torch.int32).max,
                        dtype=torch.int32)
    boxes = torch.zeros(R, dtype=torch.int32)
    for f, rows, t_fn in (
            ("sph", 8, lambda ray, p: tip.sphere_oc_t(*ray, *p[:4], t_min)),
            ("tri", 16, lambda ray, p: tip.triangle_mt_t(*ray, p[:9],
                                                         t_min))):
        k = getattr(pack, f"{f}_clusters")
        box, sup = getattr(pack, f"{f}_box"), getattr(pack, f"{f}_super_box")
        planes, gid = getattr(pack, f), getattr(pack, f"{f}_gid")
        count = getattr(pack, f"{f}_count")
        for s in range(-(-k // 8)):
            boxes += 1
            open_s = _slab_gate(sup[s].expand(R, 8), o, iv, t_min, t_best)
            for c in range(8 * s, min(8 * s + 8, k)):
                boxes += open_s.int()
                sweep = open_s & _slab_gate(box[c].expand(R, 8), o, iv,
                                            t_min, t_best)
                idx = sweep.nonzero()[:, 0]
                m = int(count[c])
                if not len(idx):
                    continue
                ray = [x[idx][:, j:j + 1] for x in (o, d) for j in range(3)]
                t_cl = t_fn(ray, planes[c * rows:(c + 1) * rows, :m])
                t_c, g_c = tic._lex_min(t_cl, gid[c, :m])
                tb, gb = t_best[idx], g_best[idx]
                better = (t_c < tb) | ((t_c == tb) & (t_c < 1e30)
                                       & (g_c < gb))
                t_best[idx] = torch.where(better, t_c, tb)
                g_best[idx] = torch.where(better, g_c, gb)
    return torch.where(t_best < 1e30, g_best, 0), t_best, boxes


@pytest.mark.parametrize("rays", ["random", "camera"])
@pytest.mark.parametrize("max_leaf", [1, 7, 128])
def test_two_level_gate_never_culls_the_winner(rays, max_leaf):
    """K5's two-level gate, written here in plain torch with slab.cuh's
    widening and NaN rule: on 4096 random rays and on the camera rays of
    sphere_field(5000), the gated sweep finds the plain K5's winner on
    every ray, with fewer box tests than clusters on average and at most
    one per cluster and supergroup on every ray.  (A gate at the winner's
    own t could cull it: a grazing hit's f32 t can fall ~1e-3 short of its
    sphere's box; the running best t the sweep gates against is larger
    whenever that matters here.)"""
    from first_raytracer_tpu_torch.scene.builders import build_preset

    ts, cam, cfg = build_preset("sphere-field", n=5000, nx=64, ny=32, spp=2)
    if rays == "random":
        o, d = (torch.from_numpy(x) for x in _rays(4096, 5))
    else:
        ids = torch.arange(cfg.num_rays)
        o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                             trng.camera_uniforms(trng.base_key(0), ids))
    pack = tic.pack_scene_clustered(ts, max_leaf=max_leaf)
    # The plain K4's winner is the plain K5's (test_plain_k5_matches_jax_on_
    # a_large_field), and its sweep does not grow with small leaves' empty
    # slots.
    prim, t, hit = tip.intersect_pallas_reference(
        ts, tip.pack_scene_pallas(ts), o, d, 1e-3)
    assert int(hit.sum()) > o.shape[0] // 2
    g_prim, g_t, boxes = _two_level_sweep(pack, o, d, 1e-3)
    assert torch.equal(g_prim, prim) and torch.equal(g_t, t)
    k = pack.sph_clusters + pack.tri_clusters
    kss = -(-pack.sph_clusters // 8) - (-pack.tri_clusters // 8)
    assert int(boxes.max()) <= k + kss
    assert float(boxes.float().mean()) < k
