"""The port's flat BVH (build and walk) and slab test against the JAX
package's.

The builders are host code with exact output: the port's NumPy builder (SAH
and median split) and its native one (``native/frt_native.cpp``, built by
the port with g++) must give JAX's NumPy builder's six arrays, array for
array.  The walk (``intersect_bvh``) must find JAX's walk's winners on the
same rays: hits and primitives equal, t within ``rtol=2e-4``, the JAX
package's bound between its walk and its sweep (tests/test_bvh.py): the
two packages' sphere tests sum the dot products in their own orders and
torch's float32 square root on the CPU is an ulp off on about 0.7% of
inputs, which a near root ``-b - sqrt(disc)`` magnifies (measured 1.0e-4).
The walk must also find the brute-force sweep's winners, as the JAX
package holds its own walk (knife-edge grazers aside, ``rtol=2e-4``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.accel.build import build_bvh as jax_build
from first_raytracer_tpu.accel.traverse import intersect_bvh as jax_walk
from first_raytracer_tpu.geometry.aabb import aabb_hit as jax_aabb_hit
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu.scene.soa import SceneBuilder
from first_raytracer_tpu_torch.accel import native
from first_raytracer_tpu_torch.accel.build import build_bvh, scene_prim_bounds
from first_raytracer_tpu_torch.accel.traverse import intersect_bvh
from first_raytracer_tpu_torch.convert import scene_from_numpy
from first_raytracer_tpu_torch.geometry.aabb import aabb_hit
from first_raytracer_tpu_torch.render.integrator import intersect_brute

FIELDS = ("node_min", "node_max", "node_first", "node_count", "node_skip",
          "prim_ids")


def _random_sphere_scene(n, seed):
    r = np.random.RandomState(seed)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n):
        b.sphere(r.randn(3) * 4, 0.2 + r.rand(), m)
    return b.build()


SCENES = {
    "spheres-1": lambda: _random_sphere_scene(1, 0),
    "spheres-7": lambda: _random_sphere_scene(7, 2),
    "spheres-257": lambda: _random_sphere_scene(257, 4),
    "three-spheres": lambda: jb.three_spheres()[0],
    "random-spheres": lambda: jb.random_scene()[0],
    "triangle-mesh": lambda: jb.triangle_scene()[0],
}


def _rays(n, seed, spread=6.0):
    r = np.random.RandomState(seed)
    o = (r.randn(n, 3) * spread).astype(np.float32)
    d = r.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("sah", [True, False], ids=["sah", "median"])
@pytest.mark.parametrize("name", list(SCENES))
def test_build_matches_jax(name, sah, backend):
    js = SCENES[name]()
    want = jax_build(js, max_leaf=4, use_sah=sah, backend="numpy")
    got = build_bvh(scene_from_numpy(js.as_numpy()), max_leaf=4,
                    use_sah=sah, backend=backend)
    for f in FIELDS:
        g = getattr(got, f)
        assert g.dtype == (torch.float32 if f.startswith("node_m")
                           else torch.int32), f
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.num_nodes == want.num_nodes and got.max_leaf == want.max_leaf


def test_flat_layout_invariants():
    """Preorder with skip links: prim_ids a permutation, leaves tiling it,
    children inside their parents, primitives inside their leaves
    (tests/test_bvh.py:34-80 on the port's arrays)."""
    scene = scene_from_numpy(_random_sphere_scene(64, 0).as_numpy())
    bvh = build_bvh(scene, max_leaf=4)
    first, count = bvh.node_first.numpy(), bvh.node_count.numpy()
    skip = bvh.node_skip.numpy()
    mn, mx = bvh.node_min.numpy(), bvh.node_max.numpy()
    n = bvh.num_nodes
    assert sorted(bvh.prim_ids.tolist()) == list(range(64))
    assert np.all(skip > np.arange(n)) and np.all(skip <= n)
    leaves = count > 0
    assert np.all(count[leaves] <= 4)
    covered = np.zeros(64, bool)
    for f, c in zip(first[leaves], count[leaves]):
        assert not covered[f:f + c].any()
        covered[f:f + c] = True
    assert covered.all()
    seen = 0
    stack = [(0, -np.inf * np.ones(3), np.inf * np.ones(3))]
    while stack:
        i, pmn, pmx = stack.pop()
        seen += 1
        assert np.all(mn[i] >= pmn - 1e-5) and np.all(mx[i] <= pmx + 1e-5)
        if count[i] == 0:
            left, right = i + 1, skip[i + 1]
            assert i < right < skip[i]
            stack.append((left, mn[i], mx[i]))
            stack.append((right, mn[i], mx[i]))
    assert seen == n
    pbmin, pbmax = scene_prim_bounds(scene.as_numpy())
    pids = bvh.prim_ids.numpy()
    for li in np.nonzero(leaves)[0]:
        for s in range(count[li]):
            assert np.all(pbmin[pids[first[li] + s]] >= mn[li] - 1e-5)
            assert np.all(pbmax[pids[first[li] + s]] <= mx[li] + 1e-5)


@pytest.mark.parametrize("name", list(SCENES))
def test_walk_matches_jax_and_brute_force(name):
    js = SCENES[name]()
    o, d = _rays(512, 99, spread=4.0)
    jp, jt, jh = map(np.asarray, jax_walk(
        js, jax_build(js, max_leaf=4, backend="numpy"), jnp.asarray(o),
        jnp.asarray(d), 1e-3))
    ts = scene_from_numpy(js.as_numpy())
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tp, tt, th = intersect_bvh(ts, build_bvh(ts, max_leaf=4), to, td, 1e-3)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy(), jh)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(tt.numpy()[jh], jt[jh], rtol=2e-4)
    bp, bt, bh = intersect_brute(ts, to, td, 1e-3)
    assert (bh != th).float().mean() < 0.005
    both = bh & th
    if both.any():
        agree = bp[both] == tp[both]
        assert agree.float().mean() > 0.995
        torch.testing.assert_close(tt[both][agree], bt[both][agree],
                                   rtol=2e-4, atol=0)


def test_median_split_walk_with_two_slot_leaves():
    js = _random_sphere_scene(64, 5)
    ts = scene_from_numpy(js.as_numpy())
    bvh = build_bvh(ts, max_leaf=2, use_sah=False)
    o, d = (torch.from_numpy(x) for x in _rays(256, 6))
    got = intersect_bvh(ts, bvh, o, d, 1e-3, max_leaf=2)
    want = intersect_brute(ts, o, d, 1e-3)
    torch.testing.assert_close(got[2], want[2])
    torch.testing.assert_close(got[0][want[2]], want[0][want[2]])


def test_aabb_hit_matches_jax():
    """The slab test with an axis-parallel direction (1/d = inf), an origin
    on a slab plane (0 * inf = NaN, which fails the test as in JAX), and a
    per-ray t_max."""
    r = np.random.RandomState(3)
    o = (r.randn(256, 3) * 3).astype(np.float32)
    d = r.randn(256, 3).astype(np.float32)
    d[:32, 1:] = 0.0                    # axis-parallel rays
    o[:16, 1] = 1.0                     # on the slab plane y = 1
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    bmin = np.array([-1.0, -2.0, -1.0], np.float32)
    bmax = np.array([2.0, 1.0, 1.5], np.float32)
    t_max = (r.rand(256) * 10).astype(np.float32)
    want = np.asarray(jax_aabb_hit(jnp.asarray(o), jnp.asarray(inv),
                                   jnp.asarray(bmin), jnp.asarray(bmax),
                                   1e-3, jnp.asarray(t_max)))
    got = aabb_hit(torch.from_numpy(o), torch.from_numpy(inv),
                   torch.from_numpy(bmin), torch.from_numpy(bmax), 1e-3,
                   torch.from_numpy(t_max))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 256


def test_backends_and_errors(monkeypatch):
    ts = scene_from_numpy(jb.three_spheres()[0].as_numpy())
    with pytest.raises(ValueError):
        build_bvh(ts, backend="cuda")
    assert native.available(), native.error()
    monkeypatch.setattr(native, "_load", lambda: (None, "no compiler"))
    with pytest.raises(RuntimeError, match="no compiler"):
        build_bvh(ts, backend="native")
    auto = build_bvh(ts, backend="auto")  # falls to NumPy, same arrays
    want = build_bvh(ts, backend="numpy")
    for f in FIELDS:
        torch.testing.assert_close(getattr(auto, f), getattr(want, f))
    assert auto.to("meta").device.type == "meta"
