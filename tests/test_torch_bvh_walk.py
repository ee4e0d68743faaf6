"""K6, the flat-BVH walk's CUDA kernel, on the CPU, and the paths that take
a ``FlatBVH`` through their default (graphed) route.

- K6's own source (``kernels/csrc/bvh_walk.cu``), compiled by g++ through
  the host emulation (``kernels/host_emu``) and driven by its wrapper's
  launch code on CPU tensors, against its plain version
  (``accel/traverse.py::intersect_bvh_plain``, the lockstep walk): prim,
  t and hit bit-equal.  The one rounding that differs on the CPU is the
  square root: torch's float32 ``sqrt`` here is a vectorised
  approximation an ulp off on about 0.7% of inputs, where the card's (and
  the emulation's) is correctly rounded, and a near root ``-b - sqrt``
  magnifies that ulp (64 ulps of t seen on three-spheres).  So the plain
  walk runs with ``torch.sqrt`` taken in float64 and rounded once, which
  is what the card computes; against the unchanged plain walk the
  primitives and hits are equal.  Its per-ray counters (nodes, sphere
  slots, triangle slots) equal the plain walk's row by row: it visits the
  same nodes and leaf slots.  Each case runs through both of K6's paths,
  forced by the budget its launch is given (shared memory: the budget is
  the staged bytes; global: 0).  Scenes: three-spheres, random-spheres
  (64 rays), the triangle-mesh preset, its triangles alone, random spheres
  mixed with triangles, a median-split BVH with 2-slot leaves, rays along
  the axes whose origins lie on slab planes (0 * inf = NaN, a miss),
  ``max_leaf`` above the builder's, and 4000 triangles whose records and
  slots are over ``SHARED_BUDGET`` (the global path by default).  Between
  two launches over one scene its centres move in place: the second
  launch reads them anew.  The node records (``pack_nodes``) decode to
  the BVH's arrays, and the bytes the kernel's source stages are the
  wrapper's ``shared_bytes``.
- ``render_ray_batch`` with a ``FlatBVH`` on its default route (on the
  CPU the loop's bodies run through ``LOOPS``' buffers) against the JAX
  package's ``render_ray_batch`` with its BVH, at 16x8 @ 2 and depth 8:
  per-ray radiance within the image bound of
  ``tests/test_torch_wavefront_graph.py``.
- ``record_paths`` and ``record_paths_pool`` with a ``FlatBVH``: tapes
  equal to JAX's ``record_paths`` on the same BVH.
- ``graphed_route`` on a CUDA device takes the graphs for a ``FlatBVH``
  with the default closest hit or ``intersect_bvh``, and still refuses a
  Python ``intersect_fn`` unless the caller says which (a decision, made
  without a card).
- ``cli render --bvh``, ``fit --bvh`` and ``occupancy --bvh`` leave the
  route to its default.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.accel.build import build_bvh as jax_build
from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff.replay import record_paths as jax_record
from first_raytracer_tpu.render.api import render_ray_batch as jax_batch
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch import cli
from first_raytracer_tpu_torch.accel import traverse as tv
from first_raytracer_tpu_torch.accel.build import build_bvh
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.render import graphed
from first_raytracer_tpu_torch.render.api import render_ray_batch
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.render.integrator import (RenderConfig,
                                                         default_intersect)
from first_raytracer_tpu_torch.scene.builders import build_preset
from first_raytracer_tpu_torch.scene.soa import SceneBuilder

KEY = trng.base_key(0)


@pytest.fixture(scope="module")
def host_k6():
    """K6's source built by g++ for the host, bound as the card's library
    and reached through ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = build_host_library(units=("bvh_walk.cu",))
    mk.bind_bvh(lib)

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


def _rounded_sqrt(x):
    """torch's float32 square root as the card takes it: in float64,
    rounded once."""
    return _TORCH_SQRT(x.double()).to(x.dtype)


_TORCH_SQRT = torch.sqrt


def _camera_rays(cam, cfg, n=None, key=KEY):
    ids = torch.arange(min(n or cfg.num_rays, cfg.num_rays))
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         trng.camera_uniforms(key, ids))
    return o.contiguous(), d.contiguous()


def _random_rays(n, seed, spread=6.0):
    g = torch.Generator().manual_seed(seed)
    o = (torch.randn((n, 3), generator=g) * spread)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g),
                                      dim=1)
    return o.contiguous(), d.contiguous()


def _triangles_only(scene):
    """The scene's triangles without its spheres."""
    return dataclasses.replace(
        scene, sphere_center=scene.sphere_center[:0],
        sphere_radius=scene.sphere_radius[:0],
        sphere_mat=scene.sphere_mat[:0])


def _mixed(seed=3, spheres=40, triangles=40):
    """Random spheres and triangles in one scene (ids: spheres first)."""
    r = np.random.RandomState(seed)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(spheres):
        b.sphere(r.randn(3) * 4, 0.2 + r.rand(), m)
    for _ in range(triangles):
        v0 = r.randn(3) * 4
        b.triangle(v0, v0 + r.randn(3), v0 + r.randn(3), m)
    return b.build()


def _slab_plane_rays(bvh):
    """Rays along the axes from origins on the planes of the BVH's boxes:
    the slab test meets 0 * inf = NaN and must miss there, as JAX's
    does."""
    mn, mx = bvh.node_min, bvh.node_max
    os_, ds = [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            d = torch.zeros(3)
            d[axis] = sign
            for node in range(0, bvh.num_nodes, max(1, bvh.num_nodes // 16)):
                for plane in (mn[node], mx[node]):
                    o = 0.5 * (mn[node] + mx[node])
                    # On the node's plane of another axis, moving along
                    # ``axis``.
                    other = (axis + 1) % 3
                    o = o.clone()
                    o[other] = plane[other]
                    o[axis] = -20.0 * sign
                    os_.append(o)
                    ds.append(d)
    return torch.stack(os_).contiguous(), torch.stack(ds).contiguous()


def _case(name):
    """(scene, bvh, max_leaf, rays) of a K6 case."""
    if name in ("three-spheres", "random-spheres", "triangle-mesh",
                "triangles-only"):
        preset = "triangle-mesh" if name == "triangles-only" else name
        scene, cam, cfg = build_preset(preset, device="cpu", nx=16, ny=8,
                                       spp=2)
        if name == "triangles-only":
            scene = _triangles_only(scene)
        bvh = build_bvh(scene, max_leaf=4)
        n = 64 if name == "random-spheres" else None
        rays = [_camera_rays(cam, cfg, n), _random_rays(128, 1)]
        return scene, bvh, 4, rays
    if name == "mixed":
        scene = scene_from_numpy(_mixed().as_numpy())
        bvh = build_bvh(scene, max_leaf=4)
        return scene, bvh, 4, [_random_rays(256, 2)]
    if name == "median-2-slot":
        scene = scene_from_numpy(_mixed(5, 64, 0).as_numpy())
        bvh = build_bvh(scene, max_leaf=2, use_sah=False)
        return scene, bvh, 2, [_random_rays(256, 6)]
    if name == "slab-planes":
        scene = scene_from_numpy(_mixed(7, 24, 24).as_numpy())
        bvh = build_bvh(scene, max_leaf=4)
        return scene, bvh, 4, [_slab_plane_rays(bvh)]
    if name == "max-leaf-above":
        scene = scene_from_numpy(_mixed(9, 48, 16).as_numpy())
        bvh = build_bvh(scene, max_leaf=3)
        return scene, bvh, 7, [_random_rays(256, 4)]
    if name == "over-budget":
        scene = scene_from_numpy(_mixed(11, 0, 4000).as_numpy())
        bvh = build_bvh(scene, max_leaf=4)
        return scene, bvh, 4, [_random_rays(96, 8, spread=3.0)]
    raise KeyError(name)


K6_CASES = ["three-spheres", "random-spheres", "triangle-mesh",
            "triangles-only", "mixed", "median-2-slot", "slab-planes",
            "max-leaf-above", "over-budget"]
# The budget that forces each of K6's paths: the bytes the shared path
# stages, or none.
PATH_BUDGET = {"shared": tv.shared_bytes, "global": lambda scene, bvh: 0}
# (case, path): every case that fits SHARED_BUDGET takes the shared path by
# default, so that path keeps the case's own id.
K6_RUNS = [pytest.param(name, path,
                        id=name if path == "shared" else f"{name}-{path}")
           for name in K6_CASES for path in PATH_BUDGET]


def _k6_against_plain(monkeypatch, scene, bvh, max_leaf, o, d, budget):
    """K6 through its launch code under ``budget`` against the plain walk:
    (prim, t, hit) bit-equal with the card's square root, primitives and
    hits equal to the unchanged plain walk's, and the per-ray counters
    equal.  Returns K6's hit."""
    prim, t, hit, counts = tv._launch_cuda(scene, bvh, o, d, 1e-3,
                                           max_leaf, True, budget)
    assert prim.dtype == torch.int32 and t.dtype == torch.float32
    assert hit.dtype == torch.bool and counts.dtype == torch.int32
    rp, rt, rh = tv.intersect_bvh_plain(scene, bvh, o, d, 1e-3, max_leaf)
    assert torch.equal(prim, rp) and torch.equal(hit, rh)
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _rounded_sqrt)
        cp, ct, ch, cc = tv.intersect_bvh_plain(scene, bvh, o, d, 1e-3,
                                                max_leaf, True)
    assert torch.equal(prim, cp) and torch.equal(t, ct)
    assert torch.equal(hit, ch) and torch.equal(hit, t < 1e30)
    assert torch.equal(counts, cc)
    nodes, spheres, triangles = counts.long().sum(0).tolist()
    assert (counts[:, 0] >= 1).all() and nodes <= o.shape[0] * \
        bvh.num_nodes
    assert (spheres == 0) == (scene.num_spheres == 0)
    assert (triangles == 0) == (scene.num_triangles == 0)
    return hit


@pytest.mark.parametrize("name, path", K6_RUNS)
def test_k6_equals_plain(host_k6, monkeypatch, name, path):
    """K6's (prim, t, hit) bit-equal to the plain walk's with the card's
    square root, its primitives and hits equal to the unchanged plain
    walk's, and its counters equal to the plain walk's row by row, through
    the path its budget forces."""
    scene, bvh, max_leaf, rays = _case(name)
    budget = PATH_BUDGET[path](scene, bvh)
    assert tv.walk_path(scene, bvh, budget) == path
    default = "global" if name == "over-budget" else "shared"
    assert tv.walk_path(scene, bvh) == default
    for o, d in rays:
        hit = _k6_against_plain(monkeypatch, scene, bvh, max_leaf, o, d,
                                budget)
    if name == "slab-planes":
        assert bool((~hit).any()) and bool(hit.any())


@pytest.mark.parametrize("path", list(PATH_BUDGET))
def test_k6_reads_a_scene_moved_in_place(host_k6, monkeypatch, path):
    """Sphere centres and triangle vertices moved in place between two
    launches over one BVH (as ``cli fit --bvh`` moves them): the second
    launch equals the plain walk on the moved scene, through each path."""
    scene = scene_from_numpy(_mixed(13, 32, 24).as_numpy())
    bvh = build_bvh(scene, max_leaf=4)
    budget = PATH_BUDGET[path](scene, bvh)
    o, d = _random_rays(160, 9)
    before = _k6_against_plain(monkeypatch, scene, bvh, 4, o, d, budget)
    g = torch.Generator().manual_seed(13)
    scene.sphere_center.add_(0.3 * torch.randn(
        scene.sphere_center.shape, generator=g))
    scene.tri_v1.add_(0.3 * torch.randn(scene.tri_v1.shape, generator=g))
    after = _k6_against_plain(monkeypatch, scene, bvh, 4, o, d, budget)
    assert not torch.equal(before, after)


@pytest.mark.parametrize("name", K6_CASES)
def test_k6_records_and_staged_bytes(host_k6, name):
    """``FlatBVH.nodes`` decodes to the node arrays (min, skip, max, count
    << 24 | first); the bytes the kernel's source stages for the shared
    path are ``shared_bytes``; the budget picks the shared path at those
    bytes and the global one a byte below."""
    scene, bvh, _, _ = _case(name)
    rec = bvh.nodes
    assert torch.equal(rec[:, 0:3].view(torch.float32), bvh.node_min)
    assert torch.equal(rec[:, 4:7].view(torch.float32), bvh.node_max)
    assert torch.equal(rec[:, 3], bvh.node_skip)
    word = rec[:, 7].long() & 0xFFFFFFFF
    assert torch.equal(word >> 24, bvh.node_count.long())
    assert torch.equal(word & 0xFFFFFF, bvh.node_first.long())
    n = tv.shared_bytes(scene, bvh)
    assert host_k6.frt_bvh_walk_shared_bytes(
        bvh.num_nodes, bvh.prim_ids.shape[0], scene.num_triangles) == n
    assert tv.walk_path(scene, bvh, n) == "shared"
    assert tv.walk_path(scene, bvh, n - 1) == "global"


def test_pack_nodes_refuses_what_its_bits_cannot_hold():
    """A first slot past 24 bits (2^24 primitives) or a leaf count past 8
    bits is refused where the record is made."""
    from first_raytracer_tpu_torch.accel.build import pack_nodes

    z3, z1 = np.zeros((1, 3), np.float32), np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="24 bits"):
        pack_nodes(z3, z3, z1, z1 + 1, z1 + 1,
                   np.broadcast_to(np.int32(0), (1 << 24,)))
    with pytest.raises(ValueError, match="8 bits"):
        pack_nodes(z3, z3, z1, z1 + 256, z1 + 1, np.zeros(256, np.int32))
    rec = pack_nodes(z3, z3, z1 + (1 << 24) - 1, z1 + 255, z1 + 1,
                     np.zeros((1 << 24) - 1, np.int32))
    assert rec[0, 7] == -1  # all 32 bits set


def test_k6_launch_skips_no_rays_and_refuses_bad_input(host_k6):
    """No launch for R = 0; a wrong dtype, unaligned records or max_leaf
    is refused before the launch; ``intersect_bvh`` on the CPU returns no
    counters (the plain walk does, asked directly) and another device has
    no walk."""
    scene, bvh, _, _ = _case("mixed")
    before = tv.intersect_bvh.launches
    e = torch.zeros((0, 3))
    prim, t, hit, _ = tv._launch_cuda(scene, bvh, e, e, 1e-3, 4, False)
    assert prim.shape == t.shape == hit.shape == (0,)
    assert tv.intersect_bvh.launches == before
    o, d = _random_rays(8, 0)
    with pytest.raises(ValueError, match="dtype"):
        tv._launch_cuda(scene, dataclasses.replace(
            bvh, node_skip=bvh.node_skip.long()), o, d, 1e-3, 4, False)
    with pytest.raises(ValueError, match="nodes has dtype"):
        tv._launch_cuda(scene, dataclasses.replace(
            bvh, nodes=bvh.nodes.view(torch.float32)), o, d, 1e-3, 4, False)
    with pytest.raises(ValueError, match="aligned"):
        tv._launch_cuda(scene, dataclasses.replace(
            bvh, nodes=torch.zeros(bvh.nodes.numel() + 1, dtype=torch.int32)
            [1:].view(bvh.nodes.shape)), o, d, 1e-3, 4, False)
    with pytest.raises(ValueError, match="max_leaf"):
        tv._launch_cuda(scene, bvh, o, d, 1e-3, 0, False)
    with pytest.raises(ValueError, match="counters"):
        tv.intersect_bvh(scene, bvh, o, d, 1e-3, return_counters=True)
    with pytest.raises(ValueError, match="device"):
        tv.intersect_bvh(scene, bvh.to("meta"), o, d, 1e-3)


def _jax_case(name="random-spheres", nx=16, ny=8, spp=2, depth=8):
    js, jc, cfg = jb.build_preset(name, nx=nx, ny=ny, spp=spp)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    tcfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=depth,
                        t_min=cfg.t_min)
    return js, jc, cfg, ts, tc, tcfg


def test_render_ray_batch_with_a_bvh_matches_jax():
    """The batch through the default route (the loop's bodies through
    ``LOOPS`` on the CPU) with a ``FlatBVH``, against JAX's with its BVH:
    per-ray radiance within the image bound."""
    js, jc, cfg, ts, tc, tcfg = _jax_case()
    ids = np.arange(cfg.num_rays, dtype=np.int32)
    want = np.asarray(jax_batch(js, jc, cfg, jrng.base_key(2),
                                jnp.asarray(ids),
                                jax_build(js, max_leaf=4, backend="numpy")))
    passes = graphed.LOOPS.passes
    got = render_ray_batch(ts, tc, tcfg, trng.base_key(2),
                           torch.from_numpy(ids).long(),
                           build_bvh(ts, max_leaf=4))
    assert graphed.LOOPS.passes > passes
    diff = np.abs(got.numpy() - want)
    assert np.isfinite(got.numpy()).all()
    assert (diff > 1e-3).mean() < 0.01 and np.median(diff) < 1e-5


@pytest.mark.parametrize("recorder", ["lockstep", "pool"])
def test_recorders_with_a_bvh_match_jax(recorder):
    """``record_paths`` (the camera rays given) and ``record_paths_pool``
    (a pool of 100 slots) with a ``FlatBVH``: tapes equal to JAX's
    lockstep ``record_paths`` on the same BVH."""
    js, jc, cfg, ts, tc, tcfg = _jax_case()
    key = jrng.base_key(1)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    want = np.asarray(jax_record(js, o, d, ids, key, cfg,
                                 jax_build(js, max_leaf=4, backend="numpy")))
    bvh = build_bvh(ts, max_leaf=4)
    tids = torch.arange(tcfg.num_rays)
    if recorder == "lockstep":
        to, td = _camera_rays(tc, tcfg, key=trng.base_key(1))
        got = trp.record_paths(ts, to, td, tids, trng.base_key(1), tcfg, bvh)
    else:
        got = trp.record_paths_pool(ts, tc, tcfg, trng.base_key(1), tids,
                                    bvh, pool_size=100)
    np.testing.assert_array_equal(got.numpy(), want)


ROUTES = {
    "default": (None, True),
    "intersect_bvh": (tv.intersect_bvh, True),
    "python-fn": (lambda *a: default_intersect(*a), None),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_graphed_route_takes_the_walk_on_the_card(route):
    """On a CUDA device a ``FlatBVH`` with the default closest hit or
    ``intersect_bvh`` takes the graphs; a Python ``intersect_fn`` must
    still be asked for either way."""
    scene, _, _ = build_preset("three-spheres", device="cpu", nx=8, ny=4,
                               spp=1)
    bvh = build_bvh(scene, max_leaf=4)
    cuda = torch.device("cuda")
    fn, want = ROUTES[route]
    if want is None:
        with pytest.raises(ValueError, match="graphed=False"):
            graphed.graphed_route(cuda, bvh, fn, None)
    else:
        assert graphed.graphed_route(cuda, bvh, fn, None) is want
    assert not graphed.graphed_route(cuda, bvh, fn, False)
    assert graphed.graphed_route(cuda, bvh, fn, True)


CLI_RUNS = {
    "render": ["render", "--mode", "regenerative"],
    "fit": ["fit", "--fields", "albedo", "--steps", "1", "--max-depth", "3"],
    "occupancy": ["occupancy"],
}


@pytest.mark.parametrize("cmd", list(CLI_RUNS))
def test_cli_bvh_takes_the_default_route(monkeypatch, tmp_path, capsys,
                                         cmd):
    """``--bvh`` leaves every wavefront loop of the command to its
    default route (``graphed`` None: the graphs on the card); on the CPU
    the loops run through ``LOOPS``."""
    seen = []
    route = graphed.graphed_route

    def spy(device, accel, intersect_fn, graphed_):
        seen.append((type(accel).__name__, graphed_))
        return route(device, accel, intersect_fn, graphed_)

    monkeypatch.setattr(graphed, "graphed_route", spy)
    size = ["--preset", "three-spheres", "--nx", "8", "--ny", "4", "--spp",
            "1", "--device", "cpu", "--bvh"]
    if cmd == "render":
        size += ["--out", str(tmp_path / "bvh.png")]
    passes = graphed.LOOPS.passes
    assert cli.main([*CLI_RUNS[cmd], *size]) == 0
    assert seen and all(s == ("FlatBVH", None) for s in seen), seen
    assert graphed.LOOPS.passes > passes
    if cmd == "render":
        assert "passes" in capsys.readouterr().out
