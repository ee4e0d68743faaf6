"""K11, the dense closest hit, with its liveness mask, on the CPU.

- Its source (``kernels/csrc/dense_hit.cu``), compiled by g++ through the
  host emulation (``kernels/host_emu``) and driven by the wrapper's own
  launch code on CPU tensors, against its plain version
  ``dense_hit_plain`` (``intersect_brute``, then the miss where the mask
  is False), ``torch.equal`` on prim, t and hit of every ray, dead ones
  included: on the final scene's camera rays and one bounce's rays, the
  fields (5000 spheres past a tile of 512, 20000 spheres, 20000 triangles
  past a tile of 256), spheres only, triangles only, and exact ties (every
  sphere twice; rays down the shared edge of two triangles, each twice),
  each at live shares 1, 0.5, 0.03, 0.001 and 0 (masks from a numpy
  seed); on windows of 256 rays with set live counts, so that every split
  of a ray's sweep over lanes (1 to 32, and two rays a thread) runs, ties
  across lanes included; at ray counts that are not a multiple of the
  window, and 0 and 1; and on a recorder's state after a bounce, with its
  own mask.
- The loop bodies that hand K11 their mask (the lockstep recorder, the
  pool recorder, the occupancy scan, the chunked forward frame and the
  regenerative pool, all without an accel), through the host build of K11
  and on the plain versions, against the same loops with the mask left
  out (every ray swept): tapes, lengths, radiance and segments
  ``torch.equal``; a caller's own ``intersect_fn`` keeps its five
  arguments, and the bench's ``CountedIntersect`` counts the pairs swept.
  The lockstep recorder's tape through the host build against the JAX
  package's ``record_paths`` at the reference's agreement (0.999, or 0.99
  on the coplanar triangle mesh; tests/test_record_mega.py).
- The wrapper refuses a mask it cannot take.

The plain versions' bare ``torch.sqrt`` runs as the card and the emulation
round it (``test_torch_wavefront_pass._card_rounding``).  The JAX package
is imported inside the test that compares with it.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import contextlib
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import record_pass as rp
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.kernels import dense_hit as dh
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.render import integrator
from first_raytracer_tpu_torch.render.api import render_ray_batch
from first_raytracer_tpu_torch.render.camera import camera_rays_plain
from first_raytracer_tpu_torch.render.regenerative import (
    render_rays_regenerative)
from first_raytracer_tpu_torch.scene.builders import build_preset
from first_raytracer_tpu_torch.utils.metrics import _path_lengths
from test_torch_wavefront_pass import _card_rounding

SHARES = (1.0, 0.5, 0.03, 0.001, 0.0)
SETS = ("final-camera", "final-bounce", "field5000", "field20000",
        "trifield20000", "spheres-only", "triangles-only", "spheres-twice",
        "shared-edge")
# Live rays in consecutive windows of 256: two rays a thread (above 128),
# then one ray over 1, 2, 4, 8, 16 and 32 lanes, and none.
WINDOW = 256
WINDOW_LIVE = (256, 200, 129, 128, 100, 65, 64, 40, 33, 32, 17, 16, 9, 8, 5,
               4, 2, 1, 0)


@pytest.fixture(scope="module")
def host_lib():
    """``dense_hit.cu`` built by g++ for the host, bound as the card's
    library and reached through ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = mk.bind_dense_hit(build_host_library(units=("dense_hit.cu",)))

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


def _without(scene, kind):
    """``scene`` with its spheres or its triangles removed."""
    if kind == "spheres":
        return dataclasses.replace(
            scene, sphere_center=scene.sphere_center[:0],
            sphere_radius=scene.sphere_radius[:0],
            sphere_mat=scene.sphere_mat[:0])
    return dataclasses.replace(
        scene, tri_v0=scene.tri_v0[:0], tri_v1=scene.tri_v1[:0],
        tri_v2=scene.tri_v2[:0], tri_mat=scene.tri_mat[:0])


def _camera(scene, cam, cfg, seed=4):
    key, ids = rng.base_key(seed), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    return scene, o, d


def _bounce_state(scene, cam, cfg):
    """A lockstep recorder's state after its first bounce: the rays that
    go on moved, the others dead."""
    key, ids = rng.base_key(4), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    state = trp.record_state(o, d, cfg=cfg)
    with _card_rounding():
        prim, _, hit = integrator.intersect_brute(scene, o, d, cfg.t_min)
        rp.record_step_plain(state, prim, hit, scene=scene, key=key,
                             ray_ids=ids, cfg=cfg)
    return state


def _edge():
    """Two triangles sharing the diagonal of a floor quad, each twice (ids
    0-3), and 97 rays straight down onto the diagonal."""
    scene, _, _ = build_preset("triangle-mesh", nx=8, ny=4, spp=1)
    a, b = (-1.0, 0.0, -1.0), (1.0, 0.0, 1.0)
    edge = dataclasses.replace(
        _without(scene, "spheres"), tri_v0=torch.tensor([a] * 4),
        tri_v1=torch.tensor([(1.0, 0.0, -1.0), b] * 2),
        tri_v2=torch.tensor([b, (-1.0, 0.0, 1.0)] * 2),
        tri_mat=torch.zeros((4,), dtype=torch.int32))
    s = torch.linspace(-0.9, 0.9, 97)
    o = torch.stack([s, torch.ones_like(s), s], dim=1)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(97, 3).contiguous()
    return edge, o, d


def _set(name):
    """(scene, origin, direction) of a ray set, small."""
    if name in ("final-camera", "final-bounce", "spheres-twice"):
        scene, cam, cfg = build_preset("random-spheres", nx=32, ny=16,
                                       spp=2, checker_ground=True)
        if name == "final-bounce":
            state = _bounce_state(scene, cam, cfg)
            alive = state["alive"]
            return (scene, state["o"][alive].contiguous(),
                    state["dr"][alive].contiguous())
        if name == "spheres-twice":
            scene = dataclasses.replace(
                scene, sphere_center=scene.sphere_center.repeat(2, 1),
                sphere_radius=scene.sphere_radius.repeat(2),
                sphere_mat=scene.sphere_mat.repeat(2))
        return _camera(scene, cam, cfg)
    if name == "field5000":
        return _camera(*build_preset("sphere-field", n=5000, nx=24, ny=12,
                                     spp=2))
    if name == "field20000":
        return _camera(*build_preset("sphere-field", n=20000, nx=16, ny=8,
                                     spp=2))
    if name == "trifield20000":
        return _camera(*build_preset("triangle-field", n=20000, nx=16,
                                     ny=8, spp=2))
    if name in ("spheres-only", "triangles-only"):
        scene, cam, cfg = build_preset("triangle-mesh", nx=24, ny=12, spp=2)
        kind = "triangles" if name == "spheres-only" else "spheres"
        return _camera(_without(scene, kind), cam, cfg)
    return _edge()


def _mask(n, share, seed):
    """A (n,) bool mask, each ray live with probability ``share``."""
    return torch.from_numpy(np.random.default_rng(seed).random(n) < share)


def _k11_equal(what, scene, o, d, alive, t_min=1e-3):
    """K11 (the host build) against ``dense_hit_plain`` on the rays (o, d)
    and the mask, prim, t and hit of every ray ``torch.equal``; returns
    the plain (prim, t, hit).  The launch counts once, and once more
    among the masked launches where it was given a mask."""
    before = (dh.dense_hit.launches, dh.dense_hit.masked_launches)
    got = dh._launch_cuda(scene, o, d, t_min, alive)
    with _card_rounding():
        want = dh.dense_hit_plain(scene, o, d, t_min, alive)
    n = 1 if o.shape[0] else 0
    assert (dh.dense_hit.launches, dh.dense_hit.masked_launches) == (
        before[0] + n, before[1] + (n if alive is not None else 0))
    for name, a, b in zip(("prim", "t", "hit"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, name)
    return want


@pytest.mark.parametrize("share", SHARES, ids=[f"live{s}" for s in SHARES])
@pytest.mark.parametrize("name", SETS)
def test_k11_masked_equals_plain(host_lib, name, share):
    """K11 with a mask of the given live share: every ray bit-equal to the
    masked ``intersect_brute``; a dead ray has the miss."""
    scene, o, d = _set(name)
    alive = _mask(o.shape[0], share, seed=len(name) + int(1000 * share))
    prim, t, hit = _k11_equal(f"{name} at {share}", scene, o, d, alive)
    dead = ~alive
    assert bool((prim[dead] == 0).all() and (t[dead] == 1e30).all())
    assert not bool(hit[dead].any())
    if share == 1.0:
        assert bool(hit.any())


@pytest.mark.parametrize("name", ("final-camera", "spheres-twice",
                                  "mixed-field"))
def test_k11_every_split(host_lib, name):
    """Windows of 256 rays with 256, 200, ..., 1 and 0 live (their places
    drawn from a seed): two rays a thread, then a ray's sweep over 1 to 32
    lanes meeting in the (t, id) minimum; bit-equal to the plain version
    on every ray, exact ties across lanes included."""
    if name == "mixed-field":
        scene, cam, cfg = build_preset("triangle-field", n=600, nx=76,
                                       ny=32, spp=2)
    else:
        scene, cam, cfg = build_preset("random-spheres", nx=76, ny=32,
                                       spp=2, checker_ground=True)
    if name == "spheres-twice":
        scene = dataclasses.replace(
            scene, sphere_center=scene.sphere_center.repeat(2, 1),
            sphere_radius=scene.sphere_radius.repeat(2),
            sphere_mat=scene.sphere_mat.repeat(2))
    _, o, d = _camera(scene, cam, cfg)
    n = WINDOW * len(WINDOW_LIVE)
    assert o.shape[0] >= n
    o, d = o[:n].contiguous(), d[:n].contiguous()
    gen = np.random.default_rng(7)
    alive = np.zeros(n, dtype=bool)
    for w, live in enumerate(WINDOW_LIVE):
        alive[w * WINDOW + gen.permutation(WINDOW)[:live]] = True
    prim, _, hit = _k11_equal(name, scene, o, d, torch.from_numpy(alive))
    assert bool(hit.any())
    if name == "spheres-twice":
        assert bool((prim < scene.num_spheres // 2).all())


@pytest.mark.parametrize("n", (0, 1, 255, 257, 300, 1000))
def test_k11_ray_counts(host_lib, n):
    """Ray counts that are not a multiple of the window, and 0 and 1: with
    a mask of half the rays and without a mask."""
    scene, o, d = _set("final-camera")
    o, d = o[:n].contiguous(), d[:n].contiguous()
    _k11_equal(f"{n} rays, half live", scene, o, d, _mask(n, 0.5, seed=n))
    _k11_equal(f"{n} rays, no mask", scene, o, d, None)


def test_k11_on_a_recorder_state(host_lib):
    """A lockstep recorder's state after its first bounce, its own mask
    (the rays that went on), as the loop body hands it over."""
    scene, cam, cfg = build_preset("random-spheres", nx=32, ny=16, spp=2,
                                   checker_ground=True)
    state = _bounce_state(scene, cam, cfg)
    assert 0 < int(state["alive"].sum()) < cfg.num_rays
    _k11_equal("a bounce's state", scene, state["o"], state["dr"],
               state["alive"])


def test_k11_refuses_a_bad_mask(host_lib):
    """A mask of another type, length or device is refused before any
    launch; the CPU wrapper runs the plain version with or without one."""
    scene, o, d = _set("final-camera")
    n = o.shape[0]
    before = dh.dense_hit.launches
    for bad in (torch.ones((n,), dtype=torch.int32),
                torch.ones((n - 1,), dtype=torch.bool),
                torch.ones((n,), dtype=torch.bool, device="meta")):
        with pytest.raises(ValueError):
            dh._launch_cuda(scene, o, d, 1e-3, bad)
    assert dh.dense_hit.launches == before
    alive = _mask(n, 0.5, seed=1)
    for a, b in zip(dh.dense_hit(scene, o, d, 1e-3, alive),
                    dh.dense_hit_plain(scene, o, d, 1e-3, alive)):
        assert torch.equal(a, b)
    assert dh.dense_hit.launches == before


@contextlib.contextmanager
def _route(monkeypatch, route):
    """The closest hit without an accel on one route: "k11" (the host
    build of K11, which sweeps the live rays only), "plain"
    (``dense_hit_plain`` with the mask) or "unmasked" (every ray swept,
    the mask left out).  Yields the masks K11 was handed."""
    masks = []

    def k11(scene, o, d, t_min, alive=None):
        masks.append(None if alive is None else int(alive.sum()))
        return dh._launch_cuda(scene, o, d, t_min, alive)

    def unmasked(scene, o, d, t_min, alive=None):
        return integrator.intersect_brute(scene, o, d, t_min)

    with monkeypatch.context() as m, _card_rounding():
        if route != "plain":
            m.setattr(dh, "dense_hit_plain",
                      k11 if route == "k11" else unmasked)
        yield masks


PRESETS = [("random-spheres", dict(nx=16, ny=8, spp=2, max_depth=10)),
           ("triangle-mesh", dict(nx=16, ny=8, spp=2, max_depth=10)),
           ("camera-effects", dict(nx=16, ny=8, spp=2, max_depth=10))]


@pytest.mark.parametrize("name,kw", PRESETS, ids=[p[0] for p in PRESETS])
def test_loops_through_masked_k11(host_lib, monkeypatch, name, kw):
    """The lockstep and pool recorders' tapes, the occupancy scan's
    lengths, the chunked forward frame's and the regenerative pool's
    radiance and segments, without an accel: through the host build of K11
    with the loops' masks, on the plain versions with them, and with every
    ray swept, ``torch.equal``; K11 got a mask with dead rays."""
    max_depth = kw.pop("max_depth")
    scene, cam, cfg = build_preset(name, **kw)
    cfg = dataclasses.replace(cfg, max_depth=max_depth)
    key, ids = rng.base_key(3), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)

    def loops():
        return dict(
            lockstep=trp.record_paths(scene, o, d, ids, key, cfg),
            pool=trp.record_paths_pool(scene, cam, cfg, key, ids,
                                       pool_size=64),
            lengths=_path_lengths(scene, cam, cfg, key, ids, None),
            chunk=render_ray_batch(scene, cam, cfg, key, ids,
                                   return_stats=True),
            regenerative=render_rays_regenerative(
                scene, cam, cfg, key, 0, cfg.num_rays, pool_size=64,
                return_stats=True))

    out = {}
    for route in ("k11", "plain", "unmasked"):
        before = dh.dense_hit.launches
        with _route(monkeypatch, route) as masks:
            out[route] = loops()
        if route == "k11":
            assert dh.dense_hit.launches > before
            assert None not in masks and min(masks) < cfg.num_rays
    flat = {r: [t for v in o_.values() for t in (
        v if isinstance(v, tuple) else (v,))] for r, o_ in out.items()}
    for route in ("plain", "unmasked"):
        for a, b in zip(flat["k11"], flat[route]):
            assert torch.equal(a, b), route
    assert torch.equal(out["k11"]["pool"], out["k11"]["lockstep"])


def test_custom_intersect_fn_keeps_five_arguments():
    """A caller's own ``intersect_fn`` is called with five arguments in
    every loop body; ``default_intersect`` gets the mask."""
    scene, cam, cfg = build_preset("three-spheres", nx=8, ny=4, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=4)
    key, ids = rng.base_key(3), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    calls = []

    def five(scene, accel, origin, direction, t_min):
        calls.append(5)
        return integrator.default_intersect(scene, accel, origin,
                                            direction, t_min)

    trp.record_paths(scene, o, d, ids, key, cfg, intersect_fn=five)
    trp.record_paths_pool(scene, cam, cfg, key, ids, intersect_fn=five,
                          pool_size=16)
    render_ray_batch(scene, cam, cfg, key, ids, intersect_fn=five)
    render_rays_regenerative(scene, cam, cfg, key, 0, cfg.num_rays,
                             intersect_fn=five, pool_size=16)
    assert len(calls) >= 4
    got = []
    assert integrator.closest_hit(
        lambda *a, **k: got.append((len(a), k)) or (None, None, None),
        scene, None, o, d, 1e-3, torch.ones(o.shape[0], dtype=torch.bool)
    ) == (None, None, None)
    assert got == [(5, {})]


def test_bench_counts_the_pairs_swept():
    """The bench's ``CountedIntersect`` takes the loops' mask as
    ``default_intersect`` does and counts the FP32 operations of the live
    rays' pairs only, which K11 sweeps; without a mask, every ray's."""
    from first_raytracer_tpu_torch.bench import CountedIntersect
    from first_raytracer_tpu_torch.utils import roofline

    scene, o, d = _set("final-camera")
    alive = _mask(o.shape[0], 0.1, seed=2)
    counted = CountedIntersect("brute", scene, None)
    got = integrator.closest_hit(counted, scene, None, o, d, 1e-3, alive)
    for a, b in zip(got, dh.dense_hit_plain(scene, o, d, 1e-3, alive)):
        assert torch.equal(a, b)
    pair = scene.num_spheres * roofline.OC_SPHERE_OPS
    assert counted.ops() == int(alive.sum()) * pair
    counted(scene, None, o, d, 1e-3)
    assert counted.ops() == (int(alive.sum()) + o.shape[0]) * pair


@pytest.mark.parametrize("name,floor", [("random-spheres", 0.999),
                                        ("three-spheres", 0.999),
                                        ("triangle-mesh", 0.99)])
def test_masked_recorder_matches_jax(host_lib, monkeypatch, name, floor):
    """The lockstep recorder through the host build of K11 with its masks
    against the JAX package's ``record_paths`` on the same camera rays:
    per-entry agreement above the reference's floor (0.999, or 0.99 on the
    coplanar triangle mesh; tests/test_record_mega.py)."""
    import jax.numpy as jnp

    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.diff.replay import record_paths as jax_record
    from first_raytracer_tpu.render.camera import generate_rays as jax_rays
    from first_raytracer_tpu.scene import builders as jb
    from first_raytracer_tpu_torch.convert import scene_from_numpy
    from first_raytracer_tpu_torch.render.integrator import RenderConfig

    js, jc, jcfg = jb.build_preset(name, nx=24, ny=12, spp=2)
    key = jrng.base_key(1)
    jids = jnp.arange(jcfg.num_rays, dtype=jnp.int32)
    jo, jd = jax_rays(jc, jcfg.nx, jcfg.ny, jcfg.spp, jids,
                      jrng.camera_uniforms(key, jids))
    want = np.asarray(jax_record(js, jo, jd, jids, key, jcfg))
    scene = scene_from_numpy(js.as_numpy())
    cfg = RenderConfig(nx=jcfg.nx, ny=jcfg.ny, spp=jcfg.spp,
                       max_depth=jcfg.max_depth, t_min=jcfg.t_min)
    o, d = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jd))
    ids = torch.arange(cfg.num_rays)
    with _route(monkeypatch, "k11") as masks:
        got = trp.record_paths(scene, o, d, ids, rng.base_key(1), cfg)
    assert masks and min(masks) < cfg.num_rays
    agree = float((got.numpy() == want).mean())
    assert agree > floor, agree
