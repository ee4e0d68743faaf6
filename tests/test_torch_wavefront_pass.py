"""K9 (the wavefront pass's shading) and K10 (the pool's regeneration) on
the CPU, and the loops that run through them.

- Their source (``kernels/csrc/wavefront_pass.cu``), compiled by g++
  through the host emulation (``kernels/host_emu``) and driven by the
  wrappers' own launch code on CPU tensors, pass by pass against
  ``shade_plain`` and ``regenerate_plain`` on clones of the same state,
  ``torch.equal`` for every tensor of the state, its output rows, segment
  counts and ``cont``, and the scratch rows of the next state where
  ``cont`` holds (K9 writes no other): the pool (a depth per slot) over
  every pass of
  a small frame whose stream ends inside a pass (its tail wraps past
  ``num_rays``, so dead slots), and the chunked batch (a 0-d depth) over
  every trip; at a depth cap of 3 (paths cut there) and of 50; on
  random-spheres (every material, its checker ground), a triangles-only
  mesh, camera-effects (a checker, a lens) and a field of triangles and
  spheres (``prim >= Ns`` a triangle).  K9 leaves the scratch rows of
  the slots that end, and dead slots' rows, as they were.  The plain
  versions' bare
  ``torch.sqrt`` and ``torch.sin`` run as the card and the emulation
  round them, correctly: torch's float32 ones on this CPU are vectorised
  approximations an ulp off on a fraction of inputs
  (``probes/torch_arith.py``).
- The pool and the chunked loops with ``shade`` and ``regenerate`` pointed
  at the host build, against the JAX package's ``render_rays_regenerative``
  and ``render_ray_batch`` at ``tests/test_torch_wavefront_graph.py``'s
  bounds (``(|a - b| > 1e-3).mean() < 0.01`` per ray, median below 1e-5;
  segment totals within 0.1%), and bit-equal to the same loops on the
  plain versions.
- The wrappers refuse what their kernels do not take (a float64 state, an
  int64 material column, a camera that carries a gradient, another
  device), launch nothing
  for no slots, raise when their library fails to build, and the graph
  caches count K9's and K10's launches per replay.
- Marked ``cuda`` (skipped here): on CUDA tensors ``pool_pass`` and
  ``trip`` launch K9 and K10 and equal their plain versions.

The JAX package is imported inside the tests that compare with it, so that
this file also runs on a GPU host without JAX (``--noconftest``).
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import contextlib
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import graphed as dgraphed
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.render import regenerative as treg
from first_raytracer_tpu_torch.render import wavefront_pass as wp
from first_raytracer_tpu_torch.render.api import (batch_state,
                                                  render_ray_batch)
from first_raytracer_tpu_torch.render.integrator import default_intersect
from first_raytracer_tpu_torch.render.regenerative import (pool_pass,
                                                           pool_state)
from first_raytracer_tpu_torch.scene.builders import build_preset

# The card's launch code, which ``host_lib`` replaces for this module's
# host tests.
_LAUNCH_ENTRY = mk.launch_entry
_SQRT, _SIN = torch.sqrt, torch.sin
SETS = ("random-spheres", "triangles-only", "camera-effects",
        "mixed-field")


def _scene(name, device="cpu"):
    """(scene, camera, cfg) of a set, small."""
    if name == "random-spheres":
        scene, cam, cfg = build_preset(name, nx=32, ny=16, spp=2,
                                       checker_ground=True, device=device)
    elif name == "triangles-only":
        scene, cam, cfg = build_preset("triangle-mesh", nx=32, ny=16, spp=2,
                                       device=device)
        scene = dataclasses.replace(
            scene, sphere_center=scene.sphere_center[:0],
            sphere_radius=scene.sphere_radius[:0],
            sphere_mat=scene.sphere_mat[:0])
    elif name == "camera-effects":
        scene, cam, cfg = build_preset(name, nx=32, ny=16, spp=2,
                                       device=device)
    else:
        scene, cam, cfg = build_preset("triangle-field", n=300, nx=32, ny=16,
                                       spp=2, device=device)
    return scene, cam, cfg


@pytest.fixture(scope="module")
def host_lib():
    """``wavefront_pass.cu`` built by g++ for the host, bound as the
    card's library and reached through ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = mk.bind_wavefront_pass(build_host_library(
        units=("wavefront_pass.cu",)))

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


def _ieee_sqrt(x):
    """``torch.sqrt`` correctly rounded, as the card takes it."""
    return torch.from_numpy(np.sqrt(x.detach().numpy()))


def _rounded_sin(x):
    """``torch.sin`` of a float32 tensor in float64 rounded once, as the
    emulation's sinf (and ``core.vecmath.sin`` on the CPU)."""
    if x.dtype == torch.float32:
        return _SIN(x.double()).float()
    return _SIN(x)


@contextlib.contextmanager
def _card_rounding():
    """The plain versions' bare sqrt and sin rounded as the kernels'."""
    torch.sqrt, torch.sin = _ieee_sqrt, _rounded_sin
    try:
        yield
    finally:
        torch.sqrt, torch.sin = _SQRT, _SIN


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def _block_counts(what, got, want):
    """K9's survivor counts a block (``got``) against the plain ``cont``'s
    (``want``), then handed to ``want``: the plain version writes none."""
    cont = want["cont"]
    pad = (-cont.shape[0]) % wp.BLOCK
    sums = torch.nn.functional.pad(cont.to(torch.int32), (0, pad)).view(
        -1, wp.BLOCK).sum(1, dtype=torch.int32)
    assert torch.equal(got["block_counts"], sums), what
    want["block_counts"] = got["block_counts"]


def _assert_equal(what, got, want):
    """Every tensor of ``want`` equal to ``got``'s; the scratch rows of the
    next state where ``want["cont"]`` holds, the only rows K9 writes."""
    def same(k):
        if k in wp.NEXT_ROWS:
            return torch.equal(got[k][want["cont"]], want[k][want["cont"]])
        return torch.equal(got[k], want[k])
    bad = [k for k in want if not same(k)]
    assert not bad, (what, bad)


@pytest.mark.parametrize("depth", [3, 50], ids=["cap3", "cap50"])
@pytest.mark.parametrize("name", SETS)
def test_pool_passes_equal_plain(host_lib, name, depth):
    """Every pass of a pool of three blocks whose stream ends inside a
    pass: K9 against ``shade_plain`` (and its survivor counts a block
    against the plain ``cont``'s) and K10 against ``regenerate_plain``, on
    clones of the same state, bit for bit."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    key = rng.base_key(5)
    start, n = torch.tensor(3), cfg.num_rays - 7
    # Three blocks of K9 and K10, the last a partial one.
    static = dict(cfg=cfg, num_rays=n, pool_size=2 * wp.BLOCK + 88)
    state = pool_state(scene, cam, key, start, **static)
    passes = shades = 0
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["o"],
                                         state["d"], cfg.t_min)
        got, want = _clone(state), _clone(state)
        before = wp.shade.launches, wp.regenerate.launches
        wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start, num_rays=n)
        with _card_rounding():
            wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                           start_id=start, num_rays=n)
        _block_counts(f"K9, pass {passes}", got, want)
        _assert_equal(f"K9, pass {passes}", got, want)
        shades += int(want["cont"].sum())
        wp._launch_regenerate(got, camera=cam, key=key, start_id=start,
                              **static)
        with _card_rounding():
            wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                                **static)
        assert (wp.shade.launches, wp.regenerate.launches) == (
            before[0] + 1, before[1] + 1)
        want["cursor_next"] = got["cursor_next"]  # K10's own buffer
        _assert_equal(f"K10, pass {passes}", got, want)
        state = want
        passes += 1
    assert int(state["cursor"]) == n and shades > 0
    assert int(state["segments"].sum()) >= n and passes > 2


@pytest.mark.parametrize("name", SETS)
def test_k9_writes_rows_of_slots_that_go_on_only(host_lib, name):
    """K9 in pool mode over a pool with a dead slot in every four: the
    rows of the next state of a slot that ends (dead, missing, absorbed or
    at the depth cap) keep what they held, the others are the plain
    version's; a dead slot adds no segment and no sky."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=1)
    key, start = rng.base_key(2), torch.tensor(0)
    n = cfg.num_rays
    state = pool_state(scene, cam, key, start, cfg=cfg, num_rays=n,
                       pool_size=wp.BLOCK + 40)
    state["alive"][::4] = False
    state["depth"][1::4] = 1  # at the cap: ends after this pass
    for k in wp.NEXT_ROWS:
        fill = -7.5 if state[k].is_floating_point() else -7
        state[k].fill_(fill)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    got, want = _clone(state), _clone(state)
    wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg,
                     start_id=start, num_rays=n)
    with _card_rounding():
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=n)
    _block_counts("K9", got, want)
    _assert_equal("K9", got, want)
    ends = ~want["cont"]
    assert bool(ends[::4].all()) and bool(ends[1::4].all())
    assert 0 < int(want["cont"].sum()) < ends.numel()
    for k in wp.NEXT_ROWS:
        assert torch.equal(got[k][ends], state[k][ends]), k
    assert int(got["segments"].sum()) == int(state["alive"].sum())


@pytest.mark.parametrize("depth", [3, 50], ids=["cap3", "cap50"])
@pytest.mark.parametrize("name", SETS)
def test_trips_equal_plain(host_lib, name, depth):
    """Every trip of a chunked batch (a 0-d depth): K9 against
    ``shade_plain`` on clones of the same carry, bit for bit."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    key = rng.base_key(-1)
    ids = torch.arange(2, cfg.num_rays - 1)
    state = batch_state(scene, cam, key, ids, cfg=cfg)
    trips = 0
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["origin"],
                                         state["direction"], cfg.t_min)
        got, want = _clone(state), _clone(state)
        wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg)
        with _card_rounding():
            wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg)
        _assert_equal(f"K9, trip {trips}", got, want)
        state = want
        state["depth"].add_(1)
        trips += 1
    assert trips <= depth + 1 and int(state["segments"].sum()) > ids.numel()


@contextlib.contextmanager
def _through_host_build(monkeypatch):
    """``pool_pass`` and ``trip`` with their seams on the host build: the
    CPU's plain versions replaced by the kernels' launch code."""
    with monkeypatch.context() as m:
        m.setattr(wp, "shade_plain", wp._launch_shade)
        m.setattr(wp, "regenerate_plain", wp._launch_regenerate)
        yield


JAX_PRESETS = [
    ("three-spheres", dict(nx=32, ny=16, spp=4)),
    ("random-spheres", dict(nx=32, ny=16, spp=4)),
    ("triangle-mesh", dict(nx=32, ny=16, spp=4)),
    ("camera-effects", dict(nx=24, ny=12, spp=4)),
]


def _jax_case(name, kw):
    from first_raytracer_tpu.scene import builders as jb
    from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                                   scene_from_numpy)
    from first_raytracer_tpu_torch.render.integrator import RenderConfig

    js, jc, cfg = jb.build_preset(name, **kw)
    cfg = dataclasses.replace(cfg, max_depth=12)
    return (js, jc, cfg, scene_from_numpy(js.as_numpy()),
            camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


def _assert_near_jax(got, segs, want, jsegs):
    """``tests/test_torch_wavefront_graph.py``'s bounds."""
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.isfinite(got.numpy()).all()
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert np.median(diff) < 1e-5
    jsegs = np.asarray(jsegs)
    assert abs(int(segs.sum()) - int(jsegs.sum())) <= 1e-3 * jsegs.sum()


@pytest.mark.parametrize("name,kw", JAX_PRESETS,
                         ids=[p[0] for p in JAX_PRESETS])
def test_loops_through_kernels_match_jax(host_lib, monkeypatch, name, kw):
    """The pool (256 slots, a range that starts past 0) and the chunked
    batch through K9 and K10 against the JAX package's pool and batch, and
    bit-equal to the same loops on the plain versions (the pool's init and
    the dense sweep, torch ops in both, rounding their square roots as the
    kernels do)."""
    import jax.numpy as jnp

    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.render import integrator as jint
    from first_raytracer_tpu.render.api import render_ray_batch as jax_batch
    from first_raytracer_tpu.render.camera import generate_rays as jax_rays
    from first_raytracer_tpu.render.regenerative import (
        render_rays_regenerative as jax_pool)

    js, jc, cfg, ts, tc, tcfg = _jax_case(name, kw)
    start, n = 37, cfg.num_rays - 48
    jids = jnp.arange(start, start + n, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, jids,
                    jrng.camera_uniforms(jrng.base_key(0), jids))
    _, jsegs = jint.trace_rays(js, o, d, jids, jrng.base_key(0), cfg,
                               return_stats=True)
    ids = torch.arange(start, start + n)

    def loops():
        pool = treg.render_rays_regenerative(
            ts, tc, tcfg, rng.base_key(0), start, n, pool_size=256,
            return_stats=True)
        batch = render_ray_batch(ts, tc, tcfg, rng.base_key(0), ids,
                                 return_stats=True)
        return pool, batch

    with _through_host_build(monkeypatch), _card_rounding():
        before = wp.shade.launches, wp.regenerate.launches
        (rad, segs), (brad, bsegs) = loops()
        k9, k10 = (wp.shade.launches - before[0],
                   wp.regenerate.launches - before[1])
    assert k10 > 0 and k9 > k10  # a pass each, and the batch's trips
    want = jax_pool(js, jc, cfg, jrng.base_key(0), jnp.int32(start), n,
                    pool_size=256)
    _assert_near_jax(rad, segs, want, jsegs)
    _assert_near_jax(brad, bsegs,
                     jax_batch(js, jc, cfg, jrng.base_key(0), jids), jsegs)
    with _card_rounding():
        (prad, psegs), (pbrad, pbsegs) = loops()
    assert torch.equal(rad, prad) and torch.equal(segs, psegs)
    assert torch.equal(brad, pbrad) and torch.equal(bsegs, pbsegs)


def test_wrappers_refuse_what_kernels_do_not_take(host_lib):
    """A float64 state, an int64 material column, a camera that carries a
    gradient and a misshapen scratch row are refused before the launch; no
    slots launch nothing; another device has no kernel."""
    scene, cam, cfg = _scene("random-spheres")
    key, start = rng.base_key(0), torch.tensor(0)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=64)
    state = pool_state(scene, cam, key, start, **static)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    kw = dict(scene=scene, key=key, cfg=cfg, start_id=start,
              num_rays=cfg.num_rays)
    bad = dict(state, o=state["o"].double())
    with pytest.raises(ValueError, match="'o'"):
        wp._launch_shade(bad, prim, hit, **kw)
    wide = dataclasses.replace(scene, tri_mat=scene.tri_mat.long())
    with pytest.raises(ValueError, match="scene.tri_mat"):
        wp._launch_shade(state, prim, hit, **dict(kw, scene=wide))
    with pytest.raises(ValueError, match="'next_ids'"):
        wp._launch_regenerate(dict(state, next_ids=state["next_ids"][:5]),
                              camera=cam, key=key, start_id=start, **static)
    lens = dataclasses.replace(cam, u=cam.u.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="requires grad"):
        wp._launch_regenerate(state, camera=lens, key=key, start_id=start,
                              **static)
    empty = {k: (v[:0] if v.dim() and k not in ("out", "segments") else v)
             for k, v in state.items()}
    before = wp.shade.launches, wp.regenerate.launches
    wp._launch_shade(empty, prim[:0], hit[:0], **kw)
    assert (wp.shade.launches, wp.regenerate.launches) == before
    meta = {k: v.to("meta") for k, v in state.items()}
    with pytest.raises(ValueError, match="device"):
        wp.shade(meta, prim.to("meta"), hit.to("meta"), **kw)
    with pytest.raises(ValueError, match="device"):
        wp.regenerate(meta, camera=cam, key=key, start_id=start, **static)


def test_failed_build_raises(monkeypatch):
    """A library that fails to build raises out of the wrappers' launch
    code: nothing falls back to the plain versions."""
    def no_library():
        raise RuntimeError("nvcc failed (1): no compiler")

    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    monkeypatch.setattr(mk, "load_mega_library", no_library)
    scene, cam, cfg = _scene("camera-effects")
    key, start = rng.base_key(0), torch.tensor(0)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=32)
    state = pool_state(scene, cam, key, start, **static)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    before = wp.shade.launches, wp.regenerate.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wp._launch_shade(state, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start, num_rays=cfg.num_rays)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wp._launch_regenerate(state, camera=cam, key=key, start_id=start,
                              **static)
    assert (wp.shade.launches, wp.regenerate.launches) == before


def test_cpu_passes_run_the_plain_versions(monkeypatch):
    """On the CPU ``pool_pass`` and ``trip`` take the plain versions and
    draw through the plain Threefry and camera rays: no wrapper of K7, K8,
    K9 or K10 is called."""
    from first_raytracer_tpu_torch.render import camera as rcam
    from first_raytracer_tpu_torch.render.integrator import trip

    def refused(*args, **kwargs):
        raise AssertionError("a CPU pass called a kernel's wrapper")

    scene, cam, cfg = _scene("camera-effects")
    key, start = rng.base_key(0), torch.tensor(0)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=64)
    state = pool_state(scene, cam, key, start, **static)
    batch = batch_state(scene, cam, key, torch.arange(64), cfg=cfg)
    for mod, name in ((wp, "_launch_shade"), (wp, "_launch_regenerate"),
                      (rng, "uniforms"), (rng, "bounce_uniforms"),
                      (rcam, "camera_rays"), (treg, "camera_rays")):
        monkeypatch.setattr(mod, name, refused)
    pool_pass(state, scene=scene, camera=cam, accel=None, key=key,
              start_id=start, intersect_fn=default_intersect, **static)
    trip(batch, scene=scene, accel=None, key=key, cfg=cfg,
         intersect_fn=default_intersect)
    assert int(state["segments"].sum()) == 64
    assert int(batch["segments"].sum()) == 64


def test_graph_caches_count_k9_and_k10():
    """K9's and K10's counters are among those the graph caches take off a
    capture and add back per replay."""
    counters = dgraphed.launch_counters()
    assert (wp.shade, "launches") in counters
    assert (wp.regenerate, "launches") in counters
    before = dgraphed.launches_now()
    wp.shade.launches += 2
    wp.regenerate.launches += 1
    made = dgraphed.take_launches(before)
    assert dgraphed.launches_now() == before
    assert sorted((fn.__name__, n) for fn, _, n in made) == [
        ("regenerate", 1), ("shade", 2)]


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K9 and K10 are CUDA kernels")
    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS)
def test_cuda_passes_launch_k9_and_k10(cuda_device, name):
    """On CUDA tensors a pool pass launches K9 and K10 once each and a
    trip K9 once, each pass bit-equal to the plain versions on the card."""
    scene, cam, cfg = _scene(name, device=cuda_device)
    key = rng.base_key(0).to(cuda_device)
    start = torch.tensor(0, device=cuda_device)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=128)
    state = pool_state(scene, cam, key, start, **static)
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["o"],
                                         state["d"], cfg.t_min)
        want = _clone(state)
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=cfg.num_rays)
        wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                            **static)
        before = wp.shade.launches, wp.regenerate.launches
        pool_pass(state, scene=scene, camera=cam, accel=None, key=key,
                  start_id=start, intersect_fn=default_intersect, **static)
        torch.cuda.synchronize()
        assert (wp.shade.launches, wp.regenerate.launches) == (
            before[0] + 1, before[1] + 1)
        want["cursor_next"] = state["cursor_next"]
        _block_counts("pool pass", state, want)
        _assert_equal("pool pass", state, want)
    ids = torch.arange(cfg.num_rays, device=cuda_device)
    state = batch_state(scene, cam, key, ids, cfg=cfg)
    from first_raytracer_tpu_torch.render.integrator import trip
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["origin"],
                                         state["direction"], cfg.t_min)
        want = _clone(state)
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg)
        want["depth"].add_(1)
        before = wp.shade.launches
        trip(state, scene=scene, accel=None, key=key, cfg=cfg,
             intersect_fn=default_intersect)
        torch.cuda.synchronize()
        assert wp.shade.launches == before + 1
        _assert_equal("trip", state, want)
