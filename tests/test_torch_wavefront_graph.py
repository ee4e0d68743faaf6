"""The wavefront integrator's loops as fixed-shape bodies a CUDA graph can
capture, on the CPU (``render/graphed.py``).

- The fixed-shape pool (``pool_state``/``pool_pass``, blocks of passes
  through ``LOOPS``' buffers) against the JAX package's
  ``render_rays_regenerative`` over a ray range that starts past 0, on
  three presets and pools of 256, 1000 and 4096 slots: per-ray radiance
  within the image bound of ``tests/test_torch_regenerative.py:67``
  (``(|a - b| > 1e-3).mean() < 0.01``, median below 1e-5); segments per
  ray equal to JAX's ``trace_rays`` on the same ids, but for the few rays
  whose paths part on a knife edge (a glass exit at the critical angle:
  2-3 of 2048 on random-spheres, none on the other two presets; each also
  parts in radiance), at most 0.2% of the rays, and segment totals within
  0.1% (``chip_smoke.py::compare``'s bound).
- The chunked batch (``batch_state``/``trip``) against JAX's
  ``render_ray_batch``, at the same bounds.
- One pass or trip per read of the alive flag against seven: bit-equal
  (the passes past the end change nothing).
- A ragged last chunk, padded with the last id, against the unpadded
  batches.
- ``LOOPS``' buffers and state reused across keys, scenes, cameras and ray
  ranges, each call equal to a fresh eager run bit for bit.
- After a warm call, a pass and a trip make no tensor from host data and
  read nothing back (counted as ``tests/test_torch_replay_graph.py``
  counts it), on the dense sweep and K4's and K5's plain versions.
- ``graphed_route``: the CPU runs the bodies eagerly; on a CUDA device the
  dense sweep, K4, K5 and K6 are graphed by default and anything else must
  be asked for.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.render import integrator as jint
from first_raytracer_tpu.render.api import render_ray_batch as jax_batch
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.render.regenerative import (
    render_rays_regenerative as jax_pool)
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.accel.build import build_bvh
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
from first_raytracer_tpu_torch.render import graphed
from first_raytracer_tpu_torch.render import regenerative as treg
from first_raytracer_tpu_torch.render.api import (batch_state,
                                                  render_ray_batch,
                                                  render_rays)
from first_raytracer_tpu_torch.render.graphed import (LoopCache,
                                                      graphed_route)
from first_raytracer_tpu_torch.render.integrator import (
    RenderConfig, default_intersect, trip)

PRESETS = [
    ("three-spheres", dict(nx=32, ny=16, spp=4)),
    ("random-spheres", dict(nx=32, ny=16, spp=4)),
    ("triangle-mesh", dict(nx=32, ny=16, spp=4)),
]
DEPTH = 12
START, TAIL = 37, 11  # the pool's range: [START, num_rays - TAIL)


def _case(name, kw):
    js, jc, cfg = jb.build_preset(name, **kw)
    cfg = dataclasses.replace(cfg, max_depth=DEPTH)
    return (js, jc, cfg, scene_from_numpy(js.as_numpy()),
            camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


def _assert_segments_match_jax(js, jc, cfg, key, ids, segs, rad):
    """Per-ray segments against JAX's ``trace_rays`` on ``ids``: equal but
    on at most 0.2% of the rays, each of which also parts from JAX's
    radiance (``rad``, per ray) by more than 1e-4; totals within 0.1%."""
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    jrad, jsegs = jint.trace_rays(js, o, d, ids, key, cfg,
                                  return_stats=True)
    segs, jsegs = segs.numpy(), np.asarray(jsegs)
    differ = segs != jsegs
    assert differ.sum() <= 2e-3 * len(segs), np.nonzero(differ)
    parted = np.abs(rad.numpy() - np.asarray(jrad)).max(axis=1) > 1e-4
    assert parted[differ].all()
    assert abs(int(segs.sum()) - int(jsegs.sum())) <= 1e-3 * jsegs.sum()


def _assert_within_image_bound(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.shape == np.asarray(want).shape
    assert np.isfinite(got).all()
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("pool", [256, 1000, 4096])
@pytest.mark.parametrize("name,kw", PRESETS, ids=[p[0] for p in PRESETS])
def test_pool_matches_jax(name, kw, pool):
    js, jc, cfg, ts, tc, tcfg = _case(name, kw)
    n = cfg.num_rays - START - TAIL
    want = jax_pool(js, jc, cfg, jrng.base_key(0), jnp.int32(START), n,
                    pool_size=pool)
    got, segs = treg.render_rays_regenerative(
        ts, tc, tcfg, trng.base_key(0), START, n, pool_size=pool,
        return_stats=True)
    assert got.shape == (n, 3) and segs.dtype == torch.int32
    _assert_within_image_bound(got.numpy(), want)
    _assert_segments_match_jax(
        js, jc, cfg, jrng.base_key(0),
        jnp.arange(START, START + n, dtype=jnp.int32), segs, got)


@pytest.mark.parametrize("name,kw", PRESETS, ids=[p[0] for p in PRESETS])
def test_trip_body_matches_jax(name, kw):
    js, jc, cfg, ts, tc, tcfg = _case(name, kw)
    ids = np.arange(5, cfg.num_rays, dtype=np.int32)
    want = jax_batch(js, jc, cfg, jrng.base_key(2), jnp.asarray(ids))
    got, segs = render_ray_batch(ts, tc, tcfg, trng.base_key(2),
                                 torch.from_numpy(ids).long(),
                                 return_stats=True)
    _assert_within_image_bound(got.numpy(), want)
    _assert_segments_match_jax(js, jc, cfg, jrng.base_key(2),
                               jnp.asarray(ids), segs, got)


def _small(name="random-spheres"):
    *_, ts, tc, tcfg = _case(name, dict(nx=24, ny=12, spp=2))
    return ts, tc, tcfg


def _fresh_loops(monkeypatch):
    """A new ``LoopCache`` in place of ``render.graphed.LOOPS``."""
    cache = LoopCache()
    monkeypatch.setattr(graphed, "LOOPS", cache)
    return cache


@pytest.mark.parametrize("loop", ["pool", "batch"])
def test_passes_per_read_change_nothing(monkeypatch, loop):
    """One pass (or trip) per read of the flag, and seven: the same
    radiance and segments bit for bit, the same passes with a live lane;
    the blocks of seven run more passes in all (the inert ones)."""
    ts, tc, tcfg = _small()
    key = trng.base_key(4)
    outs, counts = [], []
    for k in (1, 7):
        cache = _fresh_loops(monkeypatch)
        monkeypatch.setattr(graphed, "PASSES_PER_READ", k)
        if loop == "pool":
            outs.append(treg.render_rays_regenerative(
                ts, tc, tcfg, key, 3, tcfg.num_rays - 3, pool_size=128,
                return_stats=True))
        else:
            outs.append(render_ray_batch(
                ts, tc, tcfg, key, torch.arange(tcfg.num_rays),
                return_stats=True))
        counts.append((cache.passes, cache.live_passes, cache.syncs))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    (p1, live1, s1), (p7, live7, s7) = counts
    assert live1 == live7 == p1 == s1
    assert p7 >= live7 and p7 == 7 * s7


def test_ragged_last_chunk_is_padded(monkeypatch):
    """``render_rays`` pads its last chunk with the last id to the chunk's
    shape (one signature a frame) and slices the padding off: equal to the
    unpadded batches bit for bit."""
    ts, tc, tcfg = _small()
    key = trng.base_key(1)
    ids = torch.arange(7, tcfg.num_rays)
    cache = _fresh_loops(monkeypatch)
    got = render_rays(ts, tc, tcfg, key, ids, chunk=100)
    want = torch.cat([render_ray_batch(ts, tc, tcfg, key, ids[lo:lo + 100],
                                       graphed=False)
                      for lo in range(0, ids.shape[0], 100)])
    assert got.shape == (ids.shape[0], 3)
    assert torch.equal(got, want)
    shapes = {dict(sig[5][1])["ray_ids"][1] for sig in cache.entries}
    assert shapes == {(100,)}


def _variants(ts, tc):
    """Other values of one signature: keys, scene leaves, cameras."""
    other = dataclasses.replace(
        ts, albedo=ts.albedo.flip(0), sphere_center=ts.sphere_center * 1.01,
        fuzz=ts.fuzz * 0.5)
    cam = dataclasses.replace(tc, origin=tc.origin + 0.05)
    return [(ts, tc, trng.base_key(0)), (other, tc, trng.base_key(9)),
            (ts, cam, trng.base_key(0)), (other, cam, trng.base_key(5))]


@pytest.mark.parametrize("loop", ["pool", "batch"])
def test_buffers_hold_no_stale_state(monkeypatch, loop):
    """One cache entry run over other keys, scenes, cameras and ray ranges
    in turn: each call equals a fresh eager run (``graphed=False``) bit for
    bit."""
    ts, tc, tcfg = _small()
    cache = _fresh_loops(monkeypatch)
    for i, (s, c, key) in enumerate(_variants(ts, tc)):
        if loop == "pool":
            start = 5 * i
            n = tcfg.num_rays - 20
            run = lambda **kw: treg.render_rays_regenerative(  # noqa: E731
                s, c, tcfg, key, start, n, pool_size=96,
                return_stats=True, **kw)
        else:
            ids = torch.arange(tcfg.num_rays).roll(37 * i)[:400]
            run = lambda **kw: render_ray_batch(  # noqa: E731
                s, c, tcfg, key, ids, return_stats=True, **kw)
        got, want = run(), run(graphed=False)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(cache.entries) == 1


class _HostTraffic:
    """Counts the calls that make a tensor from host data or read one back
    to the host, while it is installed (tests/test_torch_replay_graph.py)."""

    READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("tensor", "as_tensor", "from_numpy"):
            self._wrap(monkeypatch, torch, name, host_data_only=True)
        for name in self.READS:
            self._wrap(monkeypatch, torch.Tensor, name)

    def _wrap(self, monkeypatch, owner, name, host_data_only=False):
        fn = getattr(owner, name)
        calls = self.calls

        def counted(*args, **kwargs):
            if not (host_data_only and args
                    and isinstance(args[0], torch.Tensor)):
                calls.append(name)
            return fn(*args, **kwargs)

        monkeypatch.setattr(owner, name, counted)


ACCELS = {"dense sweep": (lambda s: None, default_intersect),
          "K4 plain": (ip.pack_scene_pallas, ip.intersect_pallas_reference),
          "K5 plain": (ic.pack_scene_clustered,
                       ic.intersect_clustered_reference)}


@pytest.mark.parametrize("accel", list(ACCELS))
@pytest.mark.parametrize("loop", ["pool", "trip"])
def test_no_host_traffic_in_a_pass(monkeypatch, loop, accel):
    ts, tc, tcfg = _small("triangle-mesh" if accel == "K5 plain"
                          else "random-spheres")
    pack, fn = ACCELS[accel]
    inputs = dict(scene=ts, camera=tc, accel=pack(ts),
                  key=trng.base_key(3))
    if loop == "pool":
        inputs["start_id"] = torch.full((), 2, dtype=torch.int64)
        static = dict(cfg=tcfg, num_rays=tcfg.num_rays - 2, pool_size=64,
                      intersect_fn=fn)
        init, step = treg.pool_state, treg.pool_pass
    else:
        inputs["ray_ids"] = torch.arange(tcfg.num_rays)
        static = dict(cfg=tcfg, intersect_fn=fn)
        init, step = batch_state, trip
    state = init(**inputs, **static)
    step(state, **inputs, **static)  # the warm call
    want = {k: v.clone() for k, v in state.items()}
    step(state, **inputs, **static)
    after = state
    state = {k: v.clone() for k, v in want.items()}
    traffic = _HostTraffic(monkeypatch)
    step(state, **inputs, **static)
    monkeypatch.undo()
    assert traffic.calls == []
    assert all(torch.equal(state[k], after[k]) for k in state)


def test_graphed_route():
    """On the CPU the bodies run eagerly (through the cache's buffers
    unless ``graphed=False``); on a CUDA device the dense sweep, K4, K5 and
    the flat-BVH walk (K6) take the graphs by default, and a Python
    ``intersect_fn`` raises unless the caller says which."""
    ts, _, _ = _small()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    bvh = build_bvh(ts, max_leaf=4)
    assert graphed_route(cpu, bvh, default_intersect, None)
    assert not graphed_route(cpu, None, default_intersect, False)
    for accel, fn in ((None, default_intersect), (None, None),
                      (ip.pack_scene_pallas(ts), ip.intersect_pallas),
                      (ic.pack_scene_clustered(ts), ic.intersect_clustered),
                      (ic.pack_scene_clustered(ts), default_intersect),
                      (bvh, default_intersect), (bvh, None)):
        assert graphed_route(cuda, accel, fn, None)
    for accel, fn in ((bvh, lambda *a: default_intersect(*a)),
                      (None, lambda *a: default_intersect(*a))):
        with pytest.raises(ValueError, match="graphed=False"):
            graphed_route(cuda, accel, fn, None)
        assert not graphed_route(cuda, accel, fn, False)
        assert graphed_route(cuda, accel, fn, True)


def test_the_cache_counts_passes_and_reads(monkeypatch):
    """The cache counts the passes, the live ones and the flag reads of a
    wavefront call on the CPU (``PASSES_PER_READ`` passes a read); it
    captures and replays nothing there."""
    ts, tc, tcfg = _small("three-spheres")
    cache = _fresh_loops(monkeypatch)
    render_ray_batch(ts, tc, tcfg, trng.base_key(0),
                     torch.arange(tcfg.num_rays))
    assert 1 <= cache.live_passes <= cache.passes
    assert cache.syncs * graphed.PASSES_PER_READ == cache.passes
    assert cache.captures == cache.replays == cache.warmups == 0
