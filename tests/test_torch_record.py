"""The port's tape recorders against the JAX package's.

On the CPU, ``record_paths_mega`` runs the plain version of K2b (the
standalone recorder), ``render_pixels_mega(emit_tape=True)`` that of K2
(the megakernel with its tape) and ``record_paths_mega_clustered`` that of
K3t (the clustered recorder); they are held against the JAX recorders on
the same scenes, cameras and keys:

- the JAX megakernel recorder in interpret mode and the JAX wavefront
  ``record_paths``, at the presets, sizes and agreement floors of
  tests/test_record_mega.py (0.999, or 0.99 on the coplanar triangle mesh).
  A tape entry is not independent of the next: once a path takes another
  way, all its deeper entries differ.  On random-spheres 24x12 @ 2, ray 396
  leaves a small glass sphere at the critical angle, and one ulp decides
  total internal reflection (the port) or refraction (both JAX recorders);
  the reflected path is trapped in the sphere to the depth cap, so that one
  ray costs 49 of the 29,376 entries.  So the floor forgives one ray's
  column, and the number of diverging rays must stay within the spread of
  the two JAX recorders against each other (3 rays of 576 there) plus one;
- the port's wavefront ``record_paths`` and ``record_paths_pool`` against
  JAX's: equal tapes;
- the plain K3t against JAX's ``record_paths_mega_clustered`` (interpret
  mode) and JAX's wavefront recorder at tests/test_record_mega.py:230-235's
  floors (0.999 on sphere_field(600) and random-spheres, 0.99 on the
  triangle mesh), with the same allowance for diverging rays as above.

The CUDA kernels are held against these plain versions by the ``cuda``
tests (tests/test_torch_cuda.py) and by chip_smoke.py.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff.replay import (record_paths as jax_record,
                                             record_paths_pool as jax_pool)
from first_raytracer_tpu.kernels.megakernel_clustered import (
    pack_scene_mega_clustered as jax_pack_clustered)
from first_raytracer_tpu.kernels.record_mega import (
    pack_scene_mega as jax_pack, record_paths_mega as jax_record_mega,
    record_paths_mega_clustered as jax_record_clustered)
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.kernels import megakernel as tmk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as tmc
from first_raytracer_tpu_torch.kernels import record_mega as trm
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.render.integrator import RenderConfig

# tests/test_record_mega.py:30-43: preset, size, tape agreement floor.
PRESETS = [
    ("three-spheres", dict(nx=32, ny=16, spp=4), 0.999),
    ("triangle-mesh", dict(nx=32, ny=16, spp=2), 0.99),
    ("camera-effects", dict(nx=32, ny=16, spp=4), 0.999),
    ("random-spheres", dict(nx=24, ny=12, spp=2), 0.999),
]


def _port(js, jc, cfg):
    return (scene_from_numpy(js.as_numpy()), camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


def _jax_wavefront_tape(js, jc, cfg, key, ids):
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    return np.asarray(jax_record(js, o, d, ids, key, cfg))


def _port_wavefront_tape(ts, tc, tcfg, key, ids):
    o, d = generate_rays(tc, tcfg.nx, tcfg.ny, tcfg.spp, ids,
                         trng.camera_uniforms(key, ids))
    return trp.record_paths(ts, o, d, ids, key, tcfg).numpy()


@pytest.mark.parametrize("name,kw,floor", PRESETS,
                         ids=[p[0] for p in PRESETS])
def test_plain_k2_matches_jax_recorders(name, kw, floor):
    js, jc, cfg = jb.build_preset(name, **kw)
    ts, tc, tcfg = _port(js, jc, cfg)
    got = trm.record_paths_mega(tmk.pack_scene_mega(ts), tc, tcfg,
                                trng.base_key(0)).numpy()
    assert got.shape == (cfg.max_depth + 1, cfg.num_rays)
    assert got.dtype == np.int32
    key = jrng.base_key(0)
    mega = np.asarray(jax_record_mega(jax_pack(js), jc, cfg, key,
                                      interpret=True))
    wave = _jax_wavefront_tape(js, jc, cfg, key,
                               jnp.arange(cfg.num_rays, dtype=jnp.int32))
    jax_spread = int((mega != wave).any(axis=0).sum())
    for ref in (mega, wave):
        agree = (got == ref).mean()
        assert agree > floor - got.shape[0] / got.size, \
            f"tape agreement {agree:.4%}"
        assert int((got != ref).any(axis=0).sum()) <= jax_spread + 1


def test_plain_k2_ray0_slice():
    """A ray range recorded alone equals the same columns of the whole
    tape, and JAX's recorder on the same range (tests/test_record_mega.py
    :61-70)."""
    js, jc, cfg = jb.three_spheres(nx=32, ny=16, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmk.pack_scene_mega(ts)
    key = trng.base_key(3)
    full = trm.record_paths_mega(pack, tc, tcfg, key).numpy()
    ray0, n = 101, 255
    part = trm.record_paths_mega(pack, tc, tcfg, key, ray0=ray0,
                                 num_rays=n).numpy()
    np.testing.assert_array_equal(part, full[:, ray0:ray0 + n])
    want = np.asarray(jax_record_mega(jax_pack(js), jc, cfg,
                                      jrng.base_key(3), ray0=ray0,
                                      num_rays=n, interpret=True))
    np.testing.assert_array_equal(part, want)


def test_plain_k2_at_large_ray_ids():
    """Ray ids near the end of a full frame (1200x800 @ 10 spp, ids up to
    9.6 M) decode to their pixels exactly (tests/test_record_mega.py
    :115-132)."""
    js, jc, cfg = jb.random_scene()
    ts, tc, tcfg = _port(js, jc, cfg)
    ray0, n = 9_500_000, 512
    got = trm.record_paths_mega(tmk.pack_scene_mega(ts), tc, tcfg,
                                trng.base_key(0), ray0=ray0,
                                num_rays=n).numpy()
    ref = _jax_wavefront_tape(js, jc, cfg, jrng.base_key(0),
                              jnp.arange(ray0, ray0 + n, dtype=jnp.int32))
    assert (got == ref).mean() > 0.999


def test_plain_k2b_equals_plain_k2():
    """K2b's plain version (``record_paths_mega``) gives K2's tape over the
    same ids, and its per-ray trip counts sum per pixel to K1's segment
    counts."""
    js, jc, cfg = jb.random_scene(nx=24, ny=12, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmk.pack_scene_mega(ts)
    key = trng.base_key(0)
    _, _, k2 = tmk.render_pixels_mega(pack, tc, tcfg, key, emit_tape=True)
    k2b, its = trm.record_paths_mega(pack, tc, tcfg, key, return_iters=True)
    assert torch.equal(k2b, k2)
    assert torch.equal(trm.record_paths_mega(pack, tc, tcfg, key), k2)
    _, segs = tmk.render_pixels_mega(pack, tc, tcfg, key)
    assert its.dtype == torch.int32 and its.shape == (tcfg.num_rays,)
    assert torch.equal(its.reshape(-1, tcfg.spp).sum(1, dtype=torch.int32),
                       segs)
    # A trip ends each path: the hits recorded plus one miss, unless the
    # path was absorbed or reached the depth cap.
    assert (its >= (k2 >= 0).sum(0)).all()


def test_render_pixels_mega_emit_tape():
    """The tape mode leaves K1's radiance and segments unchanged; pixels
    past the image get all -1 columns; sample offsets select columns."""
    js, jc, cfg = jb.camera_showcase(nx=10, ny=6, spp=4)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmk.pack_scene_mega(ts)
    key = trng.base_key(2)
    rad, segs = tmk.render_pixels_mega(pack, tc, tcfg, key)
    rad_t, segs_t, tape = tmk.render_pixels_mega(pack, tc, tcfg, key,
                                                 emit_tape=True)
    torch.testing.assert_close(rad_t, rad, rtol=0, atol=0)
    assert torch.equal(segs_t, segs)
    assert tape.shape == (tcfg.max_depth + 1, tcfg.num_rays)
    assert torch.equal(tape, trm.record_paths_mega(pack, tc, tcfg, key))
    _, _, past = tmk.render_pixels_mega(pack, tc, tcfg, key, pix0=55,
                                        num_pixels=10, emit_tape=True)
    assert torch.equal(past[:, :20], tape[:, 220:240])
    assert (past[:, 20:] == -1).all()
    half = dataclasses.replace(tcfg, spp=2)
    _, _, second = tmk.render_pixels_mega(pack, tc, half, key, spp0=2,
                                          spp_total=4, emit_tape=True)
    assert torch.equal(second, tape.reshape(-1, 60, 4)[:, :, 2:]
                       .reshape(-1, 120))


def test_recorder_guards():
    js, jc, cfg = jb.three_spheres(nx=8, ny=4, spp=1)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmk.pack_scene_mega(ts)
    key = trng.base_key(0)
    with pytest.raises(ValueError, match="2\\^24"):
        trm.record_paths_mega(pack, tc, tcfg, key, ray0=(1 << 24) - 8,
                              num_rays=16)
    # The recorder is not a caller's setting: K2b records every dense tape.
    with pytest.raises(TypeError, match="impl"):
        trm.record_paths_mega(pack, tc, tcfg, key, impl="legacy")
    meta = dataclasses.replace(pack, spheres=pack.spheres.to("meta"))
    for kw in ({}, {"return_iters": True}):
        with pytest.raises(ValueError, match="device"):
            trm.record_paths_mega(meta, tc, tcfg, key, **kw)
    before = (tmk.render_pixels_mega.tape_launches,
              trm.record_paths_mega.launches)
    trm.record_paths_mega(pack, tc, tcfg, key)
    trm.record_paths_mega(pack, tc, tcfg, key, return_iters=True)
    assert (tmk.render_pixels_mega.tape_launches,
            trm.record_paths_mega.launches) == before  # CPU: none


@pytest.fixture(scope="module")
def small_three_spheres():
    """tests/test_replay.py's setup: three-spheres 12x6 @ 2, depth 8."""
    js, jc, cfg = jb.three_spheres(nx=12, ny=6, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=8)
    return (js, jc, cfg) + _port(js, jc, cfg)


def test_wavefront_record_matches_jax(small_three_spheres):
    js, jc, cfg, ts, tc, tcfg = small_three_spheres
    want = _jax_wavefront_tape(js, jc, cfg, jrng.base_key(0),
                               jnp.arange(cfg.num_rays, dtype=jnp.int32))
    got = _port_wavefront_tape(ts, tc, tcfg, trng.base_key(0),
                               torch.arange(tcfg.num_rays))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pool", [32, 64, 256])
def test_pool_record_matches_jax(small_three_spheres, pool):
    """Pools smaller than, comparable to and larger than the ray count
    (tests/test_replay.py:131): the same tape as JAX's pool recorder and
    as the port's lockstep recorder."""
    js, jc, cfg, ts, tc, tcfg = small_three_spheres
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    want = np.asarray(jax_pool(js, jc, cfg, jrng.base_key(0), ids,
                               pool_size=pool))
    tids = torch.arange(tcfg.num_rays)
    got = trp.record_paths_pool(ts, tc, tcfg, trng.base_key(0), tids,
                                pool_size=pool).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, _port_wavefront_tape(ts, tc, tcfg, trng.base_key(0), tids))


# tests/test_record_mega.py:230-235: preset, size, tape agreement floor.
CLUSTERED = [
    ("sphere-field", dict(n=600, nx=24, ny=12, spp=3), 0.999),
    ("random-spheres", dict(nx=16, ny=8, spp=2), 0.999),
    ("triangle-mesh", dict(nx=16, ny=8, spp=2), 0.99),
]


@pytest.mark.parametrize("name,kw,floor", CLUSTERED,
                         ids=[c[0] for c in CLUSTERED])
def test_plain_k3t_matches_jax_recorders(name, kw, floor):
    js, jc, cfg = jb.build_preset(name, **kw)
    ts, tc, tcfg = _port(js, jc, cfg)
    got = trm.record_paths_mega_clustered(
        tmc.pack_scene_mega_clustered(ts, tc),
        tc, tcfg, trng.base_key(1)).numpy()
    assert got.shape == (cfg.max_depth + 1, cfg.num_rays)
    assert got.dtype == np.int32
    key = jrng.base_key(1)
    clus = np.asarray(jax_record_clustered(
        jax_pack_clustered(js, sort_from=jc.origin), jc, cfg, key,
        interpret=True))
    wave = _jax_wavefront_tape(js, jc, cfg, key,
                               jnp.arange(cfg.num_rays, dtype=jnp.int32))
    jax_spread = int((clus != wave).any(axis=0).sum())
    for ref in (clus, wave):
        agree = (got == ref).mean()
        assert agree > floor - got.shape[0] / got.size, \
            f"tape agreement {agree:.4%}"
        assert int((got != ref).any(axis=0).sum()) <= jax_spread + 1


def test_plain_k3t_slice_and_trips():
    """A ray range recorded alone equals the same columns of the whole
    clustered tape; the trip counts sum per pixel to K3's segments, and
    the tape equals the dense K2b's (the same paths)."""
    js, jc, cfg = jb.sphere_field(n=600, nx=16, ny=8, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmc.pack_scene_mega_clustered(ts, tc)
    key = trng.base_key(3)
    full, its, sweeps = trm.record_paths_mega_clustered(
        pack, tc, tcfg, key, return_iters=True)
    ray0, n = 37, 101
    part = trm.record_paths_mega_clustered(pack, tc, tcfg, key, ray0=ray0,
                                           num_rays=n)
    assert torch.equal(part, full[:, ray0:ray0 + n])
    _, segs = tmc.render_pixels_mega_clustered(pack, tc, tcfg, key)
    assert torch.equal(its.reshape(-1, tcfg.spp).sum(1, dtype=torch.int32),
                       segs)
    assert torch.equal(sweeps, tmc.ungated_sweeps(pack, its))
    dense = trm.record_paths_mega(tmk.pack_scene_mega(ts), tc, tcfg, key)
    assert torch.equal(full, dense)


def test_clustered_recorder_guards():
    js, jc, cfg = jb.three_spheres(nx=8, ny=4, spp=1)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmc.pack_scene_mega_clustered(ts, tc)
    key = trng.base_key(0)
    with pytest.raises(ValueError, match="2\\^24"):
        trm.record_paths_mega_clustered(pack, tc, tcfg, key,
                                        ray0=(1 << 24) - 8, num_rays=16)
    with pytest.raises(ValueError, match="t_min"):
        trm.record_paths_mega_clustered(
            pack, tc, dataclasses.replace(tcfg, t_min=0.0), key)
    meta = dataclasses.replace(pack, sph=pack.sph.to("meta"))
    with pytest.raises(ValueError, match="device"):
        trm.record_paths_mega_clustered(meta, tc, tcfg, key)
    before = trm.record_paths_mega_clustered.launches
    trm.record_paths_mega_clustered(pack, tc, tcfg, key)
    assert trm.record_paths_mega_clustered.launches == before  # CPU: none
