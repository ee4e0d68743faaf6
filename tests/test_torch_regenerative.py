"""The port's regenerative (compacted-pool) render against its wavefront
render and the JAX package's regenerative render.

Every ray's math is the same in both integrators (the counter RNG travels
with the ray), so the images match to float rounding (``atol=2e-6``,
tests/test_regenerative.py:26) across pools smaller than, equal to and
larger than the ray count, and with every closest hit (the dense sweep,
K4's and K5's plain versions, the flat-BVH walk).  Against JAX's
regenerative render: the image bound ``(|a - b| > 1e-3).mean() < 0.01``
and median below 1e-5 (the two packages round camera rays and scatter by
their own libraries).
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from first_raytracer_tpu.render.api import render_image as jax_render
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.accel.build import build_bvh
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.kernels.intersect_clustered import (
    pack_scene_clustered)
from first_raytracer_tpu_torch.kernels.intersect_pallas import (
    pack_scene_pallas)
from first_raytracer_tpu_torch.render.api import render_image, render_ray_batch
from first_raytracer_tpu_torch.render.integrator import RenderConfig
from first_raytracer_tpu_torch.render.regenerative import (
    render_rays_regenerative)


def _port(js, jc, cfg):
    return (scene_from_numpy(js.as_numpy()), camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


@pytest.fixture(scope="module")
def setup():
    js, jc, cfg = jb.three_spheres(nx=16, ny=8, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    ref = render_image(ts, tc, tcfg, seed=0, device="cpu")
    return js, jc, cfg, ts, tc, tcfg, ref


@pytest.mark.parametrize("pool", [64, 256, 1024])
def test_regenerative_matches_wavefront(setup, pool):
    *_, ts, tc, tcfg, ref = setup
    img = render_image(ts, tc, tcfg, seed=0, mode="regenerative",
                       pool_size=pool, device="cpu")
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=2e-6)


@pytest.mark.parametrize("accel", ["bvh", "dense", "clustered"])
def test_regenerative_with_an_accel(setup, accel):
    *_, ts, tc, tcfg, ref = setup
    acc = {"bvh": build_bvh, "dense": pack_scene_pallas,
           "clustered": pack_scene_clustered}[accel](ts)
    img = render_image(ts, tc, tcfg, seed=0, accel=acc, mode="regenerative",
                       pool_size=128, device="cpu")
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=2e-6)
    wave = render_image(ts, tc, tcfg, seed=0, accel=acc, device="cpu")
    np.testing.assert_allclose(wave.numpy(), ref.numpy(), atol=2e-6)


def test_regenerative_matches_jax(setup):
    js, jc, cfg, ts, tc, tcfg, _ = setup
    want = np.asarray(jax_render(js, jc, cfg, seed=0, mode="regenerative",
                                 pool_size=256))
    got = render_image(ts, tc, tcfg, seed=0, mode="regenerative",
                       pool_size=256, device="cpu").numpy()
    diff = np.abs(got - want)
    assert got.shape == want.shape == (cfg.ny, cfg.nx, 3)
    assert (diff > 1e-3).mean() < 0.01 and np.median(diff) < 1e-5


def test_regenerative_deep_scene_and_a_ray_range():
    """random-spheres (glass paths to the depth cap) through a pool of 64,
    over ray ids [start, start + n) that are not a whole image: equal to
    the wavefront's radiance of the same ids."""
    js, jc, cfg = jb.random_scene(nx=12, ny=8, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    key = trng.base_key(3)
    start, n = 37, 150
    got = render_rays_regenerative(ts, tc, tcfg, key, start, n,
                                   accel=pack_scene_pallas(ts), pool_size=64)
    want = render_ray_batch(ts, tc, tcfg, key, torch.arange(start, start + n))
    assert got.shape == (n, 3)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_pool_clamp_and_modes(setup):
    """A pool larger than the image is clamped to the ray count (at least
    256), as the JAX package clamps it; an unknown mode raises."""
    *_, ts, tc, tcfg, ref = setup
    img = render_image(ts, tc, tcfg, seed=0, mode="regenerative",
                       pool_size=1 << 20, device="cpu")
    np.testing.assert_allclose(img.numpy(), ref.numpy(), atol=2e-6)
    with pytest.raises(ValueError):
        render_image(ts, tc, tcfg, mode="ring", device="cpu")
