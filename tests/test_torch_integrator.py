"""The port's wavefront integrator and render API against JAX.

Both packages get JAX's own scene and camera (through ``convert.py``), so a
mismatch points at the render.  Image bound, as the JAX package holds its
own megakernel to its integrator (tests/test_megakernel.py):
``(|a - b| > 1e-3).mean() < 0.01`` and ``median(|a - b|) < 1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.render import integrator as jint
from first_raytracer_tpu.render.api import render_image as jax_render
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.render import integrator as tint
from first_raytracer_tpu_torch.render.api import (render_image,
                                                  render_ray_batch)
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.render.integrator import RenderConfig

PRESETS = [
    ("three-spheres", dict(nx=32, ny=16, spp=4)),
    ("triangle-mesh", dict(nx=32, ny=16, spp=2)),
    ("camera-effects", dict(nx=32, ny=16, spp=4)),
    ("random-spheres", dict(nx=24, ny=12, spp=2)),
]


def _port(js, jc, cfg):
    return (scene_from_numpy(js.as_numpy()), camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


def assert_images_close(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.shape == np.asarray(want).shape
    assert np.isfinite(got).all()
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("name,kw", PRESETS, ids=[p[0] for p in PRESETS])
def test_render_image_matches_jax(name, kw):
    js, jc, cfg = jb.build_preset(name, **kw)
    ts, tc, tcfg = _port(js, jc, cfg)
    want = np.asarray(jax_render(js, jc, cfg, seed=0))
    got = render_image(ts, tc, tcfg, seed=0, device="cpu").numpy()
    assert got.shape == (cfg.ny, cfg.nx, 3)
    assert_images_close(got, want)


def test_render_image_chunking_invariant():
    js, jc, cfg = jb.three_spheres(nx=12, ny=6, spp=3)
    ts, tc, tcfg = _port(js, jc, cfg)
    whole = render_image(ts, tc, tcfg, seed=5, device="cpu")
    chunked = render_image(ts, tc, tcfg, seed=5, chunk=50,
                           device="cpu")
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    with pytest.raises(ValueError):  # the ring mode is not ported
        render_image(ts, tc, tcfg, mode="ring", device="cpu")


def test_segment_totals_equal_jax():
    """Segment totals on three-spheres 16x8@2 are equal, as the JAX
    package asserts for its own megakernel/integrator pair."""
    js, jc, cfg = jb.three_spheres(nx=16, ny=8, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    key = jrng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    _, want = jint.trace_rays(js, o, d, ids, key, cfg, return_stats=True)
    tids = torch.arange(tcfg.num_rays)
    rad, got = render_ray_batch(ts, tc, tcfg, trng.base_key(0), tids,
                                return_stats=True)
    assert got.dtype == torch.int32 and rad.shape == (tcfg.num_rays, 3)
    assert int(got.sum()) == int(np.asarray(want).sum())


def test_intersect_and_recompute_match():
    """Closest hit on the mixed triangle preset: same primitive and hit
    mask; t and the hit record to 1e-5 relative."""
    js, jc, cfg = jb.triangle_scene(nx=24, ny=12, spp=1)
    ts, tc, tcfg = _port(js, jc, cfg)
    key = trng.base_key(1)
    ids = torch.arange(tcfg.num_rays)
    o, d = generate_rays(tc, cfg.nx, cfg.ny, cfg.spp, ids,
                         trng.camera_uniforms(key, ids))
    prim, t, hit = tint.intersect_brute(ts, o, d, 1e-3)
    jprim, jt, jhit = jint.intersect_brute(js, o.numpy(), d.numpy(), 1e-3)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(prim.numpy()[hit.numpy()],
                                  np.asarray(jprim)[hit.numpy()])
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5)
    rec = tint.recompute_hit(ts, o, d, prim, 1e-3)
    jrec = jint.recompute_hit(js, o.numpy(), d.numpy(), jprim, 1e-3)
    m = hit.numpy()
    for g, w in zip(rec, jrec):
        np.testing.assert_allclose(g.numpy()[m], np.asarray(w)[m],
                                   rtol=1e-5, atol=1e-5)
    sky = tint.sky_color(d).numpy()
    np.testing.assert_allclose(sky, np.asarray(jint.sky_color(d.numpy())),
                               rtol=0, atol=1e-6)
