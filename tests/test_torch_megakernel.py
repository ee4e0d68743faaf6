"""The port's megakernel render against the JAX megakernel and integrators.

On the CPU the port's ``render_pixels_mega`` runs K1's plain version; it is
held against the JAX megakernel in interpret mode, the JAX integrator and
the port's own integrator with the bound the JAX package holds its
megakernel to (tests/test_megakernel.py): ``(|a - b| > 1e-3).mean() <
0.01`` and ``median(|a - b|) < 1e-5``.  The CUDA kernel itself is compared
with the plain version by the ``cuda``-marked test, which skips without a
GPU (tests/test_torch_cuda.py), and by chip_smoke.py.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

from first_raytracer_tpu.kernels.megakernel import (
    pack_scene_mega as jax_pack, render_image_mega as jax_render_mega,
    render_pixels_mega as jax_pixels_mega)
from first_raytracer_tpu.render.api import render_image as jax_render
from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.kernels import megakernel as tmk
from first_raytracer_tpu_torch.render.api import render_image
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
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("name,kw", PRESETS, ids=[p[0] for p in PRESETS])
def test_mega_plain_matches_jax_megakernel(name, kw):
    js, jc, cfg = jb.build_preset(name, **kw)
    ts, tc, tcfg = _port(js, jc, cfg)
    before = tmk.render_pixels_mega.launches
    got = tmk.render_image_mega(ts, tc, tcfg, seed=0, device="cpu").numpy()
    assert tmk.render_pixels_mega.launches == before  # CPU: no kernel
    want = np.asarray(jax_render_mega(js, jc, cfg, interpret=True))
    assert_images_close(got, want)


@pytest.mark.parametrize("name,kw", PRESETS, ids=[p[0] for p in PRESETS])
def test_mega_plain_matches_port_integrator(name, kw):
    js, jc, cfg = jb.build_preset(name, **kw)
    ts, tc, tcfg = _port(js, jc, cfg)
    assert_images_close(
        tmk.render_image_mega(ts, tc, tcfg, device="cpu").numpy(),
        render_image(ts, tc, tcfg, device="cpu").numpy())


def test_mega_segments_match_jax_megakernel():
    js, jc, cfg = jb.three_spheres(nx=16, ny=8, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    _, want = jax_pixels_mega(jax_pack(js), jc, cfg, jrng.base_key(0),
                              interpret=True)
    rad, got = tmk.render_pixels_mega(tmk.pack_scene_mega(ts), tc, tcfg,
                                      trng.base_key(0))
    assert rad.shape == (tcfg.num_pixels, 3) and rad.dtype == torch.float32
    assert got.shape == (tcfg.num_pixels,) and got.dtype == torch.int32
    assert (got >= tcfg.spp).all()  # every sample traces a segment
    assert int(got.sum()) == int(np.asarray(want).sum())


def test_mega_triangles_only_scene():
    """No spheres: the triangle sweep alone supplies every hit."""
    js, jc, cfg = jb.triangle_scene(nx=48, ny=24, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    tri_only = dataclasses.replace(
        ts, sphere_center=torch.zeros((0, 3)),
        sphere_radius=torch.zeros((0,)),
        sphere_mat=torch.zeros((0,), dtype=torch.int32))
    got = tmk.render_image_mega(tri_only, tc, tcfg, device="cpu").numpy()
    assert_images_close(got,
                        render_image(tri_only, tc, tcfg, device="cpu").numpy())
    js_tri = dataclasses.replace(
        js, sphere_center=js.sphere_center[:0],
        sphere_radius=js.sphere_radius[:0], sphere_mat=js.sphere_mat[:0])
    assert_images_close(got, jax_render(js_tri, jc, cfg))


@pytest.mark.parametrize("nx,ny,spp", [(7, 5, 3), (13, 3, 1)])
def test_mega_odd_shapes(nx, ny, spp):
    js, jc, cfg = jb.three_spheres(nx=nx, ny=ny, spp=spp)
    ts, tc, tcfg = _port(js, jc, cfg)
    got = tmk.render_image_mega(ts, tc, tcfg, device="cpu").numpy()
    assert got.shape == (ny, nx, 3)
    assert_images_close(got, np.asarray(jax_render(js, jc, cfg)))


def test_mega_pixel_and_sample_offsets_compose():
    """pix0/num_pixels blocks and spp0/spp_total batches rebuild the
    whole render: the hooks sharded and progressive renders use."""
    js, jc, cfg = jb.camera_showcase(nx=10, ny=6, spp=4)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmk.pack_scene_mega(ts)
    key = trng.base_key(2)
    whole, segs = tmk.render_pixels_mega(pack, tc, tcfg, key)
    blocks = [tmk.render_pixels_mega(pack, tc, tcfg, key, pix0=p0,
                                     num_pixels=n)
              for p0, n in ((0, 25), (25, 25), (50, 25))]
    rad = torch.cat([b[0] for b in blocks])
    assert rad.shape == (75, 3)
    torch.testing.assert_close(rad[:60], whole, rtol=0, atol=0)
    assert (rad[60:] == 0).all()  # past the image: left empty
    assert torch.equal(torch.cat([b[1] for b in blocks])[:60], segs)
    half = dataclasses.replace(tcfg, spp=2)
    parts = [tmk.render_pixels_mega(pack, tc, half, key, spp0=s0,
                                    spp_total=4) for s0 in (0, 2)]
    torch.testing.assert_close(parts[0][0] + parts[1][0], whole,
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(parts[0][1] + parts[1][1], segs)


def test_mega_chunking_invariant():
    js, jc, cfg = jb.random_scene(nx=12, ny=6, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmk.pack_scene_mega(ts)
    key = trng.base_key(0)
    whole = tmk.render_pixels_mega_reference(pack, tc, tcfg, key)
    small = tmk.render_pixels_mega_reference(pack, tc, tcfg, key,
                                             rays_per_chunk=10)
    torch.testing.assert_close(small[0], whole[0], rtol=0, atol=0)
    assert torch.equal(small[1], whole[1])


def test_mega_guards():
    js, jc, cfg = jb.three_spheres(nx=4, ny=2, spp=1)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmk.pack_scene_mega(ts)
    key = trng.base_key(0)
    with pytest.raises(ValueError, match="t_min"):
        tmk.render_pixels_mega(pack, tc, dataclasses.replace(tcfg, t_min=0.0),
                               key)
    meta = dataclasses.replace(pack, spheres=pack.spheres.to("meta"))
    with pytest.raises(ValueError, match="device"):
        tmk.render_pixels_mega(meta, tc, tcfg, key)
    wide = dataclasses.replace(
        pack, tris=torch.zeros((tmk.TRI_ROWS, (1 << 14) + 128)))
    with pytest.raises(ValueError, match="2\\^14"):
        tmk.render_pixels_mega(wide, tc, tcfg, key)


def test_render_image_mega_defaults_to_the_gpu():
    """With no ``device``, the entry point asks for CUDA: on a CPU-only
    torch it raises instead of running the plain version on the host."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    js, jc, cfg = jb.three_spheres(nx=4, ny=2, spp=1)
    ts, tc, tcfg = _port(js, jc, cfg)
    with pytest.raises((AssertionError, RuntimeError)):
        tmk.render_image_mega(ts, tc, tcfg)
    with pytest.raises((AssertionError, RuntimeError)):
        render_image(ts, tc, tcfg)
