"""The port's scene, camera, builders and megakernel pack against JAX.

The builders copy the JAX package's seeded NumPy logic, so every preset
and every pack array must be equal; the camera is float32 arithmetic in the
same order and is held to 1e-6 relative.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.kernels.megakernel import (
    pack_scene_mega as jax_pack_scene_mega)
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu.scene.textures import texture_value as jax_texture
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               camera_to_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.kernels.megakernel import pack_scene_mega
from first_raytracer_tpu_torch.render.camera import (generate_rays,
                                                     make_camera)
from first_raytracer_tpu_torch.scene import builders as tb
from first_raytracer_tpu_torch.scene.soa import SceneBuilder
from first_raytracer_tpu_torch.scene.textures import texture_value

# Small sizes; the field presets at small n (their loops are the same).
PRESET_KW = {
    "three-spheres": dict(nx=24, ny=12, spp=2),
    "random-spheres": dict(nx=24, ny=12, spp=2),
    "triangle-mesh": dict(nx=32, ny=16, spp=2),
    "camera-effects": dict(nx=32, ny=16, spp=4),
    "sphere-field": dict(n=300, nx=32, ny=18, spp=1),
    "triangle-field": dict(n=300, nx=32, ny=18, spp=1),
}


def test_preset_names_match():
    assert list(tb.PRESETS) == list(jb.PRESETS)


@pytest.mark.parametrize("name", list(PRESET_KW))
def test_preset_scene_and_config_equal(name):
    js, jc, jcfg = jb.build_preset(name, **PRESET_KW[name])
    ts, tc, tcfg = tb.build_preset(name, **PRESET_KW[name])
    jsn, tsn = js.as_numpy(), ts.as_numpy()
    for f in dataclasses.fields(jsn):
        a, b = getattr(jsn, f.name), getattr(tsn, f.name)
        assert b.dtype == a.dtype and b.shape == a.shape, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    for f in ("nx", "ny", "spp", "max_depth", "t_min"):
        assert getattr(tcfg, f) == getattr(jcfg, f)
    # Camera: the same f32 operations, within an ulp or two.
    for k, v in camera_to_numpy(tc).items():
        np.testing.assert_allclose(v, np.asarray(getattr(jc, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["random-spheres", "triangle-mesh",
                                  "camera-effects", "triangle-field"])
def test_pack_scene_mega_equal(name):
    js, _, _ = jb.build_preset(name, **PRESET_KW[name])
    ts, _, _ = tb.build_preset(name, **PRESET_KW[name])
    jp, tp = jax_pack_scene_mega(js), pack_scene_mega(ts)
    for f in ("spheres", "sph_mx", "tris", "sph_order", "tri_order"):
        a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert b.dtype == a.dtype, f
        if f == "sph_mx":  # JAX's fields; columns 4-7 are the port's own
            a, b = a[:, :4], b[:, :4]
        np.testing.assert_array_equal(b, a, err_msg=f)
    # The port's sphere-root row: centre and radius, NaN past the spheres.
    mx, ns = tp.sph_mx.numpy(), tp.sphere_rows
    np.testing.assert_array_equal(mx[:ns, 4:7], mx[:ns, 0:3])
    np.testing.assert_array_equal(mx[:ns, 7], tp.spheres[3, :ns].numpy())
    assert np.isnan(mx[ns:, 7]).all()
    for f in ("sphere_rows", "tri_rows", "sph_groups", "tri_groups",
              "has_checker"):
        assert getattr(tp, f) == getattr(jp, f), f


def test_convert_round_trip():
    js, jc, _ = jb.camera_showcase(nx=16, ny=8, spp=1)
    ts = scene_from_numpy(js.as_numpy())
    tc = camera_from_numpy(jc)
    back = ts.as_numpy()
    for f in dataclasses.fields(js):
        a, b = np.asarray(getattr(js, f.name)), getattr(back, f.name)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    for k, v in camera_to_numpy(tc).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jc, k)))
    # Through the port's own numpy copy as well.
    again = scene_from_numpy(ts.as_numpy())
    for f in dataclasses.fields(ts):
        assert torch.equal(getattr(again, f.name), getattr(ts, f.name))


def test_scene_builder_counts_and_validation():
    b = SceneBuilder()
    with pytest.raises(ValueError):
        b.build()
    m = b.metal((0.5, 0.5, 0.5), fuzz=3.0)
    b.sphere((0, 0, 0), 1.0, m)
    s = b.build()
    assert (s.num_spheres, s.num_triangles, s.num_materials) == (1, 0, 1)
    assert s.tri_v0.shape == (0, 3)
    assert float(s.fuzz[0]) == 1.0  # the reference clamps fuzz to 1
    assert s.prim_mat().tolist() == [0]


def test_generate_rays_match():
    """ulp level: 1e-6 relative on origins and unit directions."""
    js, jc, cfg = jb.camera_showcase(nx=40, ny=20, spp=3)
    tc = camera_from_numpy(jc)
    ids = np.arange(cfg.num_rays, dtype=np.int64)
    key = trng.base_key(3)
    cu = trng.camera_uniforms(key, torch.from_numpy(ids))
    o, d = generate_rays(tc, cfg.nx, cfg.ny, cfg.spp, torch.from_numpy(ids),
                         cu)
    jo, jd = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp,
                      jnp.asarray(ids.astype(np.int32)),
                      jnp.asarray(cu.numpy()))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=1), 1.0,
                               atol=1e-6)


def test_make_camera_default_focus():
    c = make_camera((3, 3, 2), (0, 0, -1), (0, 1, 0), 20.0, 2.0,
                    aperture=2.0)
    assert float(c.lens_radius) == 1.0
    assert c.origin.dtype == torch.float32


def test_texture_value_matches():
    """Checker and constant textures, 1e-6 abs at the same points."""
    js, _, _ = jb.camera_showcase(nx=8, ny=4, spp=1)
    ts = scene_from_numpy(js.as_numpy())
    r = np.random.RandomState(2)
    p = (r.randn(512, 3) * 2).astype(np.float32)
    mat = r.randint(0, js.num_materials, 512).astype(np.int32)
    want = np.asarray(jax_texture(js, jnp.asarray(mat), jnp.asarray(p)))
    got = texture_value(ts, torch.from_numpy(mat), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
