"""The reference agrees with the port's plain versions at a tiny size (the
test imports both; the reference itself imports nothing of the port)."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import fit_check, program, scenes
from benchmark.reference import threefry
from benchmark.reference.tracer import Reference, path_radiance
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import grad
from first_raytracer_tpu_torch.kernels import megakernel, megakernel_clustered
from first_raytracer_tpu_torch.render.camera import camera_rays_plain

from .conftest import ROOT


def _config(name, **image):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["image"].update(image)
    return cfg


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, -5])
def test_threefry_is_the_ports(seed):
    ids = torch.tensor([0, 1, 2, 12345, 2**32 - 1, 9_599_999], dtype=torch.int64)
    for domain in (0, 1, 9, 51):
        want = rng.uniforms_plain(rng.base_key(seed), ids, domain)
        got = threefry.uniforms(seed, ids, domain)
        assert torch.equal(got.float(), want)


def test_scenes_are_the_ports_presets():
    from first_raytracer_tpu_torch.scene.builders import random_scene

    for seed in (7, 11):
        s, _, _ = random_scene(seed=seed)
        for k, v in scenes.book_scene(seed).items():
            assert np.array_equal(v, getattr(s, k).numpy()), k


def test_camera_rays_agree():
    cfg = _config("final_scene", nx=32, ny=16, spp=3)
    ref = Reference(scenes.book_scene(3), cfg["camera"], cfg["image"], "cpu")
    cam = program.camera(cfg["camera"], cfg["image"], "cpu")
    ids = torch.arange(32 * 16 * 3)
    o, d = camera_rays_plain(cam, 32, 16, 3, rng.base_key(11), ids)
    ro, rd = ref.camera_rays(11, ids)
    assert torch.allclose(ro.float(), o, atol=1e-5)
    assert torch.allclose(rd.float(), d, atol=1e-5)


@pytest.mark.parametrize("render", [megakernel.render_image_mega,
                                    megakernel_clustered
                                    .render_image_mega_clustered])
def test_images_agree_with_the_megakernels_plain_version(render):
    cfg = _config("final_scene", nx=24, ny=12, spp=2)
    arrays = scenes.book_scene(5)
    scene = program.scene(arrays, "cpu")
    cam = program.camera(cfg["camera"], cfg["image"], "cpu")
    img = render(scene, cam, program.render_config(cfg["image"]), seed=9,
                 device="cpu")
    ref = Reference(arrays, cfg["camera"], cfg["image"], "cpu")
    want, segs = ref.pixel_means(9, torch.arange(24 * 12), 50)
    got = img.flip(0).reshape(-1, 3).double()
    rel = float((got - want).abs().sum() / want.abs().sum())
    assert rel < 1e-3, rel
    assert segs >= 24 * 12 * 2


def test_fit_paths_agree_with_the_ports_gradient():
    cfg = _config("final_scene", nx=20, ny=10, spp=2)
    arrays = scenes.book_scene(4)
    scene = program.scene(arrays, "cpu")
    cam = program.camera(cfg["camera"], cfg["image"], "cpu")
    rc = program.render_config(cfg["image"], max_depth=8, differentiable=True)
    ids = torch.arange(rc.num_rays)
    key = rng.base_key(21)
    true = {"albedo": scene.albedo.clone()}
    with torch.no_grad():
        target = grad.ray_radiance(true, scene, cam, rc, key, ids)
    p = {"albedo": (scene.albedo * 0.7).clone().requires_grad_(True)}
    loss, g = grad.render_loss_and_grads(p, scene, cam, rc, key, ids, target)

    ref = Reference(arrays, cfg["camera"], cfg["image"], "cpu")
    paths = ref.trace(21, ids, 8, record_mats=True)
    rad = path_radiance(ref.albedo, paths["mats"], paths["sky"])
    off = ((rad.float() - target).abs().amax(1) > 1e-4).float().mean()
    assert float(off) < 0.02
    rloss, rg = fit_check._loss_and_grad(ref.albedo * 0.7, ref.albedo,
                                         paths, 0, rc.num_rays)
    assert float(loss) == pytest.approx(float(rloss), rel=0.02)
    assert float(g["albedo"].double().norm()) == pytest.approx(
        float(rg.norm()), rel=0.02)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_fit_gradient_is_autograds(dtype):
    """The reference's gradient by prefix and suffix products equals
    autograd's of the same loss."""
    cfg = _config("final_scene", nx=16, ny=8, spp=2)
    arrays = scenes.book_scene(6)
    ref = Reference(arrays, cfg["camera"], cfg["image"], "cpu", dtype)
    paths = ref.trace(3, torch.arange(16 * 8 * 2), 8, record_mats=True)
    a = (ref.albedo * 0.8).clone()
    loss, g = fit_check._loss_and_grad(a, ref.albedo, paths, 0, 256,
                                       chunk=100)
    leaf = a.double().requires_grad_(True)
    target = path_radiance(ref.albedo.double(), paths["mats"],
                           paths["sky"].double())
    want = ((path_radiance(leaf, paths["mats"], paths["sky"].double())
             - target) ** 2).mean()
    want.backward()
    tol = 1e-12 if dtype == torch.float64 else 3e-2
    assert float(loss) == pytest.approx(float(want.detach()), rel=tol)
    assert torch.allclose(g.double(), leaf.grad, rtol=tol,
                          atol=tol * float(leaf.grad.abs().max()))
