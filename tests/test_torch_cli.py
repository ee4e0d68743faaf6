"""The port's CLI and image output against the JAX package.

The CLI runs in a subprocess on the CPU; its PNG must decode and match the
JAX render's ``to_uint8`` image within +-1 on 99% of values.  The image
writers are NumPy in both packages and must write byte-equal files.  The
``fit`` subcommand's first logged loss matches the JAX CLI's step-0 loss
(the loss at the same perturbed parameters) within ``rtol=1e-5``.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from first_raytracer_tpu.kernels.megakernel import (
    render_image_mega as jax_render_mega)
from first_raytracer_tpu.render import image as jimg
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.render import image as timg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cli(*args, cmd="render"):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "first_raytracer_tpu_torch.cli", cmd,
         "--device", "cpu", *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)


RENDER_MODES = {"mega": ["--mode", "mega"],
                "wavefront": ["--mode", "wavefront"],
                "mega-clustered": ["--mode", "mega-clustered"]}


@pytest.mark.parametrize("mode", list(RENDER_MODES))
def test_cli_render_matches_jax(tmp_path, mode):
    out = tmp_path / f"three_{mode}.png"
    proc = _run_cli("--preset", "three-spheres", "--nx", "24", "--ny", "12",
                    "--spp", "2", *RENDER_MODES[mode], "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert f"{mode}, cpu)" in proc.stdout  # three spheres: no switch
    got = timg.read_png(str(out))
    js, jc, cfg = jb.three_spheres(nx=24, ny=12, spp=2)
    want = jimg.to_uint8(np.asarray(jax_render_mega(js, jc, cfg,
                                                    interpret=True)))
    assert got.shape == want.shape == (12, 24, 3)
    close = np.abs(got.astype(np.int16) - want.astype(np.int16)) <= 1
    assert close.mean() >= 0.99


def test_cli_render_large_scene_takes_the_clustered_kernel(tmp_path):
    """``render --mode mega`` on sphere-field (20,004 spheres, past the
    dense kernels' ``DENSE_MAX``) renders through the clustered megakernel
    (its plain version on the CPU): the same image as
    ``render_image_mega_clustered``."""
    from first_raytracer_tpu_torch.kernels.megakernel_clustered import (
        render_image_mega_clustered)
    from first_raytracer_tpu_torch.scene.builders import build_preset

    out = tmp_path / "field.png"
    proc = _run_cli("--preset", "sphere-field", "--nx", "6", "--ny", "4",
                    "--spp", "1", "--max-depth", "3", "--mode", "mega",
                    "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "--mode mega-clustered" in proc.stderr
    assert "mega-clustered, cpu)" in proc.stdout
    scene, cam, cfg = build_preset("sphere-field", device="cpu", nx=6, ny=4,
                                   spp=1)
    want = render_image_mega_clustered(
        scene, cam, dataclasses.replace(cfg, max_depth=3), device="cpu")
    np.testing.assert_array_equal(timg.read_png(str(out)),
                                  timg.to_uint8(want))


def test_cli_ppm_to_stdout():
    proc = _run_cli("--preset", "three-spheres", "--nx", "6", "--ny", "4",
                    "--spp", "1", "--max-depth", "4", "--out", "-")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("P3\n6 4\n255\n")


def test_image_files_byte_equal(tmp_path):
    r = np.random.RandomState(5)
    img = (r.rand(9, 13, 3) * 1.2 - 0.1).astype(np.float32)
    for ext, jw, tw in (("png", jimg.write_png, timg.write_png),
                        ("ppm", jimg.write_ppm, timg.write_ppm)):
        a, b = tmp_path / f"jax.{ext}", tmp_path / f"port.{ext}"
        jw(str(a), img)
        tw(str(b), torch.from_numpy(img))
        assert a.read_bytes() == b.read_bytes()
        np.testing.assert_array_equal(timg.read_image(str(b)),
                                      jimg.read_image(str(a)))
    np.testing.assert_array_equal(timg.to_uint8(torch.from_numpy(img)),
                                  jimg.to_uint8(img))
    np.testing.assert_array_equal(timg.gamma_correct(img),
                                  jimg.gamma_correct(img))


def test_image_diff_stats_match():
    r = np.random.RandomState(6)
    a = r.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + r.randint(-6, 7, a.shape), 0, 255)
    b = b.astype(np.uint8)
    assert timg.image_diff_stats(torch.from_numpy(a), b) == \
        jimg.image_diff_stats(a, b)


def _jax_fit_first_loss(preset, fields, seed, max_depth=8, **kw):
    """The JAX CLI's ``fit`` step-0 loss: the loss at its perturbed
    parameters (first_raytracer_tpu/cli.py:151-218), depth capped at
    ``max_depth`` as ``--max-depth`` and the CLI's own cap of 8 do."""
    import jax
    import jax.numpy as jnp
    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.diff.grad import (ray_radiance, render_loss,
                                               split_params)

    scene, cam, cfg = jb.build_preset(preset, **kw)
    cfg = dataclasses.replace(cfg, max_depth=min(cfg.max_depth, max_depth),
                              differentiable=True)
    key = jrng.base_key(seed)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    true_params, _ = split_params(scene, fields=fields)
    target = ray_radiance(true_params, scene, cam, cfg, key, ids)
    r = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.clip(
            np.asarray(p) * (0.6 + 0.3 * r.rand(*p.shape)), 0.02, None),
            jnp.float32), true_params)
    return float(render_loss(params, scene, cam, cfg, key, ids, target))


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "direct"])
def test_cli_fit(tmp_path, fast):
    ckpt = tmp_path / "fit.npz"
    args = ["--preset", "random-spheres", "--nx", "16", "--ny", "8",
            "--spp", "2", "--fields", "albedo,fuzz", "--opt", "adam",
            "--lr", "0.05", "--steps", "3", "--log-every", "1",
            "--checkpoint", str(ckpt)] + (["--fast"] if fast else [])
    proc = _run_cli(*args, cmd="fit")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    steps, last = lines[:-1], lines[-1]
    assert [s["step"] for s in steps] == [0, 1, 2]
    assert all(set(s["max_param_err"]) == {"albedo", "fuzz"} for s in steps)
    assert steps[-1]["loss"] < steps[0]["loss"]
    assert last["fit"] == "done" and last["device"] == "cpu"
    assert last["kernel_launches"] == {"K1": 0, "K2": 0, "K2b": 0,
                                       "K3": 0, "K3t": 0}
    want = _jax_fit_first_loss("random-spheres", ("albedo", "fuzz"), 0,
                               nx=16, ny=8, spp=2)
    np.testing.assert_allclose(steps[0]["loss"], want, rtol=1e-5)
    with np.load(ckpt) as saved:
        assert sorted(saved.files) == ["albedo", "fuzz"]


def test_cli_fit_large_scene_takes_the_clustered_recorder():
    """``fit --fast`` on sphere-field (20,004 spheres) records with the
    clustered recorder (its plain version on the CPU); the first logged
    loss matches the JAX CLI's step-0 loss within ``rtol=1e-4`` (measured
    6.4e-5: the field's camera sits 40-90 units out, where f32 rounding of
    the sphere quadratic moves a ray's radiance more than in the final
    scene, whose bound is 1e-5)."""
    args = ["--preset", "sphere-field", "--nx", "4", "--ny", "2", "--spp",
            "1", "--max-depth", "4", "--fields", "albedo", "--opt", "adam",
            "--lr", "0.05", "--steps", "2", "--log-every", "1", "--fast"]
    proc = _run_cli(*args, cmd="fit")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    steps, last = lines[:-1], lines[-1]
    assert [s["step"] for s in steps] == [0, 1]
    assert last["fit"] == "done" and last["device"] == "cpu"
    want = _jax_fit_first_loss("sphere-field", ("albedo",), 0, nx=4, ny=2,
                               spp=1, max_depth=4)
    np.testing.assert_allclose(steps[0]["loss"], want, rtol=1e-4)
