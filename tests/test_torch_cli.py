"""The port's CLI and image output against the JAX package.

The CLI runs in a subprocess on the CPU; its PNG must decode and match the
JAX render's ``to_uint8`` image within +-1 on 99% of values.  The image
writers are NumPy in both packages and must write byte-equal files.  The
``fit`` subcommand's first logged loss matches the JAX CLI's step-0 loss
(the loss at the same perturbed parameters) within ``rtol=1e-5``.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
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
    env = dict(os.environ, PYTHONPATH=REPO,
               OMP_NUM_THREADS=str(torch_cpu.THREADS))
    device = [] if cmd == "compare" else ["--device", "cpu"]
    return subprocess.run(
        [sys.executable, "-m", "first_raytracer_tpu_torch.cli", cmd,
         *device, *args], cwd=REPO, env=env, capture_output=True,
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


def _jax_fit_first_loss(preset, fields, seed, max_depth=8, tape=None,
                        **kw):
    """The JAX CLI's ``fit`` step-0 loss: the loss at its perturbed
    parameters (first_raytracer_tpu/cli.py:151-218), depth capped at
    ``max_depth`` as ``--max-depth`` and the CLI's own cap of 8 do; with
    ``tape``, JAX's replay of that tape at those parameters against the
    same target."""
    import jax
    import jax.numpy as jnp
    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.diff.grad import (ray_radiance, render_loss,
                                               render_loss_and_grads_tape,
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
    if tape is not None:
        loss, _ = render_loss_and_grads_tape(params, scene, cam, cfg, key,
                                             ids, target, jnp.asarray(tape))
        return float(loss)
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
                                       "K3": 0, "K3t": 0, "K4": 0, "K5": 0,
                                       "K6": 0, "K7": 0, "K8": 0, "K9": 0,
                                       "K10": 0, "K11": 0, "K12": 0,
                                       "K12 (length)": 0, "K12 (pool)": 0,
                                       "K13": 0, "K14": 0, "K15": 0,
                                       "K16": 0, "K17": 0}
    # The CPU runs the replay's value and gradient eagerly: no graph.
    assert last["graphs"] == {"captures": 0, "replays": 0}
    want = _jax_fit_first_loss("random-spheres", ("albedo", "fuzz"), 0,
                               nx=16, ny=8, spp=2)
    np.testing.assert_allclose(steps[0]["loss"], want, rtol=1e-5)
    with np.load(ckpt) as saved:
        assert sorted(saved.files) == ["albedo", "fuzz"]


def test_cli_fit_line_reads_every_kernel_counter(monkeypatch, capsys):
    """``fit``'s ``kernel_launches`` is ``bench.COUNTERS``' table: K1-K17,
    each its wrapper's counter (set here, since the CPU's plain versions
    count nothing), K6-K13 among them on a ``--bvh`` fit."""
    from first_raytracer_tpu_torch import bench, cli

    for i, (_, fn, attr) in enumerate(bench.COUNTERS):
        monkeypatch.setattr(fn, attr, 100 + i)
    assert cli.main(["fit", "--preset", "three-spheres", "--nx", "8", "--ny",
                     "4", "--spp", "1", "--device", "cpu", "--bvh",
                     "--fields", "albedo", "--steps", "1",
                     "--max-depth", "3"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = {k: 100 + i for i, (k, _, _) in enumerate(bench.COUNTERS)}
    assert last["kernel_launches"] == want
    assert {"K6", "K7", "K8", "K9", "K10", "K11", "K12", "K12 (length)",
            "K12 (pool)", "K13", "K14", "K15", "K16", "K17"} <= set(want)


def test_cli_fit_large_scene_takes_the_clustered_recorder():
    """``fit --fast`` on sphere-field (20,004 spheres) records with the
    clustered recorder (its plain version on the CPU); its tape parts from
    JAX's wavefront recorder only on rays where JAX's own clustered and
    wavefront recorders part (ray 7, which grazes lambertian sphere 4701
    168 units out: JAX's wavefront hits it twice in a row and JAX's
    clustered recorder three times, which a convex surface cannot give,
    and the port's float64 root once), and the first logged loss matches
    JAX's step-0 loss on that tape within ``rtol=1e-4`` (the field's
    camera sits 40-90 units out, where f32 rounding of the sphere
    quadratic moves a ray's radiance more than in the final scene, whose
    bound is 1e-5)."""
    import jax.numpy as jnp
    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.diff.replay import record_paths as jax_record
    from first_raytracer_tpu.kernels.megakernel_clustered import (
        pack_scene_mega_clustered as jax_pack)
    from first_raytracer_tpu.kernels.record_mega import (
        record_paths_mega_clustered as jax_k3t)
    from first_raytracer_tpu.render.camera import generate_rays as jax_rays
    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
    from first_raytracer_tpu_torch.kernels import record_mega as rm
    from first_raytracer_tpu_torch.scene.builders import build_preset

    args = ["--preset", "sphere-field", "--nx", "4", "--ny", "2", "--spp",
            "1", "--max-depth", "4", "--fields", "albedo", "--opt", "adam",
            "--lr", "0.05", "--steps", "2", "--log-every", "1", "--fast"]
    proc = _run_cli(*args, cmd="fit")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    steps, last = lines[:-1], lines[-1]
    assert [s["step"] for s in steps] == [0, 1]
    assert last["fit"] == "done" and last["device"] == "cpu"

    kw = dict(nx=4, ny=2, spp=1)
    scene, cam, cfg = build_preset("sphere-field", device="cpu", **kw)
    cfg = dataclasses.replace(cfg, max_depth=4)
    tape = rm.record_paths_mega_clustered(
        mc.pack_scene_mega_clustered(scene, cam), cam, cfg,
        rng.base_key(0)).numpy()
    js, jc, jcfg = jb.build_preset("sphere-field", **kw)
    jcfg = dataclasses.replace(jcfg, max_depth=4)
    key = jrng.base_key(0)
    ids = jnp.arange(jcfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, jcfg.nx, jcfg.ny, jcfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    wave = np.asarray(jax_record(js, o, d, ids, key, jcfg))
    clustered = np.asarray(jax_k3t(jax_pack(js, sort_from=jc.origin), jc,
                                   jcfg, key, interpret=True))
    spread = np.nonzero((clustered != wave).any(axis=0))[0].tolist()
    parts = np.nonzero((tape != wave).any(axis=0))[0].tolist()
    assert spread == [7] and set(parts) <= set(spread), (parts, spread)
    want = _jax_fit_first_loss("sphere-field", ("albedo",), 0, max_depth=4,
                               tape=tape, **kw)
    np.testing.assert_allclose(steps[0]["loss"], want, rtol=1e-4)


ACCEL_RENDERS = {
    "regenerative": ["--mode", "regenerative"],
    "regenerative-clustered": ["--mode", "regenerative", "--clustered"],
    "wavefront-bvh": ["--mode", "wavefront", "--bvh"],
    "wavefront-clustered": ["--mode", "wavefront", "--clustered"],
}


@pytest.mark.parametrize("case", list(ACCEL_RENDERS))
def test_cli_render_wavefront_modes_and_accels(tmp_path, case):
    """``--mode wavefront|regenerative`` with ``--clustered`` (K5's plain
    version here) or ``--bvh``: the PNG equals the port's
    ``render_image`` without an accel (every closest hit finds the same
    primitives on three-spheres, and the pool equals the chunks)."""
    from first_raytracer_tpu_torch.render.api import render_image
    from first_raytracer_tpu_torch.scene.builders import build_preset

    out = tmp_path / f"{case}.png"
    proc = _run_cli("--preset", "three-spheres", "--nx", "24", "--ny", "12",
                    "--spp", "2", *ACCEL_RENDERS[case], "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert f"{ACCEL_RENDERS[case][1]}, cpu)" in proc.stdout
    scene, cam, cfg = build_preset("three-spheres", device="cpu", nx=24,
                                   ny=12, spp=2)
    want = timg.to_uint8(render_image(scene, cam, cfg, device="cpu"))
    np.testing.assert_array_equal(timg.read_png(str(out)), want)


def test_cli_render_clustered_mega_and_bvh_mega():
    """``--clustered --mode mega`` means mega-clustered, as in the JAX
    CLI; ``--bvh`` has no megakernel and is refused there."""
    proc = _run_cli("--preset", "three-spheres", "--nx", "6", "--ny", "4",
                    "--spp", "1", "--max-depth", "3", "--clustered",
                    "--out", "-")
    assert proc.returncode == 0, proc.stderr
    assert "--clustered: --mode mega-clustered" in proc.stderr
    proc = _run_cli("--preset", "three-spheres", "--nx", "6", "--ny", "4",
                    "--spp", "1", "--bvh", "--out", "-")
    assert proc.returncode != 0 and "--bvh needs" in proc.stderr


def test_cli_render_checkpoint_and_preview(tmp_path):
    """``--checkpoint`` renders in batches through ``progressive_render``
    and writes the checkpoint and the preview; the image equals the
    one-shot wavefront render's, and a second run resumes from the
    finished checkpoint."""
    from first_raytracer_tpu_torch.render.api import render_image
    from first_raytracer_tpu_torch.scene.builders import build_preset

    ckpt, preview = tmp_path / "r.ckpt.npz", tmp_path / "prev.png"
    out = tmp_path / "r.png"
    args = ["--preset", "three-spheres", "--nx", "16", "--ny", "8", "--spp",
            "3", "--checkpoint", str(ckpt), "--batch-spp", "2",
            "--preview", str(preview), "--out", str(out)]
    proc = _run_cli(*args)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.count("preview @") == 2
    assert "progressive wavefront, cpu)" in proc.stdout
    with np.load(ckpt) as saved:
        assert int(saved["samples_done"]) == 3 and int(saved["seed"]) == 0
    scene, cam, cfg = build_preset("three-spheres", device="cpu", nx=16,
                                   ny=8, spp=3)
    want = timg.to_uint8(render_image(scene, cam, cfg, device="cpu"))
    got = timg.read_png(str(out))
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).all()
    np.testing.assert_array_equal(timg.read_png(str(preview)), got)
    again = _run_cli(*args)
    assert again.returncode == 0 and "preview @" not in again.stderr


@pytest.mark.parametrize("accel", [[], ["--bvh"], ["--clustered"]],
                         ids=["dense-sweep", "bvh", "clustered"])
def test_cli_bench(accel):
    """``bench`` prints one JSON line: the timed batch's seconds, Mpaths/s,
    Mrays/s (its segments) and the accel used."""
    proc = _run_cli("--preset", "three-spheres", "--nx", "16", "--ny", "8",
                    "--spp", "2", "--rays", "100", *accel, cmd="bench")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["rays"] == 100 and out["device"] == "cpu"
    assert out["seconds"] > 0 and out["mpaths_per_s"] > 0
    assert 1.0 <= out["avg_path_length"] <= 51
    want = {"[]": None, "['--bvh']": "FlatBVH",
            "['--clustered']": "ClusteredScenePack"}[str(accel)]
    assert out["accel"] == want


def test_cli_fit_with_the_clustered_intersector():
    """``fit --clustered`` (the direct step, closest hit by K5's plain
    version): its first loss equals the JAX CLI's step-0 loss (same
    winners as the dense sweep) within ``rtol=1e-5``; no kernel launches
    on the CPU."""
    args = ["--preset", "random-spheres", "--nx", "16", "--ny", "8",
            "--spp", "2", "--fields", "albedo", "--opt", "sgd", "--lr",
            "0.5", "--steps", "2", "--log-every", "1", "--clustered"]
    proc = _run_cli(*args, cmd="fit")
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    steps, last = lines[:-1], lines[-1]
    assert [s["step"] for s in steps] == [0, 1]
    assert set(last["kernel_launches"].values()) == {0}
    want = _jax_fit_first_loss("random-spheres", ("albedo",), 0, nx=16,
                               ny=8, spp=2)
    np.testing.assert_allclose(steps[0]["loss"], want, rtol=1e-5)


def test_cli_render_ring_matches_jax(tmp_path):
    """``render --mode ring`` in one process (one shard, one hop): the JAX
    CLI's ring render of three-spheres within +-1 on 99% of values (the
    bound of ``test_cli_render_matches_jax``), and the port's wavefront
    image exactly."""
    from first_raytracer_tpu.parallel.mesh import make_render_mesh
    from first_raytracer_tpu.parallel.ring import render_image_ring
    from first_raytracer_tpu_torch.render.api import render_image
    from first_raytracer_tpu_torch.scene.builders import build_preset

    out = tmp_path / "ring.png"
    proc = _run_cli("--preset", "three-spheres", "--nx", "24", "--ny", "12",
                    "--spp", "2", "--mode", "ring", "--out", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "ring, cpu)" in proc.stdout
    got = timg.read_png(str(out))
    js, jc, cfg = jb.three_spheres(nx=24, ny=12, spp=2)
    want = jimg.to_uint8(np.asarray(render_image_ring(
        js, jc, cfg, make_render_mesh(1, 1, devices=_jax_devices()[:1]))))
    close = np.abs(got.astype(np.int16) - want.astype(np.int16)) <= 1
    assert close.mean() >= 0.99
    scene, cam, tcfg = build_preset("three-spheres", device="cpu", nx=24,
                                    ny=12, spp=2)
    np.testing.assert_array_equal(
        got, timg.to_uint8(render_image(scene, cam, tcfg, device="cpu")))


def _jax_devices():
    import jax

    return jax.devices()


def test_cli_occupancy_matches_jax_keys():
    """``occupancy`` prints the JAX CLI's report: the same keys, the
    wavefront counts equal to JAX's, the megakernels' sections with the
    JAX report's keys."""
    from first_raytracer_tpu.utils.metrics import (
        wavefront_occupancy as jax_wavefront_occupancy)

    proc = _run_cli("--preset", "three-spheres", "--nx", "24", "--ny", "12",
                    "--spp", "2", cmd="occupancy")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    js, jc, cfg = jb.three_spheres(nx=24, ny=12, spp=2)
    want = jax_wavefront_occupancy(js, jc, cfg, seed=0)
    assert out["alive_per_bounce"] == want["alive_per_bounce"]
    assert set(out) == set(want) | {"megakernel", "megakernel_clustered"}
    assert set(out["megakernel"]) == {
        "segments", "mean_path_len", "tile_trips_mean", "tile_trips_max",
        "lane_occupancy"}
    assert set(out["megakernel_clustered"]) == set(out["megakernel"]) | {
        "clusters", "sweeps_per_iter"}
    assert abs(out["megakernel"]["mean_path_len"]
               - out["avg_path_length"]) < 1e-3


@pytest.mark.parametrize("fmt", ["png", "ppm", "npz"])
def test_cli_compare_formats_and_exit_codes(tmp_path, fmt):
    """``compare`` reads PNG, PPM (P3 and P6) and npz; its statistics equal
    the JAX package's ``image_diff_stats``; with ``--max-frac-gt-4`` it
    exits 1 above the threshold and 0 at or below it."""
    r = np.random.RandomState(7)
    a = (r.rand(6, 9, 3) * 0.8).astype(np.float32)
    b = a.copy()
    b[0, :3] += 0.5  # 3 of 54 pixels move by far more than 4/255
    pa, pb = tmp_path / f"a.{fmt}", tmp_path / f"b.{fmt}"
    for img, path in ((a, pa), (b, pb)):
        if fmt == "png":
            timg.write_png(str(path), torch.from_numpy(img))
        elif fmt == "ppm":
            timg.write_ppm(str(path), torch.from_numpy(img))
        else:
            np.savez(path, img=img)
    proc = _run_cli(str(pa), str(pb), cmd="compare")
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout)
    assert stats == json.loads(json.dumps(jimg.image_diff_stats(
        jimg.read_image(str(pa)), jimg.read_image(str(pb)))))
    assert stats["frac_pixels_gt_4"] == pytest.approx(3 / 54)
    assert _run_cli(str(pa), str(pb), "--max-frac-gt-4", "0.05",
                    cmd="compare").returncode == 1
    assert _run_cli(str(pa), str(pb), "--max-frac-gt-4", "0.06",
                    cmd="compare").returncode == 0


def test_cli_compare_reads_binary_ppm(tmp_path):
    """A P6 file (as other renderers write them) reads as its P3 twin."""
    r = np.random.RandomState(8)
    img = r.randint(0, 256, (4, 5, 3)).astype(np.uint8)
    p6 = tmp_path / "x6.ppm"
    p6.write_bytes(b"P6\n5 4\n255\n" + img.tobytes())
    p3 = tmp_path / "x3.ppm"
    p3.write_text("P3\n5 4\n255\n" + "\n".join(
        " ".join(str(v) for v in px) for px in img.reshape(-1, 3)) + "\n")
    proc = _run_cli(str(p6), str(p3), "--max-frac-gt-4", "0",
                    cmd="compare")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["max_abs"] == 0.0
