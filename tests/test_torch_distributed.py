"""Two real processes through the port's distributed path: the six steps
of ``first_raytracer_tpu_torch.parallel.dryrun`` (the twin of the JAX
package's ``dryrun_multichip``) on a gloo group of two CPU processes,
started as ``torchrun`` starts them, against single-process renders.

Bounds: the assembled wavefront image equal to the single-process render
at ``atol=1e-6`` (tests/test_distributed.py's bound; measured: bit-equal)
and within the image bound of JAX's ``render_image``; both processes
assemble identical images; the sharded megakernels bit-equal to the
unsharded ones; the ring within tests/test_ring.py's bound of the
replicated render; gradients within ``rtol=1e-4, atol=1e-7`` of the
single-process ones; the command line's ``render`` under two processes
equal to its single-process image.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import os

import numpy as np
import pytest
import torch

import torch_dist_worker
from first_raytracer_tpu.render.api import render_image as jax_render
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import grad as dg
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
from first_raytracer_tpu_torch.kernels.record_mega import (pack_scene_mega,
                                                           record_paths_mega)
from first_raytracer_tpu_torch.parallel import dryrun
from first_raytracer_tpu_torch.render import image as timg
from first_raytracer_tpu_torch.render.api import render_image
from test_torch_integrator import assert_images_close


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_dist_worker.launch(
        2, ["-m", "first_raytracer_tpu_torch.parallel.dryrun", "--size",
            "small", "--device", "cpu"],
        str(tmp_path_factory.mktemp("dryrun")))


def _build(step):
    return dryrun.build(step, "small", torch.device("cpu"))


def test_both_processes_agree(ranks):
    """Every rank holds the same images, losses and gradients (its tape
    and its ring ids are those of its own block of rays, and the seconds
    of its timed frames and gathers its own)."""
    a, b = ranks
    for k in a:
        if k not in ("info", "train_tape", "replay_tape", "ring_gid",
                     "mega_s",
                     "mega_gather_s", "clustered_s", "clustered_gather_s"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_process_render_matches_single_process(ranks):
    scene, cam, cfg = _build("wavefront")
    accel = ip.pack_scene_pallas(scene)
    ref = render_image(scene, cam, cfg, accel=accel, device="cpu").numpy()
    js, jc, jcfg = jb.three_spheres(nx=24, ny=12, spp=2)
    want = np.asarray(jax_render(js, jc, jcfg, seed=0))
    for r in ranks:
        np.testing.assert_allclose(r["wavefront_tiles"], ref, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(r["wavefront_spp"], ref, rtol=0,
                                   atol=1e-6)
        assert_images_close(r["wavefront_tiles"], want)


def test_two_process_megakernels_bit_equal(ranks):
    scene, cam, cfg = _build("mega")
    whole = mk.render_image_mega(scene, cam, cfg, device="cpu").numpy()
    scene, cam, cfg = _build("clustered")
    whole_c = mc.render_image_mega_clustered(scene, cam, cfg,
                                             device="cpu").numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["mega"], whole)
        np.testing.assert_array_equal(r["clustered"], whole_c)


def test_two_process_ring(ranks):
    scene, cam, cfg = _build("ring")
    ref = render_image(scene, cam, cfg, device="cpu").numpy()
    for r in ranks:
        np.testing.assert_allclose(r["ring"], ref, rtol=0, atol=1e-5)
        assert np.abs(r["ring"] - ref).mean() < 1e-7


def test_two_process_training_step(ranks):
    """The sharded direct step's loss and gradients equal the
    single-process ones, and the SGD update with them; each rank's tape is
    its half of the single-process tape."""
    scene, cam, cfg = _build("train")
    cfg = dataclasses.replace(cfg, differentiable=True)
    params, _ = dg.split_params(scene, fields=dryrun.TRAIN_FIELDS)
    ids = torch.arange(cfg.num_rays)
    loss, grads = dg.render_loss_and_grads(
        params, scene, cam, cfg, rng.base_key(0), ids,
        torch.zeros((cfg.num_rays, 3)))
    np.testing.assert_array_equal(
        np.concatenate([r["train_tape"] for r in ranks], axis=1),
        dg.record_tape(params, scene, cam, cfg, rng.base_key(0),
                       ids).numpy())
    for r in ranks:
        np.testing.assert_allclose(r["train_loss"], float(loss), rtol=1e-4,
                                   atol=1e-7)
        for k, g in grads.items():
            np.testing.assert_allclose(r[f"train_grad_{k}"], g.numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(
                r[f"train_param_{k}"],
                (params[k] - 0.05 * g).detach().numpy(), rtol=1e-4,
                atol=1e-7, err_msg=k)


def test_two_process_replay_step(ranks):
    """Each rank's tape is its half of the single-process tape; the summed
    loss and gradients equal the single-process bucketed step's."""
    scene, cam, cfg = _build("replay")
    key = rng.base_key(0)
    tape = record_paths_mega(pack_scene_mega(scene), cam, cfg, key)
    params, _ = dg.split_params(scene)
    loss, grads = dg.render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, torch.arange(cfg.num_rays),
        torch.zeros((cfg.num_rays, 3)), tape)
    np.testing.assert_array_equal(
        np.concatenate([r["replay_tape"] for r in ranks], axis=1),
        tape.numpy())
    for r in ranks:
        np.testing.assert_allclose(r["replay_loss"], float(loss), rtol=1e-4,
                                   atol=1e-7)
        for k, g in grads.items():
            np.testing.assert_allclose(r[f"replay_grad_{k}"], g.numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)


def test_info_names_the_transport(ranks):
    import json

    for i, r in enumerate(ranks):
        info = json.loads(str(r["info"]))
        assert info["rank"] == i and info["world"] == 2
        assert info["transports"] == ["gloo on cpu tensors"]
        # The plain versions ran: no kernel launched on the CPU, and no
        # graph was captured or replayed there.
        assert all(not any(c.values()) for c in info["launches"].values())
        assert all(not any(g.values()) for g in info["graphs"].values())
        assert {"train", "replay"} <= set(info["graphs"])


@pytest.mark.parametrize("mode", ["mega", "wavefront", "ring"])
def test_cli_render_in_two_processes(tmp_path, mode):
    """``cli render`` under two ranks: rank 0 writes the image, equal to
    the single-process command's."""
    args = ["-m", "first_raytracer_tpu_torch.cli", "render", "--device",
            "cpu", "--preset", "three-spheres", "--nx", "24", "--ny", "12",
            "--spp", "2", "--mode", mode]
    out = tmp_path / "two.png"
    torch_dist_worker.launch(2, args + ["--out", str(out)])
    scene, cam, cfg = _build("wavefront")
    want = (mk.render_image_mega(scene, cam, cfg, device="cpu")
            if mode == "mega" else render_image(scene, cam, cfg,
                                                device="cpu"))
    np.testing.assert_array_equal(timg.read_png(str(out)),
                                  timg.to_uint8(want))
    assert sorted(os.listdir(tmp_path)) == ["two.png"]
