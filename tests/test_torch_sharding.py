"""The port's sharded renders and gradients (``parallel/mesh.py``,
``parallel/shard.py`` and the sharded megakernel entry points) against the
JAX package's on its 8 virtual CPU devices.

One 4-rank gloo group per module (``torch_dist_worker.py``) runs every
case as layouts (4, 1), (2, 2) and (1, 4); (1, 1) runs here without a
group.  Bounds:
- wavefront renders: the image bound of tests/test_torch_integrator.py
  (``(|a - b| > 1e-3).mean() < 0.01``, median < 1e-5) against JAX's
  ``render_image_sharded`` on the same layout; a split of pixels alone is
  bit-equal to the port's single-process ``render_image``;
- gradients: ``rtol=1e-4, atol=1e-7`` against JAX's single-device
  ``jax.grad(render_loss)`` (JAX's own bound, tests/test_sharding.py);
- the sharded megakernels' plain versions: bit-equal to the port's
  unsharded renders, and the image bound against JAX's sharded
  megakernels in interpret mode.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff.grad import render_loss as jax_render_loss
from first_raytracer_tpu.diff.grad import split_params as jax_split
from first_raytracer_tpu.kernels.megakernel import (
    render_image_mega_sharded as jax_mega_sharded)
from first_raytracer_tpu.kernels.megakernel_clustered import (
    render_image_mega_clustered_sharded as jax_clustered_sharded)
from first_raytracer_tpu.parallel.mesh import make_render_mesh as jax_mesh
from first_raytracer_tpu.parallel.shard import (
    render_image_sharded as jax_sharded)
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import grad as dg
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
from first_raytracer_tpu_torch.parallel import shard
from first_raytracer_tpu_torch.parallel.mesh import (make_render_mesh,
                                                     TILE_AXIS, SPP_AXIS)
from first_raytracer_tpu_torch.render.api import render_image
from first_raytracer_tpu_torch.scene.builders import build_preset
from test_torch_integrator import assert_images_close

LAYOUTS = [(4, 1), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The sharding suite's results on each of 4 gloo ranks."""
    return torch_dist_worker.launch(
        4, ["sharding"], str(tmp_path_factory.mktemp("sharding")))


def _three(**kw):
    return build_preset("three-spheres", device="cpu", **kw)


@pytest.fixture(scope="module")
def single():
    """The port's single-process render of three-spheres 16x8 @ 4."""
    scene, cam, cfg = _three(nx=16, ny=8, spp=4)
    return render_image(scene, cam, cfg, device="cpu").numpy()


def _jax_devices(n):
    assert len(jax.devices()) >= n
    return jax.devices()[:n]


@pytest.mark.parametrize("tiles,spp", LAYOUTS + [(1, 1)])
def test_sharded_render_matches_jax(ranks, single, tiles, spp):
    """Every rank assembles the whole image: within the image bound of
    JAX's ``render_image_sharded`` on the same layout, and bit-equal to
    the single-process render where only pixels are split."""
    js, jc, jcfg = jb.three_spheres(nx=16, ny=8, spp=4)
    want = np.asarray(jax_sharded(
        js, jc, jcfg, jax_mesh(tiles, spp, devices=_jax_devices(tiles * spp)),
        seed=0))
    if (tiles, spp) == (1, 1):
        scene, cam, cfg = _three(nx=16, ny=8, spp=4)
        mesh = make_render_mesh(1, 1)
        assert mesh.world.group is None and mesh.size == 1
        imgs = [shard.render_image_sharded(scene, cam, cfg, mesh,
                                           device="cpu").numpy()]
    else:
        imgs = [r[f"shard_{tiles}x{spp}"] for r in ranks]
    for img in imgs:
        assert img.shape == (8, 16, 3)
        assert_images_close(img, want)
        np.testing.assert_array_equal(img, imgs[0])
        if spp == 1:
            np.testing.assert_array_equal(img, single)
        else:  # another summation order
            np.testing.assert_allclose(img, single, rtol=0, atol=2e-6)


def test_auto_matches(ranks, single):
    """``render_image_auto`` on a (2, 2) mesh: the tiles-only program,
    bit-equal to the single-process render."""
    for r in ranks:
        np.testing.assert_array_equal(r["auto"], single)


def test_indivisible_shapes_rejected(ranks):
    """9 pixels over 4 tile shards and 3 samples over 2 spp shards raise
    ``ValueError`` before any collective, as in JAX."""
    for r in ranks:
        assert r["rejected"].tolist() == [True, True]
    with pytest.raises(ValueError):
        make_render_mesh(2, 1)  # no group: one rank


def test_mesh_without_a_group():
    mesh = make_render_mesh()
    assert (mesh.tiles, mesh.spp, mesh.rank) == (1, 1, 0)
    assert mesh.shape == {TILE_AXIS: 1, SPP_AXIS: 1}
    t = torch.arange(6.0).reshape(3, 2)
    for axis in (mesh.tiles_axis, mesh.spp_axis, mesh.world):
        assert axis.all_reduce(t) is t and axis.all_gather(t) is t
        assert axis.ring_shift(t) is t and not axis.transports


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's single-device loss and gradients of the albedo and fuzz on
    three_spheres 16x8 @ 2, zero target (tests/test_sharding.py's
    configuration)."""
    js, jc, cfg = jb.three_spheres(nx=16, ny=8, spp=2)
    params, _ = jax_split(js, fields=("albedo", "fuzz"))
    loss, grads = jax.value_and_grad(jax_render_loss)(
        params, js, jc, cfg, jrng.base_key(0),
        jnp.arange(cfg.num_rays, dtype=jnp.int32),
        jnp.zeros((cfg.num_rays, 3), jnp.float32))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("kind", ["autograd", "replay"])
def test_sharded_grads_match_jax(ranks, jax_grads, kind):
    """The loss and the gradients summed over the ranks, on every rank,
    against JAX's single-device ones (albedo and fuzz, JAX's own test's
    fields): the wavefront autograd path on a (4, 1) mesh, and the
    record->replay path (each rank's block recorded by K2b's plain
    version, then planned and replayed) on a (2, 2) mesh."""
    prefix = "grad" if kind == "autograd" else "replay"
    want_loss, want = jax_grads
    for r in ranks:
        np.testing.assert_allclose(r[f"{prefix}_loss"], want_loss,
                                   rtol=1e-4, atol=1e-7)
        for k, w in want.items():
            np.testing.assert_allclose(r[f"{prefix}_{k}"], w, rtol=1e-4,
                                       atol=1e-7, err_msg=k)


def test_sharded_replay_grads_match_single_process(ranks):
    """Every field of the sharded record->replay gradient equals the
    port's single-process ``render_loss_and_grads_bucketed`` (one tape of
    every ray) within ``rtol=1e-4, atol=1e-7``, and is the same on every
    rank: the ranks' partial sums differ from the whole sum only in their
    order."""
    from first_raytracer_tpu_torch.kernels.record_mega import (
        pack_scene_mega, record_paths_mega)

    scene, cam, cfg = _three(nx=16, ny=8, spp=2)
    key = rng.base_key(0)
    params, _ = dg.split_params(scene)
    tape = record_paths_mega(pack_scene_mega(scene), cam, cfg, key)
    loss, grads = dg.render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, torch.arange(cfg.num_rays),
        torch.zeros((cfg.num_rays, 3)), tape)
    for r in ranks:
        np.testing.assert_allclose(r["replay_loss"], float(loss), rtol=1e-4,
                                   atol=1e-7)
        for k, g in grads.items():
            np.testing.assert_allclose(r[f"replay_{k}"], g.numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
            np.testing.assert_array_equal(r[f"replay_{k}"],
                                          ranks[0][f"replay_{k}"])


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    """The sharded direct step's results on each of 2 gloo ranks."""
    return torch_dist_worker.launch(
        2, ["step"], str(tmp_path_factory.mktemp("step")))


@pytest.mark.parametrize("method", ["replay", "scan"])
def test_sharded_step_matches_single_process(step_ranks, method):
    """``render_loss_and_grads_sharded`` on 2 ranks (each rank's block
    through the replay's or the scan's graph body, over the whole batch's
    count, then summed over the ranks) against one process's
    ``render_loss_and_grads`` with the same ``method``: every
    ``DIFF_FIELDS`` gradient of three-spheres 16x8 @ 2 at depth 8 within
    ``rtol=1e-4, atol=1e-7``, the same on both ranks; the ranks' tapes
    concatenated equal one process's."""
    scene, cam, cfg = _three(nx=16, ny=8, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=8)
    key, ids = rng.base_key(0), torch.arange(cfg.num_rays)
    target = torch.from_numpy(np.random.RandomState(0).rand(
        cfg.num_rays, 3).astype(np.float32))
    params, _ = dg.split_params(scene)
    loss, grads = dg.render_loss_and_grads(params, scene, cam, cfg, key,
                                           ids, target, method=method)
    for r in step_ranks:
        np.testing.assert_allclose(r[f"{method}_loss"], float(loss),
                                   rtol=1e-4, atol=1e-7)
        for k, g in grads.items():
            np.testing.assert_allclose(r[f"{method}_{k}"], g.numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=k)
            np.testing.assert_array_equal(r[f"{method}_{k}"],
                                          step_ranks[0][f"{method}_{k}"])
    assert float(grads["albedo"].abs().max()) > 0.0
    if method == "replay":
        tape = dg.record_tape(params, scene, cam, cfg, key, ids)
        np.testing.assert_array_equal(
            np.concatenate([r["replay_tape"] for r in step_ranks], axis=1),
            tape.numpy())


def test_sharded_fit_step_keeps_ranks_equal(ranks):
    """Two SGD steps of ``make_fit_step_replay`` on a mesh leave identical
    parameters on every rank, equal to the single-process
    step's (no mesh) within the gradient bound."""
    scene, cam, cfg = _three(nx=16, ny=8, spp=2)
    params, _ = dg.split_params(scene, fields=("albedo",))
    step = dg.make_fit_step_replay(
        scene, cam, cfg, torch.arange(cfg.num_rays),
        torch.zeros((cfg.num_rays, 3)),
        torch.optim.SGD(params.values(), lr=0.1), device="cpu")
    losses = [float(step(params, rng.base_key(0))) for _ in range(2)]
    for r in ranks:
        np.testing.assert_array_equal(r["fit_albedo"],
                                      ranks[0]["fit_albedo"])
        np.testing.assert_allclose(r["fit_loss"], losses, rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(r["fit_albedo"],
                                   params["albedo"].detach().numpy(),
                                   rtol=1e-4, atol=1e-7)
    assert losses[1] < losses[0]


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_sharded_megakernel_matches(ranks, layout):
    """``render_image_mega_sharded`` (K1's plain version over each rank's
    pixel range): bit-equal to ``render_image_mega`` on every rank, and
    within the image bound of JAX's in interpret mode."""
    scene, cam, cfg = _three(nx=16, ny=8, spp=4)
    whole = mk.render_image_mega(scene, cam, cfg, device="cpu").numpy()
    js, jc, jcfg = jb.three_spheres(nx=16, ny=8, spp=4)
    tiles = int(layout[0])
    want = np.asarray(jax_mega_sharded(
        js, jc, jcfg, jax_mesh(tiles, 1, devices=_jax_devices(tiles)),
        interpret=True, tile=128, k_pix=2))
    for r in ranks:
        np.testing.assert_array_equal(r[f"mega_{layout}"], whole)
        assert_images_close(r[f"mega_{layout}"], want)


def test_sharded_clustered_megakernel_matches(ranks):
    """``render_image_mega_clustered_sharded`` on triangle-mesh 16x8 @ 2,
    depth 8 (K3's plain version over each rank's pixel range): bit-equal
    to ``render_image_mega_clustered``, and within the image bound of
    JAX's sharded clustered megakernel in interpret mode."""
    scene, cam, cfg = build_preset("triangle-mesh", device="cpu", nx=16,
                                   ny=8, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=8)
    whole = mc.render_image_mega_clustered(scene, cam, cfg,
                                           device="cpu").numpy()
    js, jc, jcfg = jb.triangle_scene(nx=16, ny=8, spp=2)
    jcfg = dataclasses.replace(jcfg, max_depth=8)
    want = np.asarray(jax_clustered_sharded(
        js, jc, jcfg, jax_mesh(4, 1, devices=_jax_devices(4)),
        interpret=True, tile=128, k_pix=2))
    for r in ranks:
        np.testing.assert_array_equal(r["clustered"], whole)
        assert_images_close(r["clustered"], want)


@pytest.mark.parametrize("parts", [2, 3, 4])
def test_clustered_plain_pixel_ranges_equal_whole_frame(parts):
    """K3's plain version over ``parts`` pixel ranges of ceil(P / parts)
    (the last past the image), concatenated: bit-equal to the whole
    frame."""
    scene, cam, cfg = build_preset("random-spheres", device="cpu", nx=12,
                                   ny=8, spp=2)
    pack = mc.pack_scene_mega_clustered(scene, cam)
    key = rng.base_key(0)
    whole, whole_segs = mc.render_pixels_mega_clustered(pack, cam, cfg, key)
    P = cfg.num_pixels
    per = -(-P // parts)
    pieces = [mc.render_pixels_mega_clustered(pack, cam, cfg, key,
                                              pix0=i * per, num_pixels=per)
              for i in range(parts)]
    rad = torch.cat([p[0] for p in pieces])[:P]
    segs = torch.cat([p[1] for p in pieces])[:P]
    assert torch.equal(rad, whole) and torch.equal(segs, whole_segs)


def test_replay_gradient_does_not_depend_on_the_split():
    """The record->replay gradient of the final scene's first 2^16 rays,
    as one step and as two halves summed (a two-rank sharded step without
    the collective), within ``rtol=1e-4, atol=1e-7``.  The replay's gather
    of payload rows sums its backward in float64: summed in float32, the
    ground sphere's hundred thousand reads moved its albedo gradient by
    2e-4 between the two groupings here (3e-4 at 2^17 rays)."""
    from first_raytracer_tpu_torch.kernels.record_mega import (
        pack_scene_mega, record_paths_mega)

    scene, cam, cfg = build_preset("random-spheres", device="cpu")
    rays, key = 1 << 16, rng.base_key(0)
    tape = record_paths_mega(pack_scene_mega(scene), cam, cfg, key,
                             num_rays=rays)
    ids, target = torch.arange(rays), torch.zeros((rays, 3))
    params, _ = dg.split_params(scene)
    loss, grads = dg.render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, ids, target, tape)
    h = rays // 2
    halves = [dg.render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, ids[a:a + h], target[a:a + h],
        tape[:, a:a + h], num_values=rays * 3) for a in (0, h)]
    np.testing.assert_allclose(float(halves[0][0] + halves[1][0]),
                               float(loss), rtol=1e-4, atol=1e-7)
    for k, g in grads.items():
        np.testing.assert_allclose(
            (halves[0][1][k] + halves[1][1][k]).numpy(), g.numpy(),
            rtol=1e-4, atol=1e-7, err_msg=k)
