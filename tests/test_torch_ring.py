"""The port's ring-sharded scene (``parallel/ring.py``) against the JAX
package's ``render_image_ring`` on its virtual CPU devices, and against
the port's replicated render.

One 4-rank gloo group per module (``torch_dist_worker.py``) runs the ring
on a (4, 1) mesh, and on a (2, 2) one (the geometry split over the tile
axis, repeated on the spp axis).  Bounds: against the port's replicated
render, those of tests/test_ring.py (the radiance within ``atol=1e-5``, a
mean difference below 1e-7; measured: equal); against JAX's ring, the
image bound of tests/test_torch_integrator.py, which holds the port's
integrator to JAX's (``(|a - b| > 1e-3).mean() < 0.01``, median < 1e-5);
the selection (the global id of each ray's closest hit) equal to the
replicated sweep's.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker
from first_raytracer_tpu.parallel.mesh import make_render_mesh as jax_mesh
from first_raytracer_tpu.parallel.ring import (
    render_image_ring as jax_ring)
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.parallel.ring import (pad_scene_ring,
                                                     render_image_ring)
from first_raytracer_tpu_torch.parallel.mesh import make_render_mesh
from first_raytracer_tpu_torch.render.api import render_image
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.render.integrator import (intersect_brute,
                                                         trace_rays)
from first_raytracer_tpu_torch.scene.builders import build_preset
from test_torch_integrator import assert_images_close


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ring suite's results on each of 4 gloo ranks."""
    return torch_dist_worker.launch(4, ["ring"],
                                    str(tmp_path_factory.mktemp("ring")))


def _assert_ulp_close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert np.abs(out - ref).mean() < 1e-7


def _dup(scene, cat):
    return dataclasses.replace(
        scene, sphere_center=cat([scene.sphere_center] * 2),
        sphere_radius=cat([scene.sphere_radius] * 2),
        sphere_mat=cat([scene.sphere_mat] * 2))


# case: (preset, builder arguments, duplicated spheres, JAX mesh)
CASES = {
    "three": ("three-spheres", dict(nx=40, ny=20, spp=2), False, (4, 1)),
    "mixed": ("triangle-mesh", dict(nx=40, ny=24, spp=2), False, (4, 1)),
    "dup": ("three-spheres", dict(nx=40, ny=20, spp=1), True, (4, 1)),
    "mesh22": ("three-spheres", dict(nx=40, ny=20, spp=2), False, (2, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax_and_replicated(ranks, case):
    """three-spheres, the mixed triangle preset (global ids across both
    primitive kinds), duplicated spheres in different shards (the lower
    global id wins every tie) and a (2, 2) mesh: every rank's image within
    the bound of JAX's ring render and of the port's replicated render."""
    preset, kw, dup, layout = CASES[case]
    js, jc, jcfg = jb.build_preset(preset, **kw)
    scene, cam, cfg = build_preset(preset, device="cpu", **kw)
    if dup:
        js, scene = _dup(js, jnp.concatenate), _dup(scene, torch.cat)
    want = np.asarray(jax_ring(js, jc, jcfg, jax_mesh(
        *layout, devices=jax.devices()[:layout[0] * layout[1]]), seed=0))
    ref = render_image(scene, cam, cfg, device="cpu").numpy()
    for r in ranks:
        assert r[case].shape == ref.shape
        assert_images_close(r[case], want)
        _assert_ulp_close(r[case], ref)
        np.testing.assert_array_equal(r[case], ranks[0][case])


def test_ring_selection_equals_replicated(ranks):
    """Each rank's camera rays of triangle-mesh 40x24 @ 2: the ring's
    global ids of the padded scene, mapped back to the scene's ids,
    equal the replicated sweep's winners, misses included."""
    scene, cam, cfg = build_preset("triangle-mesh", device="cpu", nx=40,
                                   ny=24, spp=2)
    key = rng.base_key(0)
    ids = torch.arange(cfg.num_rays)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    prim, _, hit = intersect_brute(scene, o, d, cfg.t_min)
    gid = np.concatenate([r["gid"] for r in ranks]).astype(np.int64)
    ns, ns_total = scene.num_spheres, int(ranks[0]["ns_total"])
    got = np.where(gid >= ns_total, gid - ns_total + ns, gid)
    want = np.where(hit.numpy(), prim.numpy(), np.iinfo(np.int32).max)
    np.testing.assert_array_equal(np.where(hit.numpy(), got, want), want)
    assert (gid[~hit.numpy()] == np.iinfo(np.int32).max).all()
    assert hit.any() and (~hit).any()


def test_ring_sync_with_a_rank_of_misses(ranks):
    """Rank 0's rays all miss at the first bounce (straight up from above
    the scene) while the others bounce on: the alive count's all-reduce
    keeps every rank in the same passes (no deadlock), rank 0 gets the
    sky, and each other rank's radiance and segments equal the
    replicated trace of its rays."""
    scene, cam, cfg = build_preset("three-spheres", device="cpu", nx=40,
                                   ny=20, spp=2)
    key = rng.base_key(0)
    for i, r in enumerate(ranks):
        o, d = torch.from_numpy(r["sync_o"]), torch.from_numpy(r["sync_d"])
        ids = torch.arange(i * 64, (i + 1) * 64)
        rad, segs = trace_rays(scene, o, d, ids, key, cfg,
                               return_stats=True)
        if i == 0:
            assert (r["sync_segs"] == 1).all()
        else:
            assert (r["sync_segs"] > 1).any()
        np.testing.assert_array_equal(r["sync_segs"], segs.numpy())
        _assert_ulp_close(r["sync_rad"], rad.numpy())


def test_pad_scene_sentinels_never_hit():
    """Sentinel spheres (radius 0 at 1e30) and degenerate triangles pad
    the scene to 8 shards without changing the image, as in JAX's test."""
    scene, cam, cfg = build_preset("three-spheres", device="cpu", nx=40,
                                   ny=20, spp=2)
    padded = pad_scene_ring(scene, 8)
    assert padded.num_spheres % 8 == 0 and padded.num_triangles == 8
    np.testing.assert_array_equal(
        render_image(padded, cam, cfg, device="cpu").numpy(),
        render_image(scene, cam, cfg, device="cpu").numpy())


def test_ring_in_one_process():
    """Without a process group the ring is one hop over the whole padded
    scene: the replicated render's image within the bound."""
    scene, cam, cfg = build_preset("triangle-mesh", device="cpu", nx=16,
                                   ny=8, spp=2)
    out = render_image_ring(scene, cam, cfg, make_render_mesh(),
                            device="cpu").numpy()
    _assert_ulp_close(out, render_image(scene, cam, cfg,
                                        device="cpu").numpy())
