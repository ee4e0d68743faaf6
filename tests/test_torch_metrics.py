"""The port's render metrics (``utils/metrics.py``) against the JAX
package's.

Bounds: the wavefront occupancy report's integer counts (rays alive per
bounce, the bounce histogram) equal JAX's exactly, and its ratios to
1e-12; the megakernels' mean path length within 1e-3 of the wavefront's
on three-spheres and triangle-mesh (JAX's own test's bound and scene: the
same RNG stream traces the same segments; on random-spheres' 256 rays one
path that the megakernels' expanded sphere quadratic and the wavefront's
oc-form part on moves the mean by 0.008), and their lane occupancy in
(0, 1].  One test shows the megakernels' re-hit fault on a ray of the
final scene, tape for tape against JAX's recorders.  The megakernels' lane occupancy is
the port's warp lane efficiency, not JAX's TPU lane count, so it is not
compared with JAX's.
"""
import logging

import numpy as np
import pytest

from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu.utils.metrics import (
    wavefront_occupancy as jax_wavefront_occupancy)
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.scene.builders import build_preset
from first_raytracer_tpu_torch.utils.metrics import (
    log_metrics, megakernel_clustered_occupancy, megakernel_occupancy,
    wavefront_occupancy)

CASES = {
    "three-spheres": dict(nx=24, ny=12, spp=2),
    "triangle-mesh": dict(nx=16, ny=8, spp=2),
    "random-spheres": dict(nx=16, ny=8, spp=2),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("num_rays", [100, 1 << 14])
def test_wavefront_occupancy_equals_jax(name, num_rays):
    js, jc, jcfg = jb.build_preset(name, **CASES[name])
    want = jax_wavefront_occupancy(js, jc, jcfg, seed=0, num_rays=num_rays)
    scene, cam, cfg = build_preset(name, device="cpu", **CASES[name])
    got = wavefront_occupancy(scene, cam, cfg, seed=0, num_rays=num_rays,
                              device="cpu")
    assert set(got) == set(want)
    for k in ("rays", "alive_per_bounce", "bounce_histogram",
              "alive_frac_per_bounce"):
        assert got[k] == want[k], k
    for k in ("avg_path_length", "wavefront_efficiency"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    counts = np.asarray(got["alive_per_bounce"])
    assert (np.diff(counts) <= 0).all() and counts[0] == got["rays"]
    assert sum(got["bounce_histogram"]) == got["rays"]


def test_wavefront_occupancy_with_jax_scene():
    """The same report on the JAX package's scene and camera, converted."""
    js, jc, jcfg = jb.three_spheres(nx=24, ny=12, spp=2)
    want = jax_wavefront_occupancy(js, jc, jcfg, seed=3)
    got = wavefront_occupancy(scene_from_numpy(js.as_numpy()),
                              camera_from_numpy(jc), jcfg, seed=3,
                              device="cpu")
    assert got["alive_per_bounce"] == want["alive_per_bounce"]


MEGA_CASES = ["three-spheres", "triangle-mesh"]


@pytest.mark.parametrize("name", MEGA_CASES)
def test_megakernel_occupancy_consistent_with_wavefront(name):
    scene, cam, cfg = build_preset(name, device="cpu", **CASES[name])
    wf = wavefront_occupancy(scene, cam, cfg, seed=0,
                             num_rays=cfg.num_rays, device="cpu")
    mk = megakernel_occupancy(scene, cam, cfg, seed=0, device="cpu")
    assert abs(mk["mean_path_len"] - wf["avg_path_length"]) < 1e-3
    assert 0.0 < mk["lane_occupancy"] <= 1.0
    assert mk["segments"] == sum(wf["alive_per_bounce"])
    assert 1 <= mk["tile_trips_mean"] <= mk["tile_trips_max"]


@pytest.mark.parametrize("name", MEGA_CASES)
def test_clustered_megakernel_occupancy_consistent(name):
    scene, cam, cfg = build_preset(name, device="cpu", **CASES[name])
    wf = wavefront_occupancy(scene, cam, cfg, seed=0,
                             num_rays=cfg.num_rays, device="cpu")
    mc = megakernel_clustered_occupancy(scene, cam, cfg, seed=0,
                                        device="cpu")
    assert abs(mc["mean_path_len"] - wf["avg_path_length"]) < 1e-3
    assert 0.0 < mc["lane_occupancy"] <= 1.0
    assert mc["clusters"] >= (1 if scene.num_spheres else 0)
    # The plain version sweeps every cluster of each present type.
    assert mc["sweeps_per_iter"] >= mc["clusters"]


def test_log_metrics_emits_json(caplog):
    with caplog.at_level(logging.INFO, logger="first_raytracer_tpu_torch"):
        log_metrics("tag", {"a": 1})
    assert any("tag" in r.getMessage() and '"a": 1' in r.getMessage()
               for r in caplog.records)


def test_megakernel_rehit_traps_a_path_the_jax_recorder_ends():
    """A fault of the port's megakernels (ROADMAP Queue 3, item 1) on one
    ray of the final scene at full size.  Ray 6,037,462 enters and leaves
    glass sphere 102 (7.2 from the origin); K2b's plain version, like K2b
    on the card, then re-hits that sphere at every bounce up to the depth
    cap, through its expanded sphere quadratic rounded op by op, while the
    port's and JAX's wavefront recorders and JAX's K2b (interpret mode,
    whose compiled quadratic rounds otherwise) end the path after its two
    hits.  Over the whole frame such traps lengthen the megakernels' mean
    path by 1.6e-3 against the wavefront's (``probes/path_length.py``)."""
    import jax.numpy as jnp
    import torch

    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.diff.replay import record_paths as jax_record
    from first_raytracer_tpu.kernels.megakernel import (
        pack_scene_mega as jax_pack)
    from first_raytracer_tpu.kernels.record_mega import (
        record_paths_mega as jax_k2b)
    from first_raytracer_tpu.render.camera import (
        generate_rays as jax_rays)
    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.diff.replay import record_paths
    from first_raytracer_tpu_torch.kernels.megakernel import pack_scene_mega
    from first_raytracer_tpu_torch.kernels.record_mega import (
        record_paths_mega)
    from first_raytracer_tpu_torch.render.camera import generate_rays

    ray = 6037462
    scene, cam, cfg = build_preset("random-spheres", device="cpu")
    key = rng.base_key(0)
    ids = torch.tensor([ray])
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    wave = record_paths(scene, o, d, ids, key, cfg).numpy()[:, 0]
    k2b = record_paths_mega(pack_scene_mega(scene), cam, cfg, key,
                            ray0=ray, num_rays=1).numpy()[:, 0]
    js, jc, jcfg = jb.build_preset("random-spheres")
    jkey, jids = jrng.base_key(0), jnp.array([ray])
    jo, jd = jax_rays(jc, jcfg.nx, jcfg.ny, jcfg.spp, jids,
                      jrng.camera_uniforms(jkey, jids))
    jax_wave = np.asarray(jax_record(js, jo, jd, jids, jkey, jcfg))[:, 0]
    jax_mega = np.asarray(jax_k2b(jax_pack(js), jc, jcfg, jkey, ray0=ray,
                                  num_rays=1, interpret=True))[:, 0]
    ended = np.full(cfg.max_depth + 1, -1)
    ended[:2] = 102
    np.testing.assert_array_equal(wave, ended)
    np.testing.assert_array_equal(jax_wave, ended)
    np.testing.assert_array_equal(jax_mega, ended)
    np.testing.assert_array_equal(k2b, np.full(cfg.max_depth + 1, 102))
