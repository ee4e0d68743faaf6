"""The port's render metrics (``utils/metrics.py``) against the JAX
package's.

Bounds: the wavefront occupancy report's integer counts (rays alive per
bounce, the bounce histogram) equal JAX's exactly, and its ratios to
1e-12; the megakernels' mean path length within 1e-3 of the wavefront's
on three-spheres and triangle-mesh (JAX's own test's bound and scene: the
same RNG stream traces the same segments; on random-spheres' 256 rays one
path on which two renderers part moves the mean by 0.008), and their lane
occupancy in (0, 1].  Two tests hold K2b's plain version to JAX's
recorders, tape for tape, on four rays of the final scene that its
expanded sphere quadratic and its unnormalized dielectric directions
trapped in a glass sphere.  The megakernels' lane occupancy is
the port's warp lane efficiency, not JAX's TPU lane count, so it is not
compared with JAX's.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import functools
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


@functools.lru_cache(maxsize=None)
def _final_scene_rays(ray0, num_rays):
    """Tapes (D, num_rays) of the final scene's ray ids [ray0, ray0 +
    num_rays): K2b's plain version, the port's wavefront ``record_paths``,
    JAX's wavefront ``record_paths`` and JAX's K2b in interpret mode."""
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

    scene, cam, cfg = build_preset("random-spheres", device="cpu")
    key = rng.base_key(0)
    ids = torch.arange(ray0, ray0 + num_rays)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    wave = record_paths(scene, o, d, ids, key, cfg).numpy()
    k2b = record_paths_mega(pack_scene_mega(scene), cam, cfg, key,
                            ray0=ray0, num_rays=num_rays).numpy()
    js, jc, jcfg = jb.build_preset("random-spheres")
    jkey = jrng.base_key(0)
    jids = jnp.arange(ray0, ray0 + num_rays, dtype=jnp.int32)
    jo, jd = jax_rays(jc, jcfg.nx, jcfg.ny, jcfg.spp, jids,
                      jrng.camera_uniforms(jkey, jids))
    jax_wave = np.asarray(jax_record(js, jo, jd, jids, jkey, jcfg))
    jax_mega = np.asarray(jax_k2b(jax_pack(js), jc, jcfg, jkey, ray0=ray0,
                                  num_rays=num_rays, interpret=True))
    return k2b, wave, jax_wave, jax_mega


# Rays of the final scene that the expanded sphere quadratic trapped, with
# the ray range whose tapes one call records (6,037,462 and 6,037,464
# share one).
TRAPPED = {6037462: (6037462, 3), 6037464: (6037462, 3),
           6001449: (6001449, 1)}


@pytest.mark.parametrize("ray", list(TRAPPED))
def test_megakernel_rehit_traps_a_path_the_jax_recorder_ends(ray):
    """The repair of a fault of the port's megakernels (ROADMAP Queue 3,
    item 1) on rays of the final scene at full size.  Each enters glass
    sphere 102 (7.2 from the origin); with the JAX kernels' expanded
    quadratic rounded op by op, K2b's plain version (like K2b on the card)
    then re-hit that sphere at every bounce up to the depth cap.  With the
    sphere root taken in float64 (``mega_common.cuh::sphere_group``),
    K2b's plain version ends each path as JAX's K2b (interpret mode) and
    both wavefront recorders do, after two or four hits."""
    ray0, n = TRAPPED[ray]
    k2b, wave, jax_wave, jax_mega = (t[:, ray - ray0] for t in
                                     _final_scene_rays(ray0, n))
    np.testing.assert_array_equal(jax_wave, jax_mega)
    np.testing.assert_array_equal(wave, jax_mega)
    np.testing.assert_array_equal(k2b, jax_mega)
    hits = int((jax_mega >= 0).sum())
    assert hits in (2, 4) and (jax_mega[:hits] == 102).sum() >= 2


def test_ray_6121526_ends_once_the_dielectric_direction_is_unit():
    """Ray 6,121,526 of the final scene stayed trapped in glass sphere 102
    with the sphere root repaired alone; what trapped it was the port's
    shading, which, as the TPU kernel does, left the dielectric's reflected
    and refracted directions unnormalized, where materials/scatter.py (the
    wavefront recorders', the oracle's) normalizes them.

    The camera ray grazes into the sphere, and on a grazing chord the
    root's error is large (here from |d|^2 = 1 - 1.7e-7, which the root
    takes as 1): the hit point lies 1.7e-4 inside, so the normal there is
    short, and so was the refracted direction.  The root takes |d| = 1, so
    the exit point lay inside the sphere too, and the refraction out at a
    near-critical cosine (0.750 against sqrt(1 - 1/1.5^2) = 0.745) left
    nearly tangent to the surface from below it, met the sphere again from
    inside at a cosine of 0.11 and reflected totally at every bounce to the
    depth cap.  With the direction normalized the exit point lies on the
    surface and the path ends as JAX's K2b (interpret mode) and both
    wavefront recorders end it, after two hits."""
    import torch

    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.kernels import megakernel as mk

    ray = 6121526
    k2b, wave, jax_wave, jax_mega = (t[:, 0] for t in
                                     _final_scene_rays(ray, 1))
    np.testing.assert_array_equal(jax_wave, jax_mega)
    np.testing.assert_array_equal(wave, jax_mega)
    np.testing.assert_array_equal(k2b, jax_mega)
    assert jax_mega[:2].tolist() == [102, 102] and (jax_mega[2:] == -1).all()

    # K2b's plain version's path: how far inside sphere 102 each hit lies,
    # and the cosine of the exit against the critical one.
    scene, cam, cfg = build_preset("random-spheres", device="cpu")
    key = rng.base_key(0)
    pack = mk.pack_scene_mega(scene)
    w = int((pack.spheres[13] == 102).nonzero()[0])
    centre = pack.spheres[0:3, w].double()
    radius, ref_idx = float(pack.spheres[3, w]), float(pack.spheres[4, w])
    ids = torch.tensor([ray])
    o, d = mk._camera_rays(cam, cfg, ids // cfg.spp, ids, key)
    inside, cosines, lengths = [], [], []
    for depth in range(2):
        t, w_s, w_t, is_tri = pack.closest_hit(o, d, cfg.t_min)
        p = o + t[:, None] * d
        off = p[0].double() - centre
        inside.append(radius - float(off.norm()))
        lengths.append(float(d[0].double().norm()))
        cosines.append(abs(float(d[0].double() @ off))
                       / (lengths[-1] * float(off.norm())))
        d = mk._shade(pack, d, p, w_s, w_t, is_tri,
                      rng.bounce_uniforms(key, ids, depth))[0]
        o = p
    assert 1e-4 < inside[0] < 4e-4  # the grazing entry: a short normal
    assert abs(lengths[1] - 1.0) < 1e-6  # the refracted direction is unit
    assert abs(inside[1]) < 1e-5  # so the exit point is on the surface
    critical = np.sqrt(1.0 - 1.0 / ref_idx ** 2)
    assert 0.0 < cosines[1] - critical < 0.005  # a near-critical exit
