"""The port's clustered megakernel (K3's host pack and plain version)
against the JAX package's.

- Packs: ``pack_scene_mega_clustered`` equals JAX's array for array (and in
  every static field) on sphere_field(600), sphere_field(2500), where
  supergroups are active, triangle_field(2000), random-spheres and
  three-spheres, sorted from the camera and unsorted; and again after the
  parameters move, repacked with each package's frozen ``ClusterLayout``.
  The SAH clustering is the JAX package's NumPy, so equality is exact.
- Plain K3 against the port's plain K1: ``atol=1e-6`` on the small presets
  (as tests/test_mega_clustered.py:32-39 holds JAX's pair): both sweep the
  same primitives with the same formulas, and only an exact tie could pick
  another primitive.
- Plain K3 against JAX's ``render_pixels_mega_clustered`` in interpret
  mode, gate modes ``wl`` and ``slab``, path by path: the rays that take
  another way no more than JAX's own kernels part on; where the paths are
  the same, segment totals within 0.1% and the image bound
  ``(|a - b| > 1e-3).mean() < 0.01`` on per-pixel mean radiance; the image
  bound on the whole image but for the far field (test docstring).

The CUDA kernel is held against the plain version by the ``cuda`` tests
(tests/test_torch_cuda.py) and by chip_smoke.py.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff.replay import record_paths as jax_record
from first_raytracer_tpu.kernels import megakernel as jmk
from first_raytracer_tpu.kernels import megakernel_clustered as jmc
from first_raytracer_tpu.kernels.record_mega import (
    record_paths_mega_clustered as jax_record_clustered)
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.kernels import megakernel as tmk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as tmc
from first_raytracer_tpu_torch.kernels import record_mega as trm
from first_raytracer_tpu_torch.render.integrator import RenderConfig

PACK_SCENES = [
    ("sphere-field", dict(n=600)),
    ("sphere-field", dict(n=2500)),
    ("triangle-field", dict(n=2000)),
    ("random-spheres", {}),
    ("three-spheres", {}),
]
ARRAYS = ("sph", "sph_mx", "boxes", "super_boxes", "tris", "tri_boxes",
          "tri_super_boxes")
STATICS = ("super_spans", "tri_super_spans", "clusters", "tri_clusters",
           "sphere_rows", "tri_rows", "has_checker")


def _port(js, jc, cfg):
    return (scene_from_numpy(js.as_numpy()), camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


def _assert_packs_equal(got, want):
    for f in ARRAYS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f == "sph_mx":  # JAX's fields; columns 4-7 are the port's own
            real = a[:, 3] != np.inf  # JAX's sentinel c0
            np.testing.assert_array_equal(a[real, 4:7], a[real, 0:3])
            np.testing.assert_array_equal(a[real, 7],
                                          got.sph[3].numpy()[real])
            assert np.isnan(a[~real, 7]).all()
            a, b = a[:, :4], b[:, :4]
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in STATICS:
        assert getattr(got, f) == getattr(want, f), f


def _scene_id(p):
    name, kw = p
    return name + "".join(f"-{v}" for v in kw.values())


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
@pytest.mark.parametrize("name,kw", PACK_SCENES,
                         ids=[_scene_id(p) for p in PACK_SCENES])
def test_pack_matches_jax(name, kw, sort):
    js, jc, cfg = jb.build_preset(name, nx=8, ny=4, spp=1, **kw)
    ts, tc, _ = _port(js, jc, cfg)
    want = jmc.pack_scene_mega_clustered(
        js, sort_from=jc.origin if sort else None)
    got = (tmc.pack_scene_mega_clustered(ts, tc) if sort
           else tmc._pack(ts, None))
    _assert_packs_equal(got, want)
    # The kernel's index tables restate the spans and the cluster sizes.
    starts = [a for a, _ in got.super_spans] + [got.clusters]
    assert got.sph_starts.tolist() == starts
    assert got.sph_counts.dtype == torch.int32
    assert int(got.sph_counts.sum()) == got.sphere_rows
    assert int(got.tri_counts.sum()) == got.tri_rows
    assert got.tri_starts[-1] == got.tri_clusters


@pytest.mark.parametrize("name,kw", [PACK_SCENES[1], PACK_SCENES[2]],
                         ids=["sphere-field-2500", "triangle-field-2000"])
def test_pack_with_layout_after_parameters_move(name, kw):
    """A repack with the frozen layout equals JAX's repack with its own
    layout, keeps the memberships, and recomputes every box from the moved
    geometry."""
    js, jc, cfg = jb.build_preset(name, nx=8, ny=4, spp=1, **kw)
    ts, tc, _ = _port(js, jc, cfg)
    _, jlay = jmc.pack_scene_mega_clustered(js, sort_from=jc.origin,
                                            return_layout=True)
    first, tlay = tmc.pack_scene_mega_clustered(ts, tc, return_layout=True)
    for f in ("sph_slots", "super_spans", "tri_slots", "tri_super_spans"):
        assert getattr(tlay, f) == getattr(jlay, f), f
    r = np.random.RandomState(4)
    moved = {}
    for f in ("sphere_center", "sphere_radius", "tri_v0", "tri_v1",
              "tri_v2"):
        a = np.asarray(getattr(js, f))
        moved[f] = (a + 0.05 * r.standard_normal(a.shape)).astype(
            np.float32)
    js2 = dataclasses.replace(js, **moved)
    ts2 = dataclasses.replace(ts, **{k: torch.from_numpy(v)
                                     for k, v in moved.items()})
    want = jmc.pack_scene_mega_clustered(js2, sort_from=jc.origin,
                                         layout=jlay)
    got = tmc.pack_scene_mega_clustered(ts2, tc, layout=tlay)
    _assert_packs_equal(got, want)
    assert torch.equal(got.sph_counts, first.sph_counts)
    assert torch.equal(got.tri_counts, first.tri_counts)
    boxes = "boxes" if got.sphere_rows > 3 else "tri_boxes"
    assert not torch.equal(getattr(got, boxes), getattr(first, boxes))


SMALL = [
    ("three-spheres", dict(nx=32, ny=16, spp=4)),
    ("triangle-mesh", dict(nx=32, ny=16, spp=2)),
    ("camera-effects", dict(nx=32, ny=16, spp=4)),
    ("random-spheres", dict(nx=24, ny=12, spp=2)),
]


@pytest.mark.parametrize("name,kw", SMALL, ids=[c[0] for c in SMALL])
def test_plain_k3_equals_plain_k1(name, kw):
    js, jc, cfg = jb.build_preset(name, **kw)
    ts, tc, tcfg = _port(js, jc, cfg)
    dense = tmk.render_image_mega(ts, tc, tcfg, device="cpu")
    clus = tmc.render_image_mega_clustered(ts, tc, tcfg, device="cpu")
    torch.testing.assert_close(clus, dense, rtol=0, atol=1e-6)
    key = trng.base_key(0)
    _, segs = tmk.render_pixels_mega(tmk.pack_scene_mega(ts), tc, tcfg, key)
    pack = tmc.pack_scene_mega_clustered(ts, tc)
    _, csegs, sweeps = tmc.render_pixels_mega_clustered(pack, tc, tcfg, key,
                                                        return_iters=True)
    assert torch.equal(csegs, segs)
    # The plain version's counters are those of an ungated sweep.
    assert sweeps.shape == (tcfg.num_pixels, len(tmc.SWEEP_COLUMNS))
    assert torch.equal(sweeps[:, 1], segs * pack.sphere_rows)
    assert (sweeps[:, 3] == 0).all()


JAX_CASES = [
    ("sphere-field", dict(n=600, nx=64, ny=32, spp=2)),
    ("sphere-field", dict(n=2500, nx=64, ny=32, spp=2)),
    ("random-spheres", dict(nx=64, ny=32, spp=2)),
    ("triangle-field", dict(n=2000, nx=64, ny=36, spp=2)),
]


@functools.lru_cache(maxsize=None)
def _both_k3(case):
    """The scene in both packages; the port's plain K3 render (radiance,
    segments) and plain K3t tape; JAX's wavefront tape of the same rays."""
    name, kw = JAX_CASES[case]
    js, jc, cfg = jb.build_preset(name, **kw)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmc.pack_scene_mega_clustered(ts, tc)
    rad, segs = tmc.render_pixels_mega_clustered(pack, tc, tcfg,
                                                 trng.base_key(0))
    tape = trm.record_paths_mega_clustered(pack, tc, tcfg, trng.base_key(0))
    key = jrng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    wave = np.asarray(jax_record(js, o, d, ids, key, cfg))
    return js, jc, cfg, rad.numpy(), segs.numpy(), tape.numpy(), wave


@pytest.mark.parametrize("gate_mode", ["wl", "slab"])
@pytest.mark.parametrize("case", range(len(JAX_CASES)),
                         ids=[_scene_id((n, {k: v for k, v in kw.items()
                                             if k == "n"}))
                              for n, kw in JAX_CASES])
def test_plain_k3_matches_jax(case, gate_mode):
    """The plain K3 against JAX's clustered kernel, path by path.

    The two packages round the camera ray, the normal and the scatter in
    different orders, so about 1% of paths take another way (3.6% on
    sphere_field(2500), whose camera sits ~40 units out), and a path that
    parts often runs to another length: over the whole image the segment
    totals then differ by a random sum of a few long paths (0.07-0.73% at
    these sizes), which no size that interpret mode can run brings under
    0.1%.  So the paths are compared one by one, through each package's
    clustered recorder (JAX's traces its render's paths):

    - the rays whose tapes differ are at most as many as JAX's own
      clustered and wavefront recorders part on, plus one;
    - JAX's segments come per lane of its band mapping (lane = pixel mod
      512 in one tile); on the lanes all of whose rays record the same
      primitives in both packages, segment totals within 0.1% (measured:
      equal, or one segment apart where a ray is absorbed in one package
      and scatters to the sky in the other), and per-pixel mean radiance
      within the image bound ``(|a - b| > 1e-3).mean() < 0.01`` on their
      pixels (the checker ground moves under a hit point that moved);
    - over the whole image, the image bound, except on sphere_field(2500),
      where JAX's own clustered kernel and its wavefront render differ in
      5.4% of values.
    """
    js, jc, cfg, got, segs, tape, wave = _both_k3(case)
    key = jrng.base_key(0)
    jpack = jmc.pack_scene_mega_clustered(js, sort_from=jc.origin)
    want, jsegs = jmc.render_pixels_mega_clustered(
        jpack, jc, cfg, key, interpret=True, gate_mode=gate_mode)
    want, jsegs = np.asarray(want), np.asarray(jsegs)
    jtape = np.asarray(jax_record_clustered(jpack, jc, cfg, key,
                                            interpret=True,
                                            gate_mode=gate_mode))
    ray_differs = (tape != jtape).any(axis=0)
    spread = int((jtape != wave).any(axis=0).sum())
    assert int(ray_differs.sum()) <= spread + 1, (int(ray_differs.sum()),
                                                  spread)

    P = cfg.num_pixels
    assert jsegs.shape == (jmk.TILE,) and P <= jmk.TILE * jmc.PIX_PER_LANE
    lane = np.arange(P) % jmk.TILE
    px_differs = ray_differs.reshape(P, cfg.spp).any(axis=1)
    lane_differs = np.zeros(jmk.TILE, bool)
    np.logical_or.at(lane_differs, lane, px_differs)
    lane_segs = np.zeros(jmk.TILE, np.int64)
    np.add.at(lane_segs, lane, segs)
    same = ~lane_differs
    total, jtotal = int(lane_segs[same].sum()), int(jsegs[same].sum())
    assert same.mean() > 0.7 and abs(total - jtotal) <= 1e-3 * jtotal, \
        (total, jtotal)
    diff = np.abs(got - want) / cfg.spp
    same_px = same[lane]
    assert (diff[same_px] > 1e-3).mean() < 0.01, float(diff[same_px].max())
    if JAX_CASES[case][1].get("n") != 2500:
        assert (diff > 1e-3).mean() < 0.01, float(diff.max())


def test_cluster_sort_is_a_pure_reordering():
    """Sorting clusters front-to-back changes the column order but, away
    from exact ties, not the image (tests/test_mega_clustered.py:56-72)."""
    js, jc, cfg = jb.sphere_field(n=400, nx=24, ny=12, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    key = trng.base_key(0)
    a, sa = tmc.render_pixels_mega_clustered(
        tmc.pack_scene_mega_clustered(ts, tc),
        tc, tcfg, key)
    b, sb = tmc.render_pixels_mega_clustered(
        tmc._pack(ts, None), tc, tcfg, key)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert torch.equal(sa, sb)


def test_single_type_scenes():
    """A scene without triangles or without spheres packs one sentinel
    cluster with an inverted box for the missing type and renders as the
    dense plain version does."""
    js, jc, cfg = jb.triangle_scene(nx=20, ny=10, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    tris_only = dataclasses.replace(
        ts, sphere_center=ts.sphere_center[:0],
        sphere_radius=ts.sphere_radius[:0], sphere_mat=ts.sphere_mat[:0])
    spheres_only = dataclasses.replace(
        ts, tri_v0=ts.tri_v0[:0], tri_v1=ts.tri_v1[:0],
        tri_v2=ts.tri_v2[:0], tri_mat=ts.tri_mat[:0])
    for scene, missing in ((tris_only, "boxes"),
                           (spheres_only, "tri_boxes")):
        pack = tmc.pack_scene_mega_clustered(scene, tc)
        box = getattr(pack, missing)
        assert box.shape == (1, 8)
        assert (box[0, 0:3] == tmk.BIG).all() and \
            (box[0, 3:6] == -tmk.BIG).all()
        dense = tmk.render_image_mega(scene, tc, tcfg, device="cpu")
        clus = tmc.render_image_mega_clustered(scene, tc, tcfg,
                                               device="cpu")
        diff = (clus - dense).abs()
        assert float((diff > 1e-3).float().mean()) < 0.01


def test_guards_and_devices():
    js, jc, cfg = jb.three_spheres(nx=8, ny=4, spp=1)
    ts, tc, tcfg = _port(js, jc, cfg)
    pack = tmc.pack_scene_mega_clustered(ts, tc)
    key = trng.base_key(0)
    with pytest.raises(ValueError, match="t_min"):
        tmc.render_pixels_mega_clustered(
            pack, tc, dataclasses.replace(tcfg, t_min=0.0), key)
    meta = dataclasses.replace(pack, sph=pack.sph.to("meta"))
    with pytest.raises(ValueError, match="device"):
        tmc.render_pixels_mega_clustered(meta, tc, tcfg, key)
    before = tmc.render_pixels_mega_clustered.launches
    tmc.render_pixels_mega_clustered(pack, tc, tcfg, key)
    assert tmc.render_pixels_mega_clustered.launches == before  # CPU: none
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tmc.render_image_mega_clustered(ts, tc, tcfg)  # "cuda" default
