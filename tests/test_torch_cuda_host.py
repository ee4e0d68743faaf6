"""The CUDA sources of the port, compiled by g++ for the host, against their
plain PyTorch versions on the CPU.

``first_raytracer_tpu_torch/kernels/host_emu`` builds ``kernels/csrc``
with a stand-in for ``cuda_runtime.h``: each CUDA thread of a block runs on
a thread of its own, ``__syncthreads`` and the warp collectives are
barriers, cp.async a synchronous copy, and ``-ffp-contract=off`` rounds as
``nvcc --fmad=false`` does.  The wrappers' own launch code drives the
library (``megakernel.launch_entry`` is pointed at it), so these tests run
K1, K2, K2b, K3, K3t, K4 and K5 as the card runs them, on CPU tensors, and
hold each bit for bit to its plain version: radiance, segments, tapes,
trip counts, hits and t.  They skip only where there is no g++.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import shutil

import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
from first_raytracer_tpu_torch.kernels import record_mega as rm
from first_raytracer_tpu_torch.render.camera import generate_rays, make_camera
from first_raytracer_tpu_torch.render.integrator import RenderConfig
from first_raytracer_tpu_torch.scene.builders import build_preset
from first_raytracer_tpu_torch.scene.soa import SceneBuilder

KEY = rng.base_key(0)
# (preset, builder arguments, max_depth or None); small enough that a
# thread a CUDA thread stays quick.
DENSE = {
    "three-spheres": (dict(nx=16, ny=8, spp=3), None),
    "triangle-mesh": (dict(nx=12, ny=8, spp=2), 8),
    "camera-effects": (dict(nx=16, ny=8, spp=2), None),
    "random-spheres": (dict(nx=12, ny=8, spp=2), None),
    # 20 samples: two chunks of the warp's store (kMaxChunk = 16).
    "three-spheres-spp20": (dict(nx=6, ny=4, spp=20), None),
    # 1100 spheres: past the block's staged 1024, the rest from memory.
    "sphere-field-1100": (dict(n=1100, nx=8, ny=4, spp=1), 8),
    # A far field (camera ~40 units out), where the sphere root's float
    # prefilter and its float64 b and c both matter.
    "sphere-field-2500": (dict(n=2500, nx=8, ny=4, spp=2), 8),
    # Exact ties, which the warp's split sweep must give to the lowest
    # column (exact_ties below).
    "exact-ties": (None, None),
}
CLUSTERED = {
    "three-spheres": (dict(nx=16, ny=8, spp=2), None),
    "random-spheres": (dict(nx=12, ny=8, spp=2), None),
    "triangle-mesh": (dict(nx=12, ny=8, spp=2), 8),
    "sphere-field-600": (dict(n=600, nx=16, ny=8, spp=2), 8),
    "triangle-field-2000": (dict(n=2000, nx=16, ny=8, spp=1), 8),
    "sphere-field-5000": (dict(n=5000, nx=16, ny=8, spp=1), 8),
}

# The recorders (K2b, K3t) over ray ranges other than their cases' default
# (ray ids 5 to num_rays - 5): case -> (scene, builder
# arguments replacing the table's or None, ray0, number of rays).  Fewer
# rays than a warp; a count that is not a multiple of 32 from an odd ray0;
# more rays than the emulated card's resident lanes (2 SMs x 2 blocks x 128),
# so that the warps regenerate; the exact-tie scene.
RECORD_RANGES = {
    "three-spheres-13-rays": ("three-spheres", None, 3, 13),
    "random-spheres-37+155": ("random-spheres", None, 37, 155),
    "random-spheres-past-grid": ("random-spheres",
                                 dict(nx=32, ny=20, spp=2), 11, 1260),
    "exact-ties-13-rays": ("exact-ties", None, 7, 13),
    "exact-ties": ("exact-ties", None, 0, 256),
}
CLUSTERED_RANGES = {
    "three-spheres-13-rays": ("three-spheres", None, 3, 13),
    "sphere-field-600-37+155": ("sphere-field-600", None, 37, 155),
    "random-spheres-past-grid": ("random-spheres",
                                 dict(nx=32, ny=20, spp=2), 11, 1260),
    "exact-ties": ("exact-ties", None, 0, 256),
}


def exact_ties():
    """A dense scene whose closest hits tie exactly: sphere 6 coincides
    with sphere 1 (four lambertian spheres between them, so that the two
    fall in different groups of four, on different lanes of a split
    sweep), and each of the back wall's two triangles is there twice, in
    neighbouring columns.  Every tie must go to the lowest column: the
    first copy's id on the tape."""
    b = SceneBuilder()
    m_ground = b.lambertian((0.8, 0.8, 0.0))
    m_center = b.lambertian((0.1, 0.2, 0.5))
    m_twin = b.lambertian((0.7, 0.1, 0.1))
    m_metal = b.metal((0.8, 0.6, 0.2), fuzz=0.1)
    m_glass = b.dielectric(1.5)
    m_wall = b.lambertian((0.6, 0.6, 0.6))
    b.sphere((0.0, -100.5, -1.0), 100.0, m_ground)
    b.sphere((0.0, 0.0, -1.0), 0.5, m_center)
    for x in (-2.2, -1.6, 1.6, 2.2):
        b.sphere((x, 0.8, -2.0), 0.25, m_center)
    b.sphere((0.0, 0.0, -1.0), 0.5, m_twin)  # sphere 1's twin
    b.sphere((1.0, 0.0, -1.0), 0.5, m_metal)
    b.sphere((-1.0, 0.0, -1.0), 0.5, m_glass)
    quad = [((-4, -1, -3), (4, -1, -3), (4, 3, -3)),
            ((-4, -1, -3), (4, 3, -3), (-4, 3, -3))]
    for tri in quad:
        b.triangle(*tri, m_wall)
        b.triangle(*tri, m_wall)
    nx, ny = 16, 8
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, nx / ny,
                      aperture=0.0, focus_dist=1.0)
    return b.build(), cam, RenderConfig(nx=nx, ny=ny, spp=2)


@pytest.fixture(scope="module")
def host_kernels():
    """The host build of the CUDA sources, bound as the card's library."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = mk.bind(build_host_library())

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


def _scene(table, name, kw=None):
    if name == "exact-ties":
        return exact_ties()
    table_kw, depth = table[name]
    preset = name.split("-spp")[0]
    if preset.startswith(("sphere-field", "triangle-field")):
        preset = preset.rsplit("-", 1)[0]
    scene, cam, cfg = build_preset(preset, device="cpu", **(
        table_kw if kw is None else dict(table_kw, **kw)))
    if depth is not None:
        cfg = dataclasses.replace(cfg, max_depth=depth)
    return scene, cam, cfg


def _case(table, ranges, case):
    """(scene, camera, config, ray0, rays) of a recorder's case: a scene
    of ``table`` over its default range, or a case of ``ranges``."""
    if case in ranges:
        name, kw, ray0, n = ranges[case]
        return (*_scene(table, name, kw), ray0, n)
    scene, cam, cfg = _scene(table, case)
    return scene, cam, cfg, 5, cfg.num_rays - 9


def _k1(pack, cam, cfg, emit_tape=False, pix0=0, num_pixels=None, spp0=0,
        spp_total=None):
    k0, k1 = rng.key_words(KEY)
    P = cfg.nx * cfg.ny
    num_pixels = P - pix0 if num_pixels is None else num_pixels
    return mk._launch_cuda(pack, mk.camera_table(cam), cfg, k0, k1, pix0,
                           num_pixels, P, spp0, spp_total or cfg.spp,
                           emit_tape, return_iters=True)


@pytest.mark.parametrize("name", list(DENSE))
def test_k1_k2_equal_plain(host_kernels, name):
    """K1 and K2: radiance sums, segments and K2's tape bit-equal to the
    plain versions; K2 equal to K1; the warps' steps cover the segments
    (lane efficiency at most 1)."""
    scene, cam, cfg = _scene(DENSE, name)
    pack = mk.pack_scene_mega(scene)
    rad, segs, steps = _k1(pack, cam, cfg)
    ref, ref_segs = mk.render_pixels_mega_reference(pack, cam, cfg, KEY)
    assert torch.equal(rad, ref) and torch.equal(segs, ref_segs)
    rad2, segs2, tape, _ = _k1(pack, cam, cfg, emit_tape=True)
    _, _, ref_tape = mk.render_pixels_mega_reference(pack, cam, cfg, KEY,
                                                     emit_tape=True)
    assert torch.equal(rad2, rad) and torch.equal(segs2, segs)
    assert torch.equal(tape, ref_tape)
    assert 0 < int(segs.sum()) <= 32 * int(steps.sum())


@pytest.mark.parametrize("name", ["three-spheres", "random-spheres"])
def test_k1_k2_pixel_and_sample_ranges(host_kernels, name):
    """A launch over a pixel range that runs past the image and over a
    range of samples (the sharded renders' calls) equals the plain
    version's over the same ranges; K2's columns past the image are -1."""
    scene, cam, cfg = _scene(DENSE, name)
    pack = mk.pack_scene_mega(scene)
    P = cfg.nx * cfg.ny
    kw = dict(pix0=P - 37, num_pixels=45, spp0=1, spp_total=cfg.spp + 2)
    rad, segs, tape, _ = _k1(pack, cam, cfg, emit_tape=True, **kw)
    ref, ref_segs, ref_tape = mk.render_pixels_mega_reference(
        pack, cam, cfg, KEY, emit_tape=True, **kw)
    assert torch.equal(rad, ref) and torch.equal(segs, ref_segs)
    assert torch.equal(tape, ref_tape)
    assert (tape[:, 37 * cfg.spp:] == -1).all()


@pytest.mark.parametrize("name", ["three-spheres", "triangle-mesh",
                                  "random-spheres", "sphere-field-1100",
                                  "sphere-field-2500", *RECORD_RANGES])
def test_k2b_equals_plain(host_kernels, name):
    """K2b's tape and trip counts over a ray range bit-equal to the plain
    version's; its warps' steps cover the trips (lane efficiency at most
    1), each warp's at the first ray of its first window."""
    scene, cam, cfg, ray0, n = _case(DENSE, RECORD_RANGES, name)
    pack = mk.pack_scene_mega(scene)
    tape, its, steps = rm._launch_record(pack, mk.camera_table(cam), cfg, KEY,
                                         ray0, n, cfg.spp, return_steps=True)
    ref, ref_its = rm.record_paths_mega_reference(pack, cam, cfg, KEY,
                                                  ray0=ray0, num_rays=n)
    assert torch.equal(tape, ref) and torch.equal(its, ref_its)
    assert 0 < int(its.sum()) <= 32 * int(steps.sum())


def _k3t_equal_plain(pack, cam, cfg, ray0, n):
    """K3t over rays [ray0, ray0 + n) against its plain version: tape and
    trips bit-equal, and its warps' steps (``sweeps[:, 5]``) covering the
    trips.  Returns K3t's per-ray counters."""
    tape, its, sweeps = rm._launch_record_clustered(
        pack, mk.camera_table(cam), cfg, KEY, ray0, n, cfg.spp)
    ref_tape, ref_its = rm.record_paths_mega_clustered_reference(
        pack, cam, cfg, KEY, ray0=ray0, num_rays=n)
    assert torch.equal(tape, ref_tape) and torch.equal(its, ref_its)
    assert 0 < int(its.sum()) <= 32 * int(sweeps[:, 5].sum())
    return sweeps


@pytest.mark.parametrize("name", [*CLUSTERED, *CLUSTERED_RANGES])
def test_k3_k3t_equal_plain(host_kernels, name):
    """K3's radiance and segments and K3t's tape and trips bit-equal to the
    plain versions (every column, no gates); K3 swept no more than an
    ungated sweep; its per-ray counters are K3t's summed over each pixel's
    samples; the warps swept each cluster once however many lanes needed
    it, so no more clusters than their lanes opened.  A case of
    ``CLUSTERED_RANGES`` holds K3t alone to the plain version over its
    range, and its per-ray counters to those of a launch over every ray
    (another schedule: a ray alone in its warp in one launch shares it in
    the other)."""
    if name in CLUSTERED_RANGES:
        scene, cam, cfg, ray0, n = _case(CLUSTERED, CLUSTERED_RANGES, name)
        pack = mc.pack_scene_mega_clustered(scene, cam)
        sweeps = _k3t_equal_plain(pack, cam, cfg, ray0, n)
        *_, whole = rm._launch_record_clustered(
            pack, mk.camera_table(cam), cfg, KEY, 0, cfg.num_rays, cfg.spp)
        assert torch.equal(sweeps[:, :4], whole[ray0:ray0 + n, :4])
        return
    scene, cam, cfg = _scene(CLUSTERED, name)
    pack = mc.pack_scene_mega_clustered(scene, cam)
    rad, segs, sweeps = mc._launch_cuda(pack, mk.camera_table(cam), cfg, KEY)
    ref, ref_segs, ungated = mc.render_pixels_mega_clustered_reference(
        pack, cam, cfg, KEY, return_iters=True)
    assert torch.equal(rad, ref) and torch.equal(segs, ref_segs)
    assert (sweeps[:, :3] <= ungated[:, :3]).all()
    tsweeps = _k3t_equal_plain(pack, cam, cfg, 0, cfg.num_rays)
    per_pixel = tsweeps[:, :4].reshape(-1, cfg.spp, 4).sum(1)
    assert torch.equal(per_pixel.to(torch.int32), sweeps[:, :4])
    assert 0 < int(sweeps[:, 4].sum()) <= int(sweeps[:, 0].sum())
    assert 0 < int(segs.sum()) <= 32 * int(sweeps[:, 5].sum())


@pytest.mark.parametrize("name", ["random-spheres", "triangle-mesh",
                                  "sphere-field-600"])
def test_k3_pixel_ranges(host_kernels, name):
    """K3 over four pixel ranges of ceil(P / 4) pixels (the sharded
    render's split; the last runs past the image), concatenated, is
    bit-equal to the whole-frame K3, and each range to the plain version's
    same range: radiance and segments."""
    scene, cam, cfg = _scene(CLUSTERED, name)
    pack = mc.pack_scene_mega_clustered(scene, cam)
    cam_row = mk.camera_table(cam)
    P = cfg.nx * cfg.ny
    per = -(-(P - 3) // 4)  # ranges that do not fall on a warp's 32
    whole, whole_segs, _ = mc._launch_cuda(pack, cam_row, cfg, KEY)
    rads, segs = [], []
    for r in range(4):
        rad, seg, _ = mc._launch_cuda(pack, cam_row, cfg, KEY, pix0=r * per,
                                      num_pixels=per)
        ref, ref_seg = mc.render_pixels_mega_clustered_reference(
            pack, cam, cfg, KEY, pix0=r * per, num_pixels=per)
        live = max(0, min(per, P - r * per))
        assert torch.equal(rad[:live], ref[:live])
        assert torch.equal(seg[:live], ref_seg[:live])
        rads.append(rad[:live])
        segs.append(seg[:live])
    assert torch.equal(torch.cat(rads), whole)
    assert torch.equal(torch.cat(segs), whole_segs)


def _rays(scene, cam, cfg, n=512):
    ids = torch.arange(min(n, cfg.num_rays))
    return generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(KEY, ids))


@pytest.mark.parametrize("name", ["three-spheres", "triangle-mesh",
                                  "random-spheres", "sphere-field-600",
                                  "triangle-field-2000"])
def test_k4_k5_equal_plain(host_kernels, name):
    """K4 and K5 (max_leaf 7 and 128): hits, primitives and t bit-equal to
    their plain versions on camera rays and on random rays."""
    scene, cam, cfg = _scene(CLUSTERED, name)
    g = torch.Generator().manual_seed(3)
    rays = [_rays(scene, cam, cfg),
            ((torch.rand((256, 3), generator=g) - 0.5) * 16,
             torch.nn.functional.normalize(
                 torch.randn((256, 3), generator=g), dim=1))]
    dpack = ip.pack_scene_pallas(scene)
    for o, d in rays:
        o, d = o.contiguous(), d.contiguous()
        prim, t = ip._launch_cuda(dpack, o, d, 1e-3)
        rprim, rt, _ = ip.intersect_pallas_reference(scene, dpack, o, d,
                                                     1e-3)
        assert torch.equal(prim, rprim) and torch.equal(t, rt)
        for leaf in (7, 128):
            cpack = ic.pack_scene_clustered(scene, max_leaf=leaf)
            prim, t, _ = ic._launch_cuda(cpack, o, d, 1e-3, False)
            cprim, ct, _ = ic.intersect_clustered_reference(scene, cpack, o,
                                                            d, 1e-3)
            assert torch.equal(prim, cprim) and torch.equal(t, ct)
