"""K1, K2, K2b, K3, K3t, K4 and K5 (the CUDA kernels) against their plain
versions on the card, a gradient step through K2b, and the wavefront and
regenerative renders through K4 and K5.

Marked ``cuda``; skipped where ``torch.cuda.is_available()`` is False.
This file imports neither JAX nor the JAX package, so it also runs on a GPU
host without JAX, where ``tests/conftest.py`` (which imports JAX) must be
left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Bound: ``(|a - b| > 1e-3).mean() < 0.01`` on per-pixel mean radiance
(rounding differs: libm and CUDA's math library round transcendentals
differently, and a one-ulp change can send a path another way) and segment
totals within 0.1%.  Tapes: per-entry agreement above 0.999, or 0.99 on the
coplanar triangle mesh (tests/test_record_mega.py:30-43); K2 must leave
K1's radiance and segments bit-equal, and K2b's tape must equal K2's.  K3
and K3t take the same bounds against their plain versions (triangle fields
per pixel: their paths are chaotic), and K3's gates may only cut work: its
sweep counters stay at or below an ungated sweep's.  K4 and K5 must equal
their plain versions exactly (hits, primitives and t: the same operation
order, built with ``--fmad=false``, and a correctly rounded square root in
both), and K5 must equal K4.
"""
import dataclasses

import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import grad as dg
from first_raytracer_tpu_torch.diff.replay import plan_buckets
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
from first_raytracer_tpu_torch.kernels import record_mega as rm
from first_raytracer_tpu_torch.scene.builders import build_preset

CASES = [
    ("three-spheres", dict(nx=64, ny=32, spp=4)),
    ("triangle-mesh", dict(nx=64, ny=32, spp=2)),
    ("camera-effects", dict(nx=64, ny=32, spp=4)),
    ("random-spheres", dict(nx=96, ny=64, spp=2)),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K1 is a CUDA kernel")
    return torch.device("cuda")


def _assert_close(rad, segs, ref, ref_segs, spp):
    a, b = (rad / spp).cpu(), (ref / spp).cpu()
    assert torch.isfinite(a).all()
    diff = (a - b).abs()
    assert float((diff > 1e-3).float().mean()) < 0.01, float(diff.max())
    total, ref_total = int(segs.sum()), int(ref_segs.sum())
    assert abs(total - ref_total) <= 1e-3 * ref_total


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda_device, name, kw):
    scene, cam, cfg = build_preset(name, device=cuda_device, **kw)
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(0)
    before = mk.render_pixels_mega.launches
    rad, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    torch.cuda.synchronize()
    assert mk.render_pixels_mega.launches == before + 1
    assert rad.device.type == "cuda" and segs.dtype == torch.int32
    ref, ref_segs = mk.render_pixels_mega_reference(pack, cam, cfg, key)
    _assert_close(rad, segs, ref, ref_segs, cfg.spp)


@pytest.mark.cuda
def test_kernel_triangles_only_and_offsets(cuda_device):
    scene, cam, cfg = build_preset("triangle-mesh", device=cuda_device,
                                   nx=40, ny=20, spp=2)
    scene = dataclasses.replace(
        scene, sphere_center=scene.sphere_center[:0],
        sphere_radius=scene.sphere_radius[:0],
        sphere_mat=scene.sphere_mat[:0])
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(4)
    rad, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    ref, ref_segs = mk.render_pixels_mega_reference(pack, cam, cfg, key)
    diff = ((rad - ref) / cfg.spp).abs().cpu()
    assert float((diff > 1e-3).float().mean()) < 0.01
    # Per pixel, not in total: without spheres, a few paths leak between
    # the coplanar floor and tetrahedron faces and bounce to the depth cap,
    # so one ulp elsewhere moves a 6.8k-segment total by ~0.2% (the plain
    # version on the CPU and on the GPU differ as much).
    assert float((segs != ref_segs).float().mean()) < 0.01
    # Pixel blocks past the image's end stay zero; blocks rebuild it.
    a = mk.render_pixels_mega(pack, cam, cfg, key, pix0=0, num_pixels=500)
    b = mk.render_pixels_mega(pack, cam, cfg, key, pix0=500,
                              num_pixels=400)
    torch.testing.assert_close(torch.cat([a[0], b[0]])[:800], rad,
                               rtol=0, atol=0)
    assert (b[0][300:] == 0).all() and (b[1][300:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_tape_kernels_match_plain(cuda_device, name, kw):
    scene, cam, cfg = build_preset(name, device=cuda_device, **kw)
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(0)
    rad, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    before = (mk.render_pixels_mega.tape_launches,
              rm.record_paths_mega.launches)
    rad2, segs2, tape = mk.render_pixels_mega(pack, cam, cfg, key,
                                              emit_tape=True)
    tape_b, its = rm.record_paths_mega(pack, cam, cfg, key,
                                       return_iters=True)
    torch.cuda.synchronize()
    assert (mk.render_pixels_mega.tape_launches,
            rm.record_paths_mega.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(rad2, rad) and torch.equal(segs2, segs)
    assert torch.equal(tape_b, tape)
    assert torch.equal(its.reshape(-1, cfg.spp).sum(1, dtype=torch.int32),
                       segs)
    _, _, ref = mk.render_pixels_mega_reference(pack, cam, cfg, key,
                                                emit_tape=True)
    floor = 0.99 if name == "triangle-mesh" else 0.999
    assert float((tape == ref).float().mean()) > floor


@pytest.mark.cuda
def test_tape_slice_at_large_ray_ids(cuda_device):
    """A 512-ray slice high in the final scene's id space, through K2b,
    equals the same columns of the full-frame K2 tape."""
    scene, cam, cfg = build_preset("random-spheres", device=cuda_device)
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(0)
    _, _, full = mk.render_pixels_mega(pack, cam, cfg, key, emit_tape=True)
    ray0, n = 9_500_000, 512
    want = full[:, ray0:ray0 + n]
    del full
    got = rm.record_paths_mega(pack, cam, cfg, key, ray0=ray0, num_rays=n)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gradient_step_on_the_card(cuda_device):
    """2^12 rays of the final scene: K2b's tape, plan, bucketed value and
    gradients on the card against the same step on the CPU (plain K2b and
    the CPU replay): tapes agree above 0.999, the loss within 1e-3 and
    each gradient's cosine above 0.99 (paths that graze a sphere move with
    an ulp, and the card's math library rounds otherwise than libm)."""
    scene, cam, cfg = build_preset("random-spheres", device="cpu")
    R = 1 << 12
    key = rng.base_key(0)
    results = {}
    for dev in ("cpu", cuda_device):
        s, c = scene.to(dev), cam.to(dev)
        ids = torch.arange(R, device=dev)
        target = torch.zeros((R, 3), device=dev)
        params, _ = dg.split_params(s)
        tape = rm.record_paths_mega(mk.pack_scene_mega(s), c, cfg, key,
                                    num_rays=R)
        loss, grads = dg.render_loss_and_grads_bucketed(
            params, s, c, cfg, key, ids, target, tape,
            plan=plan_buckets(tape))
        results[str(dev)] = (tape.cpu(), float(loss),
                             {k: g.cpu() for k, g in grads.items()})
    (t0, l0, g0), (t1, l1, g1) = results["cpu"], results[str(cuda_device)]
    assert float((t0 == t1).float().mean()) > 0.999
    assert abs(l1 - l0) <= 1e-3 * abs(l0)
    assert float(g1["albedo"].abs().max()) > 0.0
    for k, g in g1.items():
        assert bool(torch.isfinite(g).all()), k
        if g0[k].norm() > 0:
            cos = (g0[k].flatten() @ g.flatten()) / (g0[k].norm() * g.norm())
            assert float(cos) > 0.99, k


@pytest.mark.cuda
def test_kernel_refuses_bad_input(cuda_device):
    scene, cam, cfg = build_preset("three-spheres", device=cuda_device,
                                   nx=8, ny=4, spp=1)
    pack = mk.pack_scene_mega(scene)
    bad = dataclasses.replace(pack, sph_mx=pack.sph_mx.double())
    with pytest.raises(ValueError, match="dtype"):
        mk.render_pixels_mega(bad, cam, cfg, rng.base_key(0))
    bad = dataclasses.replace(pack, sph_mx=pack.sph_mx.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        mk.render_pixels_mega(bad, cam, cfg, rng.base_key(0))
    with pytest.raises(ValueError, match="contiguous"):
        mk.render_pixels_mega(bad, cam, cfg, rng.base_key(0), emit_tape=True)
    with pytest.raises(ValueError, match="contiguous"):
        rm.record_paths_mega(bad, cam, cfg, rng.base_key(0))
    cpack = mc.pack_scene_mega_clustered(scene, cam)
    bad = dataclasses.replace(cpack, sph_counts=cpack.sph_counts.long())
    with pytest.raises(ValueError, match="dtype"):
        mc.render_pixels_mega_clustered(bad, cam, cfg, rng.base_key(0))
    with pytest.raises(ValueError, match="dtype"):
        rm.record_paths_mega_clustered(bad, cam, cfg, rng.base_key(0))


CLUSTERED = [
    ("three-spheres", dict(nx=64, ny=32, spp=2)),
    ("random-spheres", dict(nx=64, ny=32, spp=2)),
    ("triangle-mesh", dict(nx=64, ny=32, spp=2)),
    ("sphere-field", dict(n=600, nx=64, ny=32, spp=2)),
    ("sphere-field", dict(n=2500, nx=64, ny=36, spp=2)),
    ("triangle-field", dict(n=2000, nx=64, ny=32, spp=2)),
]


def _clustered_id(case):
    name, kw = case
    return name + (f"-{kw['n']}" if "n" in kw else "")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CLUSTERED,
                         ids=[_clustered_id(c) for c in CLUSTERED])
def test_clustered_kernels_match_plain(cuda_device, name, kw):
    scene, cam, cfg = build_preset(name, device=cuda_device, **kw)
    pack = mc.pack_scene_mega_clustered(scene, cam)
    key = rng.base_key(0)
    before = (mc.render_pixels_mega_clustered.launches,
              rm.record_paths_mega_clustered.launches)
    rad, segs, sweeps = mc.render_pixels_mega_clustered(pack, cam, cfg, key,
                                                        return_iters=True)
    tape, its, tsweeps = rm.record_paths_mega_clustered(
        pack, cam, cfg, key, return_iters=True)
    torch.cuda.synchronize()
    assert (mc.render_pixels_mega_clustered.launches,
            rm.record_paths_mega_clustered.launches) == (before[0] + 1,
                                                         before[1] + 1)
    ref, ref_segs, ungated = mc.render_pixels_mega_clustered_reference(
        pack, cam, cfg, key, return_iters=True)
    triangles = "triangle" in name
    diff = ((rad - ref) / cfg.spp).abs().cpu()
    assert torch.isfinite(rad).all()
    assert float((diff > 1e-3).float().mean()) < 0.01, float(diff.max())
    if triangles:
        assert float((segs != ref_segs).float().mean()) < 0.01
    else:
        total, ref_total = int(segs.sum()), int(ref_segs.sum())
        assert abs(total - ref_total) <= 1e-3 * ref_total
    # K3t traces K3's paths: per pixel, its trips are K3's segments and
    # its counters K3's.
    assert torch.equal(its.reshape(-1, cfg.spp).sum(1, dtype=torch.int32),
                       segs)
    assert torch.equal(tsweeps.reshape(-1, cfg.spp, 4).sum(1,
                                                          dtype=torch.int32),
                       sweeps)
    assert (sweeps[:, :3] <= ungated[:, :3]).all()
    ref_tape, _ = rm.record_paths_mega_clustered_reference(pack, cam, cfg,
                                                           key)
    floor = 0.99 if triangles else 0.999
    assert float((tape == ref_tape).float().mean()) > floor


@pytest.mark.cuda
def test_clustered_kernel_matches_k1(cuda_device):
    """K3 against K1 on a scene both take: the image bound."""
    scene, cam, cfg = build_preset("sphere-field", device=cuda_device,
                                   n=5000, nx=200, ny=112, spp=2)
    key = rng.base_key(0)
    rad1, segs1 = mk.render_pixels_mega(mk.pack_scene_mega(scene), cam, cfg,
                                        key)
    rad3, segs3 = mc.render_pixels_mega_clustered(
        mc.pack_scene_mega_clustered(scene, cam),
        cam, cfg, key)
    diff = ((rad1 - rad3) / cfg.spp).abs().cpu()
    assert float((diff > 1e-3).float().mean()) < 0.01
    assert abs(int(segs1.sum()) - int(segs3.sum())) <= 1e-3 * int(segs1.sum())


@pytest.mark.cuda
def test_divide_rounds_as_on_the_cpu(cuda_device):
    """On the card ``vecmath.divide`` gives the CPU's correctly rounded
    quotient, so the plain versions' camera rays are the kernels'; torch's
    own division by a Python number multiplies by the reciprocal there."""
    from first_raytracer_tpu_torch.core.vecmath import divide

    x = torch.rand(1 << 16, generator=torch.Generator().manual_seed(3)) * 800
    want = divide(x, 800)
    assert torch.equal(divide(x.to(cuda_device), 800).cpu(), want)


INTERSECT = [
    ("three-spheres", {}), ("random-spheres", {}), ("triangle-mesh", {}),
    ("sphere-field", dict(n=600)), ("triangle-field", dict(n=2000)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", INTERSECT,
                         ids=[_clustered_id(c) for c in INTERSECT])
def test_intersect_kernels_match_plain(cuda_device, name, kw):
    """K4 and K5 (max_leaf 1, 7, 128) on the camera's rays and on 4096
    random rays (uniform origins in [-8, 8]^3): equal to their plain
    versions and to each other; each launch moves its counter."""
    from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
    from first_raytracer_tpu_torch.render.camera import generate_rays

    scene, cam, cfg = build_preset(name, device=cuda_device, nx=64, ny=32,
                                   spp=2, **kw)
    g = torch.Generator().manual_seed(0)
    o = (torch.rand((4096, 3), generator=g) * 16 - 8).to(cuda_device)
    d = torch.randn((4096, 3), generator=g)
    d = (d / d.norm(dim=1, keepdim=True)).to(cuda_device)
    ids = torch.arange(cfg.num_rays, device=cuda_device)
    co, cd = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                           rng.camera_uniforms(rng.base_key(0), ids))
    dense = ip.pack_scene_pallas(scene)
    for rays in ((o, d), (co, cd)):
        before = ip.intersect_pallas.launches
        k4 = ip.intersect_pallas(scene, dense, *rays, 1e-3)
        torch.cuda.synchronize()
        assert ip.intersect_pallas.launches == before + 1
        for a, b in zip(k4, ip.intersect_pallas_reference(scene, dense,
                                                          *rays, 1e-3)):
            assert torch.equal(a, b)
        for max_leaf in (1, 7, 128):
            pack = ic.pack_scene_clustered(scene, max_leaf=max_leaf)
            before = ic.intersect_clustered.launches
            *k5, sweeps = ic.intersect_clustered(scene, pack, *rays, 1e-3,
                                                 return_iters=True)
            torch.cuda.synchronize()
            assert ic.intersect_clustered.launches == before + 1
            plain = ic.intersect_clustered_reference(scene, pack, *rays,
                                                     1e-3)
            for a, b, c in zip(k5, plain, k4):
                assert torch.equal(a, b) and torch.equal(a, c)
            ungated = torch.tensor(
                [pack.sph_clusters + pack.tri_clusters,
                 scene.num_spheres, scene.num_triangles],
                device=cuda_device)
            assert (sweeps[:, :3] <= ungated).all()


@pytest.mark.cuda
def test_wavefront_renders_through_k4_and_k5(cuda_device):
    """render_image on the card, wavefront and regenerative, through K4 and
    K5: the four images equal (``atol=2e-6``) and within the image bound
    of K1's; both counters move."""
    from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
    from first_raytracer_tpu_torch.render.api import render_image

    scene, cam, cfg = build_preset("random-spheres", device=cuda_device,
                                   nx=96, ny=64, spp=2)
    before = (ip.intersect_pallas.launches, ic.intersect_clustered.launches)
    imgs = [render_image(scene, cam, cfg, accel=accel, mode=mode,
                         pool_size=4096, device=cuda_device)
            for accel in (ip.pack_scene_pallas(scene),
                          ic.pack_scene_clustered(scene))
            for mode in ("wavefront", "regenerative")]
    torch.cuda.synchronize()
    assert ip.intersect_pallas.launches > before[0]
    assert ic.intersect_clustered.launches > before[1]
    for img in imgs[1:]:
        torch.testing.assert_close(img, imgs[0], atol=2e-6, rtol=0)
    mega = mk.render_image_mega(scene, cam, cfg, device=cuda_device)
    diff = (imgs[0] - mega).abs().cpu()
    assert float((diff > 1e-3).float().mean()) < 0.01


@pytest.mark.cuda
def test_intersect_kernels_refuse_bad_input(cuda_device):
    from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip

    scene, _, _ = build_preset("three-spheres", device=cuda_device)
    o = torch.zeros((8, 3), device=cuda_device)
    d = torch.ones((8, 3), device=cuda_device)
    dense = ip.pack_scene_pallas(scene)
    with pytest.raises(ValueError, match="dtype"):
        ip.intersect_pallas(scene, dataclasses.replace(
            dense, spheres=dense.spheres.double()), o, d, 1e-3)
    with pytest.raises(ValueError, match="device"):
        ip.intersect_pallas(scene, dense, o.cpu(), d.cpu(), 1e-3)
    pack = ic.pack_scene_clustered(scene)
    with pytest.raises(ValueError, match="dtype"):
        ic.intersect_clustered(scene, dataclasses.replace(
            pack, sph_gid=pack.sph_gid.long()), o, d, 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        ic.intersect_clustered(scene, dataclasses.replace(
            pack, sph_box=pack.sph_box.t().contiguous().t()), o, d, 1e-3)
