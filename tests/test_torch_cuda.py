"""K1, K2, K2b, K3, K3t, K4 and K5 (the CUDA kernels) against their plain
versions on the card, a gradient step through K2b, and the wavefront and
regenerative renders through K4 and K5 (their loops as CUDA graphs, held
bit-equal to the same bodies run eagerly).  The direct gradient step (its
recorder's loop and its whole tape's value and gradient as CUDA graphs) on
the dense sweep, K4 and K5, and the occupancy scan, against the same
bodies op by op: tapes and lengths ``torch.equal``, the loss within one
float32 ulp and the gradients within ``rtol=1e-6``; the flat-BVH walk
(K6) graphed in the recorders and the direct step, equal to the same bodies
run op by op and to the dense sweep's tape.  K16 and K17 (the scan's row
gathers and their sums) against their plain versions bit for bit, the
same bits over three launches and with the rays permuted.

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
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import numpy as np
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
def test_graphed_step_matches_its_eager_body(cuda_device):
    """2^12 rays of the final scene: ``render_loss_and_grads_bucketed`` on
    the card (a replay of its CUDA graph) against its eager body
    (``bucketed_loss_and_grads``) on the same inputs, for two keys and
    after the parameters moved (the same signature replayed on new
    inputs), then on a plan of two groups (another signature, captured
    with no second warm-up): the loss within one float32 ulp, every
    gradient within ``rtol=1e-6`` (the replay's float64 gather sums with
    atomics)."""
    scene, cam, cfg = build_preset("random-spheres", device=cuda_device)
    R = 1 << 12
    ids = torch.arange(R, device=cuda_device)
    target = torch.zeros((R, 3), device=cuda_device)
    params, _ = dg.split_params(scene)
    record = dg.tape_recorder(scene, cam, cfg, ids, cuda_device)
    replays, warmups = dg.GRAPHS.replays, dg.GRAPHS.warmups
    for key, scale, max_groups in ((rng.base_key(0), 1.0, 6),
                                   (rng.base_key(5), 1.0, 6),
                                   (rng.base_key(0), 1.01, 6),
                                   (rng.base_key(0), 1.01, 2)):
        p = {k: (v.detach() * scale).requires_grad_(True)
             for k, v in params.items()}
        tape = record(dg.merge_params(scene, p), key)
        order, groups = plan_buckets(tape, max_groups)
        loss, grads = dg.render_loss_and_grads_bucketed(
            p, scene, cam, cfg, key, ids, target, tape, plan=(order, groups))
        want_loss, want = dg.bucketed_loss_and_grads(
            p, scene, cam, key, ids, target, tape, order, cfg=cfg,
            groups=groups, num_values=target.numel())
        ulp = float(np.spacing(np.float32(abs(float(want_loss)))))
        assert abs(float(loss) - float(want_loss)) <= ulp
        for k, g in grads.items():
            torch.testing.assert_close(g, want[k], rtol=1e-6, atol=0.0,
                                       msg=k)
    assert dg.GRAPHS.replays == replays + 4
    assert dg.GRAPHS.warmups <= warmups + 1


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
    assert torch.equal(tsweeps[:, :4].reshape(-1, cfg.spp, 4).sum(
        1, dtype=torch.int32), sweeps[:, :4])
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


def _camera_rays(scene, cam, cfg):
    from first_raytracer_tpu_torch.render.camera import generate_rays

    ids = torch.arange(cfg.num_rays, device=scene.device)
    return generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(rng.base_key(0), ids))


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("sphere-field", 5000),
                                    ("triangle-field", 2000)])
def test_dense_kernel_streams_tiles(cuda_device, name, n):
    """K4 past one shared-memory tile (512 spheres, 256 triangles): equal
    to its plain version on the camera's rays and on 4096 random rays."""
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip

    scene, cam, cfg = build_preset(name, device=cuda_device, n=n, nx=64,
                                   ny=32, spp=2)
    dense = ip.pack_scene_pallas(scene)
    assert dense.sphere_rows > 512 or dense.tri_rows > 256
    g = torch.Generator().manual_seed(1)
    o = (torch.rand((4096, 3), generator=g) * 16 - 8).to(cuda_device)
    d = torch.randn((4096, 3), generator=g)
    d = (d / d.norm(dim=1, keepdim=True)).to(cuda_device)
    for rays in ((o, d), _camera_rays(scene, cam, cfg)):
        got = ip.intersect_pallas(scene, dense, *rays, 1e-3)
        want = ip.intersect_pallas_reference(scene, dense, *rays, 1e-3)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_clustered_kernel_box_tests(cuda_device):
    """K5's supergroup level on sphere_field(5000)'s camera rays: at most
    one box test per cluster and supergroup on every ray, fewer than one
    per cluster on average, and the winner still K4's."""
    from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip

    scene, cam, cfg = build_preset("sphere-field", device=cuda_device,
                                   n=5000, nx=64, ny=32, spp=2)
    rays = _camera_rays(scene, cam, cfg)
    pack = ic.pack_scene_clustered(scene)
    *k5, sweeps = ic.intersect_clustered(scene, pack, *rays, 1e-3,
                                         return_iters=True)
    k = pack.sph_clusters + pack.tri_clusters
    kss = -(-pack.sph_clusters // 8) - (-pack.tri_clusters // 8)
    boxes = sweeps[:, 3]
    assert int(boxes.max()) <= k + kss
    assert float(boxes.float().mean()) < k
    k4 = ip.intersect_pallas(scene, ip.pack_scene_pallas(scene), *rays, 1e-3)
    for a, b in zip(k5, k4):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("mode", ["regenerative", "wavefront"])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_wavefront_graph_equals_eager(cuda_device, kernel, mode):
    """The pool and the chunked batch through K4 and K5, replayed as CUDA
    graphs (``render/graphed.py``), against the same bodies run eagerly
    (``graphed=False``): radiance and segments bit-equal, twice (the second
    call replays the cached graphs); the kernel's counter moves by the
    passes the graphs ran, and the host reads the flag once per
    ``PASSES_PER_READ`` passes."""
    from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
    from first_raytracer_tpu_torch.render import graphed
    from first_raytracer_tpu_torch.render.api import render_ray_batch
    from first_raytracer_tpu_torch.render.regenerative import (
        render_rays_regenerative)

    scene, cam, cfg = build_preset("random-spheres", device=cuda_device,
                                   nx=96, ny=64, spp=2)
    if kernel == "K4":
        accel, counter = ip.pack_scene_pallas(scene), ip.intersect_pallas
    else:
        accel, counter = (ic.pack_scene_clustered(scene),
                          ic.intersect_clustered)
    key = rng.base_key(3)

    def frame(**kw):
        if mode == "regenerative":
            return render_rays_regenerative(scene, cam, cfg, key, 5,
                                            cfg.num_rays - 5, accel,
                                            pool_size=4096,
                                            return_stats=True, **kw)
        ids = torch.arange(cfg.num_rays, device=cuda_device)
        return render_ray_batch(scene, cam, cfg, key, ids, accel,
                                return_stats=True, **kw)

    want = frame(graphed=False)
    for _ in range(2):
        graphed.LOOPS.reset_counts()
        before = counter.launches
        got = frame()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        loops = graphed.LOOPS
        assert counter.launches - before == loops.passes + (
            loops.warmups * graphed.PASSES_PER_READ)
        assert loops.syncs * graphed.PASSES_PER_READ == loops.passes
        assert 0 <= loops.passes - loops.live_passes < \
            graphed.PASSES_PER_READ
    assert loops.captures == 0 and loops.replays == loops.syncs


def _within_graph_bounds(loss, grads, want_loss, want):
    """The graphed value and gradient against the eager body's: the loss
    within one float32 ulp, every gradient within ``rtol=1e-6`` (the
    replay's gather sums its backward in float64 with atomics)."""
    ulp = float(np.spacing(np.float32(abs(float(want_loss)))))
    assert abs(float(loss) - float(want_loss)) <= ulp
    for k, g in grads.items():
        torch.testing.assert_close(g, want[k], rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("record_pool", [0, 4096], ids=["lockstep", "pool"])
@pytest.mark.parametrize("accel", ["dense sweep", "K4", "K5"])
def test_direct_step_graph_equals_eager(cuda_device, accel, record_pool):
    """The direct step (``render_loss_and_grads``): its recorder's loop and
    the whole tape's value and gradient replayed as CUDA graphs, against
    the same recorder run op by op (``graphed=False``) and the eager body
    ``tape_loss_and_grads``: the tapes ``torch.equal``, the loss and the
    gradients within the graph's bounds, twice (the second call replays
    the cached graphs); then two ``make_fit_step`` steps with Adam, each
    loss against the eager step's within one ulp."""
    from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
    from first_raytracer_tpu_torch.render import graphed

    scene, cam, cfg = build_preset("random-spheres", device=cuda_device,
                                   nx=96, ny=64, spp=2)
    acc = {"dense sweep": lambda s: None, "K4": ip.pack_scene_pallas,
           "K5": ic.pack_scene_clustered}[accel](scene)
    key = rng.base_key(2)
    ids = torch.arange(cfg.num_rays, device=cuda_device)
    target = torch.zeros((cfg.num_rays, 3), device=cuda_device)
    params, _ = dg.split_params(scene)
    args = (scene, cam, cfg, key, ids)

    def eager(p):
        tape = dg.record_tape(p, *args, acc, record_pool=record_pool,
                              graphed=False)
        return tape, dg.tape_loss_and_grads(p, scene, cam, key, ids, target,
                                            tape, cfg=cfg)

    tape, (want_loss, want) = eager(params)
    for _ in range(2):
        graphed.LOOPS.reset_counts()
        got = dg.record_tape(params, *args, acc, record_pool=record_pool)
        loss, grads = dg.render_loss_and_grads(params, *args, target, acc,
                                               record_pool=record_pool)
        assert torch.equal(got, tape)
        _within_graph_bounds(loss, grads, want_loss, want)
        assert graphed.LOOPS.replays == graphed.LOOPS.syncs >= 2
    assert dg.GRAPHS.replays >= 2

    fit = {k: v.detach().clone().requires_grad_(True)
           for k, v in params.items()}
    ref = {k: v.detach().clone().requires_grad_(True)
           for k, v in params.items()}
    step = dg.make_fit_step(scene, cam, cfg, ids, target,
                            dg.make_optimizer("adam", fit, 1e-3),
                            accel=acc, device=cuda_device)
    ref_opt = dg.make_optimizer("adam", ref, 1e-3)
    for _ in range(2):
        loss = step(fit, key)
        _, (want_loss, want) = eager(ref)
        dg.apply_grads(ref_opt, ref, want)
        ulp = float(np.spacing(np.float32(abs(float(want_loss)))))
        assert abs(float(loss) - float(want_loss)) <= ulp


@pytest.mark.cuda
def test_occupancy_scan_graph_equals_eager(cuda_device):
    """``wavefront_occupancy``'s loop replayed as CUDA graphs against the
    same bodies op by op: the per-ray lengths ``torch.equal``."""
    from first_raytracer_tpu_torch.utils import metrics

    scene, cam, cfg = build_preset("random-spheres", device=cuda_device,
                                   nx=96, ny=64, spp=2)
    ids = torch.arange(cfg.num_rays, device=cuda_device)
    key = rng.base_key(0)
    want = metrics._path_lengths(scene, cam, cfg, key, ids, None,
                                 graphed=False)
    for _ in range(2):
        assert torch.equal(
            metrics._path_lengths(scene, cam, cfg, key, ids, None), want)
    report = metrics.wavefront_occupancy(scene, cam, cfg,
                                         num_rays=cfg.num_rays,
                                         device=cuda_device)
    assert sum(report["alive_per_bounce"]) == int(want.sum())


@pytest.mark.cuda
def test_the_walk_records_eagerly_on_the_card(cuda_device):
    """The flat-BVH walk is K6 on the card: the recorders and the direct
    step take their graphs with it by default, and record the tape that
    the same bodies record op by op (``graphed=False``), which is the
    dense sweep's (the loss within one float32 ulp of the eager step's);
    K6 equals its plain version."""
    from first_raytracer_tpu_torch.accel import traverse
    from first_raytracer_tpu_torch.accel.build import build_bvh
    from first_raytracer_tpu_torch.diff import replay

    scene, cam, cfg = build_preset("three-spheres", device=cuda_device,
                                   nx=32, ny=16, spp=2)
    bvh = build_bvh(scene, max_leaf=4)
    key = rng.base_key(0)
    ids = torch.arange(cfg.num_rays, device=cuda_device)
    target = torch.zeros((cfg.num_rays, 3), device=cuda_device)
    params, _ = dg.split_params(scene)
    before = traverse.intersect_bvh.launches
    got = replay.record_camera_paths(scene, cam, cfg, key, ids, bvh)
    assert traverse.intersect_bvh.launches > before
    eager = replay.record_camera_paths(scene, cam, cfg, key, ids, bvh,
                                       graphed=False)
    assert torch.equal(got, eager)
    assert torch.equal(got, replay.record_camera_paths(scene, cam, cfg, key,
                                                       ids))
    assert torch.equal(replay.record_paths_pool(scene, cam, cfg, key, ids,
                                                bvh), got)
    loss, _ = dg.render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                       target, bvh)
    loss_e, _ = dg.render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                         target, bvh, graphed=False)
    ulp = float(np.spacing(np.float32(abs(float(loss_e)))))
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - float(loss_e)) <= ulp
    o = torch.randn((4096, 3), device=cuda_device)
    d = torch.nn.functional.normalize(torch.randn((4096, 3),
                                                  device=cuda_device), dim=1)
    k6 = traverse.intersect_bvh(scene, bvh, o, d, 1e-3)
    plain = traverse.intersect_bvh_plain(scene, bvh, o, d, 1e-3)
    assert all(torch.equal(a, b) for a, b in zip(k6, plain))


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


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", CLUSTERED,
                         ids=[c[0] for c in CLUSTERED])
def test_clustered_kernel_pixel_ranges(cuda_device, name, kw):
    """K3 over three pixel ranges of ceil(P / 3) (the sharded render's
    split; the last runs past the image), concatenated: bit-equal to the
    whole-frame K3; the plain version's ranges likewise to its whole
    frame (which ``test_clustered_kernels_match_plain`` holds K3 to)."""
    scene, cam, cfg = build_preset(name, device=cuda_device, **kw)
    pack = mc.pack_scene_mega_clustered(scene, cam)
    key = rng.base_key(0)
    P = cfg.nx * cfg.ny
    per = -(-P // 3)
    for fn in (mc.render_pixels_mega_clustered,
               mc.render_pixels_mega_clustered_reference):
        whole, whole_segs = fn(pack, cam, cfg, key)
        parts = [fn(pack, cam, cfg, key, pix0=i * per, num_pixels=per)
                 for i in range(3)]
        assert torch.equal(torch.cat([p[0] for p in parts])[:P], whole)
        assert torch.equal(torch.cat([p[1] for p in parts])[:P],
                           whole_segs)


@pytest.mark.cuda
def test_sharded_megakernels_in_one_process(cuda_device):
    """The sharded megakernel entries on a mesh of one rank (no process
    group, no collective) equal the unsharded renders bit for bit."""
    from first_raytracer_tpu_torch.parallel.mesh import make_render_mesh

    mesh = make_render_mesh()
    scene, cam, cfg = build_preset("random-spheres", device=cuda_device,
                                   nx=96, ny=64, spp=2)
    assert torch.equal(
        mk.render_image_mega_sharded(scene, cam, cfg, mesh),
        mk.render_image_mega(scene, cam, cfg))
    assert torch.equal(
        mc.render_image_mega_clustered_sharded(scene, cam, cfg, mesh),
        mc.render_image_mega_clustered(scene, cam, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_gathers_match_plain(cuda_device, dtype):
    """K16 ``torch.equal`` to ``index_select`` and K17 bit-equal to
    ``row_sum_plain`` on three tables, most rays on row 0 and a quarter
    with zero gradients; K17 the same bits over three launches and with
    the rays permuted."""
    from first_raytracer_tpu_torch.kernels import gather_rows as gr

    g = torch.Generator().manual_seed(0)
    R, shapes = 1 << 14, [(486, 4), (40, 9), (486, 11)]
    tables = [torch.randn(sh, generator=g, dtype=dtype).to(cuda_device)
              for sh in shapes]
    idxs, grads = [], []
    for rows, cols in shapes:
        i = torch.randint(0, rows, (R,), generator=g)
        i[torch.rand(R, generator=g) < 0.7] = 0
        x = torch.randn((R, cols), generator=g, dtype=dtype)
        x[torch.rand(R, generator=g) < 0.25] = 0.0
        idxs.append(i.to(cuda_device))
        grads.append(x.to(cuda_device))
    rows = gr.launch_gather(tables, idxs)
    assert all(torch.equal(a, b)
               for a, b in zip(rows, gr.gather_plain(tables, idxs)))
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    want = [gr.row_sum_plain(x, i, sh[0]).view(bits)
            for x, i, sh in zip(grads, idxs, shapes)]
    perm = torch.randperm(R, generator=g).to(cuda_device)
    runs = [(grads, idxs)] * 3 + [([x[perm] for x in grads],
                                   [i[perm] for i in idxs])]
    for xs, ids in runs:
        got = gr.launch_row_sum(xs, ids, shapes)
        assert all(torch.equal(a.view(bits), b) for a, b in zip(got, want))
