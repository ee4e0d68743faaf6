"""K7 (the Threefry draw) and K8 (the camera rays) on the CPU, and the
wrappers that route the wavefront paths through them.

- Their source (``kernels/csrc/rng_rays.cu``), compiled by g++ through the
  host emulation (``kernels/host_emu``) and driven by the wrappers' own
  launch code on CPU tensors: K7 bit-equal to ``core.rng.uniforms_plain``
  for seeds 0, 7, -1 and 2^31 - 1, the ids of ``tests/test_torch_rng.py``
  (2^31 - 1 among them) and ids past 2^32 that the 32-bit mask wraps, in an
  integer domain, a 0-d tensor domain and a domain per ray, and through
  ``precompute_uniforms``' broadcast; K8 bit-equal to ``generate_rays`` on
  the plain camera draw, on the cameras of three-spheres, random-spheres,
  triangle-mesh and camera-effects (the last two with an aperture), in
  float32 and in float64.  The plain versions' square root runs as the card
  and the emulation round it, correctly (numpy's): torch's float32 and
  float64 ``sqrt`` on this CPU are vectorised approximations an ulp off on
  a fraction of inputs.  The origins, which take no such root, are held to
  the unchanged plain version too.  K8's pixel decode (32-bit multiply-highs
  by the launcher's reciprocals below 2^32, int64 floor divisions past it)
  bit-equal to ``camera_rays_plain`` with nx and spp each 1, 2, 3, 7, 10,
  1200 and 4095 and with divisors of 2^32 and more, on ids at 0, the
  image's last ray, pixel and row boundaries, 2^31 - 1, 2^32 - 1 and past
  2^32, and on a last chunk padded with its last id, in float32 and
  float64 on the four presets' cameras; K7's row, one 16-byte store, at
  ray counts of partial blocks with ids and domains whose high words are
  set, and its refusal of an output that is not 16-byte aligned.
- ``camera_rays`` on the CPU against the JAX package's
  ``rng.camera_uniforms`` and ``generate_rays``: the uniforms bit-equal, the
  directions within 2e-7 absolute, the origins within 2e-7 absolute or one
  float32 ulp (2^-23 relative): each library takes its own sine, cosine and
  square root, and a last-bit difference in the lens sample moves an
  origin by an ulp, 2.4e-7 where it lies 2-4 units out (camera-effects'
  camera, aperture 2).
- The wrappers refuse what their kernels do not take (no dtype routes
  quietly to the plain version), launch nothing for no rays, raise when
  their library fails to build, and the plain versions of K1-K6 draw
  without them; the graph caches count K7's and K8's launches per replay.
- Marked ``cuda`` (skipped here): on CUDA tensors each wrapper launches its
  kernel (its counter moves by one) and raises when its library fails to
  build.

The JAX package is imported inside the test that compares with it, so
that this file also runs on a GPU host without JAX (``--noconftest``).
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import graphed as dgraphed
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.render import camera as cm
from first_raytracer_tpu_torch.scene.builders import build_preset

MAX_ID = 9_600_000  # the final scene's ray count (1200 x 800 x 10)
SEEDS = (0, 7, -1, (1 << 31) - 1)
DOMAINS = ("int", "0-d", "per-ray")
PRESETS = ("three-spheres", "random-spheres", "triangle-mesh",
           "camera-effects")
# The card's launch code, which ``host_lib`` replaces for this module's
# host tests.
_LAUNCH_ENTRY = mk.launch_entry


def _ids():
    """``tests/test_torch_rng.py``'s ids, and ids past 2^32."""
    r = np.random.RandomState(0)
    return torch.from_numpy(np.concatenate([
        np.arange(64), r.randint(0, MAX_ID, 192),
        [MAX_ID - 1, MAX_ID, (1 << 24) + 1, (1 << 31) - 1],
        [1 << 32, (1 << 32) + 5, (1 << 33) + (1 << 31) - 1,
         (1 << 40) + 12345]]).astype(np.int64))


@pytest.fixture(scope="module")
def host_lib():
    """``rng_rays.cu`` built by g++ for the host, bound as the card's
    library and reached through ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = mk.bind_rng_rays(build_host_library(units=("rng_rays.cu",)))

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


def _ieee_sqrt(x):
    """``torch.sqrt`` correctly rounded, as the card takes it."""
    return torch.from_numpy(np.sqrt(x.detach().numpy()))


def _camera(preset, f64=False):
    scene, cam, cfg = build_preset(preset, nx=24, ny=12, spp=3)
    if f64:
        cam = dataclasses.replace(cam, **{
            f.name: getattr(cam, f.name).double()
            for f in dataclasses.fields(cam)})
    return cam, cfg


@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("seed", SEEDS)
def test_k7_equals_plain(host_lib, seed, domain):
    """K7's uniforms bit-equal to the plain Threefry's: the camera domain
    and bounce 49 by value, a 0-d depth tensor (the trip's and the
    recorder's counter) and a depth per ray (the pool's slots), each with
    the bounce's offset of one."""
    key, ids = rng.base_key(seed), _ids()
    if domain == "int":
        cases = [(0, 0), (49, 1)]
    elif domain == "0-d":
        cases = [(torch.tensor(7), 1), (torch.tensor(0), 0)]
    else:
        depth = torch.from_numpy(
            np.random.RandomState(5).randint(0, 51, ids.shape[0]))
        cases = [(depth, 1), (depth.to(torch.int32), 0)]
    for dom, offset in cases:
        before = rng.uniforms.launches
        got = rng._launch_cuda(key, ids, dom, offset)
        assert rng.uniforms.launches == before + 1
        want = rng.uniforms_plain(key, ids, dom + offset)
        assert got.shape == (ids.shape[0], 4) and got.dtype == torch.float32
        assert torch.equal(got, want)


def test_k7_broadcast_and_raw_keys(host_lib):
    """``precompute_uniforms``' (R, 1) ids against (1, 52) domains through
    K7, and keys given as raw words with the top bits set (masked to 32
    bits, as the plain schedule masks them)."""
    ids = _ids()
    domains = torch.arange(52)
    got = rng._launch_cuda(rng.base_key(3), ids[:, None], domains[None, :],
                           0)
    assert got.shape == (ids.shape[0], 52, 4)
    assert torch.equal(got, rng.precompute_uniforms(rng.base_key(3), ids, 50))
    for words in ((0x9E3779B9, 0xDEADBEEF), (0xFFFFFFFF, 0xFFFFFFFF),
                  (-1, 1 << 40)):
        key = torch.tensor(words, dtype=torch.int64)
        assert torch.equal(rng._launch_cuda(key, ids, 3, 1),
                           rng.uniforms_plain(key, ids, 4))


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("preset", PRESETS)
def test_k8_equals_generate_rays(host_lib, monkeypatch, preset, f64):
    """K8's (origin, direction) bit-equal to ``generate_rays`` on the plain
    camera draw, with the card's square root; the origins also to the
    unchanged plain version."""
    cam, cfg = _camera(preset, f64)
    ids = torch.cat([torch.arange(cfg.num_rays), _ids()[-6:]])
    for seed in (0, -1):
        key = rng.base_key(seed)
        before = cm.camera_rays.launches
        o, d = cm._launch_cuda(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
        assert cm.camera_rays.launches == before + 1
        assert o.dtype == d.dtype == cam.origin.dtype
        assert o.shape == d.shape == (ids.shape[0], 3)
        assert torch.equal(o, cm.camera_rays_plain(cam, cfg.nx, cfg.ny,
                                                   cfg.spp, key, ids)[0])
        with monkeypatch.context() as m:
            m.setattr(torch, "sqrt", _ieee_sqrt)
            wo, wd = cm.camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key,
                                          ids)
        assert torch.equal(o, wo) and torch.equal(d, wd)
        assert float((d.norm(dim=1) - 1).abs().max()) < 1e-6


# Divisors of K8's 32-bit pixel decode (nx and spp each take every one),
# and the ids at its edges: 0, the image's last and first-past ray,
# 2^31 - 1, the last ids below 2^32, and ids past 2^32 (the int64 path).
DIVISORS = (1, 2, 3, 7, 10, 1200, 4095)
EDGE_IDS = (0, (1 << 31) - 1, (1 << 31), (1 << 32) - 2, (1 << 32) - 1,
            1 << 32, (1 << 32) + 5, (1 << 33) + (1 << 31) - 1,
            (1 << 40) + 12345)


def _decode_ids(nx, ny, spp):
    """Ids at the decode's edges for an nx x ny image at spp: ``EDGE_IDS``,
    the image's last ray and the next, the ids on both sides of a pixel's,
    a row's and a multiple of 2^32's boundary, and random ids below
    2^32."""
    r = np.random.RandomState(nx * 7919 + spp)
    per_row = nx * spp
    near = [k * m + e for m in (spp, per_row) for k in (1, 2, 97, 4093)
            for e in (-1, 0, 1)]
    top = [(1 << 32) - 1 - k * spp for k in range(3)] + [
        ((1 << 32) - 1) // per_row * per_row + e for e in (-1, 0, 1)]
    ids = np.concatenate([EDGE_IDS, [nx * ny * spp - 1, nx * ny * spp],
                          near, top, r.randint(0, 1 << 32, 96,
                                               dtype=np.int64)])
    return torch.from_numpy(ids[ids >= 0].astype(np.int64))


def _k8_against_plain(monkeypatch, cam, nx, ny, spp, ids, seed=0):
    """K8 through the host build against ``camera_rays_plain`` with the
    card's square root, origin and direction bit for bit."""
    key = rng.base_key(seed)
    o, d = cm._launch_cuda(cam, nx, ny, spp, key, ids)
    with monkeypatch.context() as m:
        m.setattr(torch, "sqrt", _ieee_sqrt)
        wo, wd = cm.camera_rays_plain(cam, nx, ny, spp, key, ids)
    assert o.dtype == d.dtype == cam.origin.dtype
    assert torch.equal(o, wo) and torch.equal(d, wd)


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("k", range(len(DIVISORS)))
def test_k8_pixel_decode_divisors(host_lib, monkeypatch, k, f64):
    """K8's 32-bit decode (a multiply-high by the launcher's reciprocal)
    and its int64 one bit-equal to ``generate_rays``' floor divisions, with
    nx and spp each taking every divisor of ``DIVISORS``, on ids at the
    decode's edges, in float32 and float64 on the four presets' cameras."""
    nx, spp = DIVISORS[k], DIVISORS[(k + 3) % len(DIVISORS)]
    ny = 1 + DIVISORS[(k + 5) % len(DIVISORS)] % 13
    cam, _ = _camera(PRESETS[k % len(PRESETS)], f64)
    _k8_against_plain(monkeypatch, cam, nx, ny, spp, _decode_ids(nx, ny,
                                                                 spp))


@pytest.mark.parametrize("f64", [False, True], ids=["float32", "float64"])
@pytest.mark.parametrize("preset", PRESETS)
def test_k8_edge_ids(host_lib, monkeypatch, preset, f64):
    """K8 on each preset's own image at the decode's edge ids (2^31 - 1,
    2^32 - 1 and past 2^32) and on the last chunk of a frame of that image
    padded with its last id, as ``render_rays`` pads it."""
    cam, cfg = _camera(preset, f64)
    tail = torch.arange(cfg.num_rays - 5, cfg.num_rays)
    ids = torch.cat([torch.tensor(EDGE_IDS), tail, tail[-1:].expand(11)])
    for seed in (0, -1):
        _k8_against_plain(monkeypatch, cam, cfg.nx, cfg.ny, cfg.spp, ids,
                          seed)


def test_k8_divisors_past_32_bits(host_lib, monkeypatch):
    """A divisor of 2^32 or more takes every id down the int64 path."""
    cam, _ = _camera("random-spheres")
    ids = torch.tensor(EDGE_IDS)
    for nx, spp in (((1 << 32) + 3, 2), (3, (1 << 32) + 1), (1 << 32, 1)):
        _k8_against_plain(monkeypatch, cam, nx, 4, spp, ids)


@pytest.mark.parametrize("n", [1, 3, 255, 256, 257, 1000])
def test_k7_row_is_one_float4(host_lib, n):
    """K7's row, written as one 16-byte store, holds the four uniforms in
    the plain version's order at every ray count of a partial block; the
    ids' and domains' high words never reach the draw."""
    ids = torch.arange(n, dtype=torch.int64) * 40503 + (7 << 32)
    depth = torch.arange(n, dtype=torch.int64) % 51 - (3 << 32)
    key = rng.base_key(11)
    for dom, off in ((depth, 1), (torch.tensor(5 << 33), 2), (3, 0)):
        got = rng._launch_cuda(key, ids, dom, off)
        assert got.shape == (n, 4)
        assert torch.equal(got, rng.uniforms_plain(key, ids, dom + off))


def test_k7_refuses_an_unaligned_row(host_lib, monkeypatch):
    """K7 stores a row as one float4: an output that is not 16-byte
    aligned raises before the launch."""
    real = torch.empty

    def shifted(*args, **kwargs):
        return real(int(np.prod(args[0])) + 1, dtype=kwargs["dtype"],
                    device=kwargs["device"])[1:].view(args[0])
    monkeypatch.setattr(rng.torch, "empty", shifted)
    before = rng.uniforms.launches
    with pytest.raises(RuntimeError, match="16-byte"):
        rng._launch_cuda(rng.base_key(0), torch.arange(8), 0, 0)
    assert rng.uniforms.launches == before


@pytest.mark.parametrize("preset", ["three-spheres", "random-spheres",
                                    "camera-effects"])
def test_camera_rays_match_jax(preset):
    """``camera_rays`` on the CPU against the JAX package's camera draw and
    ``generate_rays`` on the same camera: uniforms bit-equal, directions
    within 2e-7 absolute, origins within 2e-7 or one float32 ulp."""
    import jax.numpy as jnp

    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.render.camera import generate_rays as jrays
    from first_raytracer_tpu.scene import builders as jb
    from first_raytracer_tpu_torch.convert import camera_from_numpy

    _, jc, cfg = jb.build_preset(preset, nx=24, ny=12, spp=3)
    tc = camera_from_numpy(jc)
    ids = np.concatenate([np.arange(cfg.num_rays),
                          [(1 << 31) - 1, 123456789]]).astype(np.int32)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids.astype(np.int64))
    for seed in (0, 7):
        jk, tk = jrng.base_key(seed), rng.base_key(seed)
        np.testing.assert_array_equal(
            rng.camera_uniforms(tk, tids).numpy(),
            np.asarray(jrng.camera_uniforms(jk, jids)))
        o, d = cm.camera_rays(tc, cfg.nx, cfg.ny, cfg.spp, tk, tids)
        jo, jd = jrays(jc, cfg.nx, cfg.ny, cfg.spp, jids,
                       jrng.camera_uniforms(jk, jids))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo),
                                   rtol=2.0 ** -23, atol=2e-7)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0,
                                   atol=2e-7)


def test_k8_refuses_what_it_does_not_take(host_lib):
    """A half, mixed-dtype, misshapen or gradient-carrying camera, 2-D ids
    and an empty image are refused before the launch, not sent to the
    plain version; no rays launch nothing."""
    cam, cfg = _camera("random-spheres")
    ids, key = torch.arange(8), rng.base_key(0)
    bad = {
        "float32 or float64": dataclasses.replace(cam, **{
            f.name: getattr(cam, f.name).half()
            for f in dataclasses.fields(cam)}),
        "lens_radius": dataclasses.replace(
            cam, lens_radius=cam.lens_radius.double()),
        "camera.u": dataclasses.replace(cam, u=cam.u[:2]),
        "requires grad": dataclasses.replace(
            cam, origin=cam.origin.clone().requires_grad_(True)),
    }
    for match, c in bad.items():
        with pytest.raises(ValueError, match=match):
            cm._launch_cuda(c, cfg.nx, cfg.ny, cfg.spp, key, ids)
    with pytest.raises(ValueError, match="1-D"):
        cm._launch_cuda(cam, cfg.nx, cfg.ny, cfg.spp, key, ids[None])
    with pytest.raises(ValueError, match="image size"):
        cm._launch_cuda(cam, cfg.nx, cfg.ny, 0, key, ids)
    before = cm.camera_rays.launches, rng.uniforms.launches
    o, d = cm._launch_cuda(cam, cfg.nx, cfg.ny, cfg.spp, key, ids[:0])
    u = rng._launch_cuda(key, ids[:0], 0, 0)
    assert o.shape == d.shape == (0, 3) and u.shape == (0, 4)
    assert (cm.camera_rays.launches, rng.uniforms.launches) == before


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions: another device has no
    kernel."""
    cam, cfg = _camera("three-spheres")
    ids = torch.arange(4, device="meta")
    with pytest.raises(ValueError, match="device"):
        rng.camera_uniforms(rng.base_key(0), ids)
    with pytest.raises(ValueError, match="device"):
        rng.bounce_uniforms(rng.base_key(0), ids, 3)
    with pytest.raises(ValueError, match="device"):
        cm.camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, rng.base_key(0), ids)


def test_failed_build_raises(monkeypatch):
    """A library that fails to build raises out of the wrappers' launch
    code: nothing falls back to the plain versions."""
    def no_library():
        raise RuntimeError("nvcc failed (1): no compiler")

    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    monkeypatch.setattr(mk, "load_mega_library", no_library)
    cam, cfg = _camera("three-spheres")
    ids, key = torch.arange(8), rng.base_key(0)
    before = cm.camera_rays.launches, rng.uniforms.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rng._launch_cuda(key, ids, 0, 1)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cm._launch_cuda(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    assert (cm.camera_rays.launches, rng.uniforms.launches) == before


def test_plain_megakernel_draws_without_k7_k8(monkeypatch):
    """K1-K3t's plain versions take ``uniforms_plain`` directly, so that on
    the card a comparison with them is a comparison with torch ops."""
    def refused(*args, **kwargs):
        raise AssertionError("a plain version called a K7 or K8 wrapper")

    monkeypatch.setattr(rng, "uniforms", refused)
    monkeypatch.setattr(cm, "camera_rays", refused)
    scene, cam, cfg = build_preset("three-spheres", nx=8, ny=4, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=6)
    rad, segs = mk.render_pixels_mega_reference(
        mk.pack_scene_mega(scene), cam, cfg, rng.base_key(0))
    assert bool(torch.isfinite(rad).all()) and int(segs.sum()) > 0


def test_graph_caches_count_k7_and_k8():
    """K7's and K8's counters are among those the graph caches take off a
    capture and add back per replay."""
    counters = dgraphed.launch_counters()
    assert (rng.uniforms, "launches") in counters
    assert (cm.camera_rays, "launches") in counters
    before = dgraphed.launches_now()
    rng.uniforms.launches += 2
    cm.camera_rays.launches += 1
    made = dgraphed.take_launches(before)
    assert dgraphed.launches_now() == before
    assert sorted((fn.__name__, n) for fn, _, n in made) == [
        ("camera_rays", 1), ("uniforms", 2)]
    dgraphed.add_launches(made)
    dgraphed.add_launches(made)
    assert rng.uniforms.launches - dict(
        (fn, n) for fn, _, n in before)[rng.uniforms] == 4
    dgraphed.take_launches(before)


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K7 and K8 are CUDA kernels")
    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_wrappers_launch_their_kernels(cuda_device):
    """On CUDA tensors the draws launch K7 and the camera rays K8, once a
    call, bit-equal to their plain versions on the card."""
    cam, cfg = _camera("random-spheres")
    cam = cam.to(cuda_device)
    ids = torch.arange(cfg.num_rays, device=cuda_device)
    key = rng.base_key(0).to(cuda_device)
    depth = torch.randint(0, 51, ids.shape, device=cuda_device)
    for call, plain in (
            (lambda: rng.camera_uniforms(key, ids),
             lambda: rng.uniforms_plain(key, ids, 0)),
            (lambda: rng.bounce_uniforms(key, ids, depth),
             lambda: rng.uniforms_plain(key, ids, depth + 1))):
        before = rng.uniforms.launches
        got = call()
        torch.cuda.synchronize()
        assert rng.uniforms.launches == before + 1
        assert torch.equal(got, plain())
    before = cm.camera_rays.launches
    o, d = cm.camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    torch.cuda.synchronize()
    assert cm.camera_rays.launches == before + 1
    wo, wd = cm.camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    assert torch.equal(o, wo) and torch.equal(d, wd)


@pytest.mark.cuda
def test_cuda_failed_build_raises(cuda_device, monkeypatch):
    """On the card a library that fails to build raises; no plain
    fallback."""
    def no_library():
        raise RuntimeError("nvcc failed (1): no compiler")

    monkeypatch.setattr(mk, "load_mega_library", no_library)
    cam, cfg = _camera("three-spheres")
    ids = torch.arange(8, device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rng.camera_uniforms(rng.base_key(0), ids)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cm.camera_rays(cam.to(cuda_device), cfg.nx, cfg.ny, cfg.spp,
                       rng.base_key(0), ids)
