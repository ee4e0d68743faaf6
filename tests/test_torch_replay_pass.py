"""K14 and K15, the tape replay's value and gradient, on the CPU.

Their source (``kernels/csrc/replay.cu``), compiled by g++ through the host
emulation (``kernels/host_emu``) and driven by the wrappers' own launch code
on CPU tensors (``diff/replay_pass.py::replay_kernels``, ``launch_entry``
pointed at the host build), against the plain loop
(``replay_plain``, its bare ``torch.sqrt`` and ``torch.sin`` rounded as the
card and the emulation round them where the forward is compared bit for
bit) and against the JAX package, on JAX's tape and rays
(``tests/test_torch_replay.py``'s setup):

- float32 radiance ``torch.equal`` to the plain loop's: three-spheres,
  triangle-mesh and camera-effects at 12x6 @ 2, depth 8, random-spheres at
  16x8 @ 2, depth 50;
- float32 gradients through K14 and K15 (``render_loss_and_grads_tape``)
  against JAX's ``render_loss_and_grads_tape`` at
  ``tests/test_torch_replay.py``'s bounds: shallow presets ``rtol=1e-4,
  atol=1e-6``, random-spheres each gradient's cosine >= 0.999 and its norm
  within 3%;
- float64 gradients against the plain loop's autograd in float64: relative
  L2 error <= 1e-8 per field (measured at most 7e-14, on random-spheres'
  sphere_center and sphere_radius), the check of the hand-derived backward
  that does not rest on rounding; the loss within 1e-12.

Also: the bucketed path through the kernels (the same gradients as the
flat one up to float32 summation order, and as the bucketed plain loop), a
mixed sphere and triangle field, rays whose recorded id no longer hits
(the re-hit fails, shaded as a miss), a dielectric triangle hit from
behind past the critical angle (total internal reflection), a column
slice of a wider tape, the wrapper's refusals and counters, the CPU's
route to the plain loop, and a failed build, which raises.

The JAX package is imported by ``tests/test_torch_replay.py``'s setup.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from first_raytracer_tpu_torch.convert import params_from_numpy
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import grad as tg
from first_raytracer_tpu_torch.diff import graphed as dgraphed
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.diff import replay_pass as rp
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.render.camera import camera_rays_plain
from first_raytracer_tpu_torch.scene.builders import build_preset
from test_torch_replay import CASES, SHALLOW, _case, _port_rays
from test_torch_wavefront_pass import _LAUNCH_ENTRY, _card_rounding

F64_BOUND = 1e-8


@pytest.fixture(scope="module")
def host_lib():
    """``replay.cu`` built by g++ for the host, bound as the card's library
    and reached through ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = mk.bind_replay(build_host_library(units=("replay.cu",)))

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


@pytest.fixture
def kernels(host_lib, monkeypatch):
    """``trace_rays_replay`` (and every caller of it) through K14 and K15
    on CPU tensors, as a CUDA device runs it."""
    monkeypatch.setattr(trp, "replay", rp.replay_kernels)


def _f64(scene):
    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).double()
        for f in dataclasses.fields(scene)
        if getattr(scene, f.name).is_floating_point()})


def _radiance_equal(scene, o, d, ids, key, cfg, tape):
    """K14's float32 radiance against the plain loop's, bit for bit;
    returns it."""
    before = rp.replay.launches
    with torch.no_grad():
        got = rp.replay_kernels(scene, o, d, ids, key, cfg, tape)
        with _card_rounding():
            want = rp.replay_plain(scene, o, d, ids, key, cfg, tape)
    assert rp.replay.launches == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)
    return got


def _f64_grads_equal(scene, o, d, ids, key, cfg, tape, target=None):
    """K15's float64 gradients of the mean squared error against the plain
    loop's autograd: relative L2 error <= F64_BOUND per field; returns the
    largest error."""
    s64 = _f64(scene)
    o, d = o.double(), d.double()
    target = torch.zeros(o.shape, dtype=torch.float64) if target is None \
        else target.double()
    params, _ = tg.split_params(s64)

    def loss(fn):
        return lambda p: torch.mean(
            (fn(tg.merge_params(s64, p), o, d, ids, key, cfg, tape)
             - target) ** 2)
    before = rp.replay.backward_launches
    l_k, g_k = tg.value_and_grad(loss(rp.replay_kernels), params)
    assert rp.replay.backward_launches == before + 1
    l_p, g_p = tg.value_and_grad(loss(rp.replay_plain), params)
    assert abs(float(l_k) - float(l_p)) <= 1e-12 * abs(float(l_p))
    worst = 0.0
    for k in g_p:
        assert g_k[k].dtype == torch.float64, k
        n = float(g_p[k].norm())
        err = float((g_k[k] - g_p[k]).norm())
        if n == 0.0:
            assert err == 0.0, k
            continue
        assert err / n <= F64_BOUND, (k, err / n)
        worst = max(worst, err / n)
    return worst


@pytest.mark.parametrize("name", CASES)
def test_forward_equals_plain(host_lib, name):
    p, _ = _case(name)
    o, d = _port_rays(p)
    _radiance_equal(p["scene"], o, d, p["ids"], p["key"], p["cfg"],
                    p["tape"])


@pytest.mark.parametrize("name", CASES)
def test_float32_grads_match_jax(kernels, name):
    p, want = _case(name)
    before = rp.replay.backward_launches
    loss, grads = tg.render_loss_and_grads_tape(
        params_from_numpy(p["params"]), p["scene"], p["camera"], p["cfg"],
        p["key"], p["ids"], p["target"], p["tape"])
    assert rp.replay.backward_launches == before + 1
    got = {k: v.numpy() for k, v in grads.items()}
    if name in SHALLOW:
        np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-5)
        for k, g in want["grads"].items():
            np.testing.assert_allclose(got[k], g, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        return
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-4)
    for k, g in want["grads"].items():
        a, b = g.ravel(), got[k].ravel()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0.0:
            assert nb == 0.0, k
            continue
        assert a @ b / (na * nb) >= 0.999, k
        assert abs(nb / na - 1.0) <= 0.03, k


@pytest.mark.parametrize("name", CASES)
def test_float64_grads_match_plain(host_lib, name):
    p, _ = _case(name)
    o, d = _port_rays(p)
    target = torch.from_numpy(np.random.RandomState(3).rand(
        *p["target"].shape))
    _f64_grads_equal(p["scene"], o, d, p["ids"], p["key"], p["cfg"],
                     p["tape"], target)


def test_bucketed_matches_flat(kernels):
    """The bucketed step through the kernels (each bucket a column slice
    of the sorted tape) gives the flat step's gradients up to float32
    summation order (tests/test_torch_replay.py's bounds), and the plain
    loop's bucketed step's."""
    p, _ = _case("random-spheres")
    params = params_from_numpy(p["params"])
    target = torch.from_numpy(np.random.RandomState(0).rand(
        *p["target"].shape).astype(np.float32))
    args = (p["scene"], p["camera"], p["cfg"], p["key"], p["ids"], target,
            p["tape"])
    l_flat, g_flat = tg.render_loss_and_grads_tape(params, *args)
    before = rp.replay.launches
    l_b, g_b = tg.render_loss_and_grads_bucketed(params, *args)
    groups = trp.plan_buckets(p["tape"], 4)[1]
    assert len(groups) > 1 and rp.replay.launches == before + len(groups)
    np.testing.assert_allclose(float(l_b), float(l_flat), rtol=1e-5)
    for k in g_flat:
        np.testing.assert_allclose(g_b[k].numpy(), g_flat[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    order, groups = trp.plan_buckets(p["tape"], 4)
    l_p, g_p = tg.bucketed_loss_and_grads(
        params, p["scene"], p["camera"], p["key"], p["ids"], target,
        p["tape"], order, cfg=p["cfg"], groups=groups,
        num_values=target.numel())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trp, "replay", rp.replay_plain)
        l_q, g_q = tg.bucketed_loss_and_grads(
            params, p["scene"], p["camera"], p["key"], p["ids"], target,
            p["tape"], order, cfg=p["cfg"], groups=groups,
            num_values=target.numel())
    np.testing.assert_allclose(float(l_p), float(l_q), rtol=1e-6)
    for k in g_q:
        np.testing.assert_allclose(g_p[k].numpy(), g_q[k].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def _own_case(scene, cam, cfg, seed=1):
    """Camera rays, ids, key and the lockstep recorder's tape (trimmed) of
    a port scene."""
    key, ids = rng.base_key(seed), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    tape = trp.record_paths(scene, o, d, ids, key, cfg)
    return o, d, ids, key, tape[:trp.live_trips(tape)]


def test_mixed_field(host_lib):
    """A triangle field with its feature spheres: rows of both tables, the
    spheres first in the ids; every material a checker, so that both
    colours of both tables take gradients."""
    scene, cam, cfg = build_preset("triangle-field", n=300, nx=12, ny=6,
                                   spp=2)
    scene = dataclasses.replace(
        scene, tex_type=torch.ones_like(scene.tex_type),
        tex_scale=torch.full_like(scene.tex_scale, 7.0))
    cfg = dataclasses.replace(cfg, max_depth=6)
    o, d, ids, key, tape = _own_case(scene, cam, cfg)
    assert scene.num_spheres and scene.num_triangles
    hit = tape[tape >= 0]
    assert bool((hit < scene.num_spheres).any())
    assert bool((hit >= scene.num_spheres).any())
    _radiance_equal(scene, o, d, ids, key, cfg, tape)
    _f64_grads_equal(scene, o, d, ids, key, cfg, tape)
    s64 = _f64(scene)
    params, _ = tg.split_params(s64, fields=("albedo", "albedo2"))
    _, g = tg.value_and_grad(lambda q: rp.replay_kernels(
        tg.merge_params(s64, q), o.double(), d.double(), ids, key, cfg,
        tape).sum(), params)
    tri_mats = scene.tri_mat.long().unique()
    for k in g:
        assert float(g[k][tri_mats].abs().sum()) > 0.0, k


def test_failed_rehit_is_a_miss(host_lib):
    """Rays that missed everything at row 1, given a sphere's id there:
    the re-solved hit fails (t = BIG), so the row is shaded as a miss, the
    sky at that row, as the plain loop does, and the radiance is the
    recorded tape's."""
    p, _ = _case("three-spheres")
    o, d = _port_rays(p)
    tape = p["tape"].clone()
    sky_rows = (tape[0] >= 0) & (tape[1] < 0)
    tape[1] = torch.where(sky_rows, 2, tape[1])
    args = (p["scene"], o, d, p["ids"], p["key"], p["cfg"])
    got = _radiance_equal(*args, tape)
    before = _radiance_equal(*args, p["tape"])
    assert int(sky_rows.sum()) >= 10
    assert torch.equal(got, before)
    _f64_grads_equal(*args, tape)


def test_total_internal_reflection(host_lib):
    """Rays that reach glass triangles from behind at 63 degrees from the
    normal (triangle-mesh's metal triangles given its glass material, index
    1.5): past the critical angle, so the dielectric reflects them all; the
    triangles' vertices get a gradient through the reflection."""
    scene, cam, cfg = build_preset("triangle-mesh", nx=12, ny=6, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=6)
    glass_mat = int(torch.nonzero(scene.mat_type == 2)[0, 0])
    metal = scene.mat_type[scene.tri_mat.long()] == 1
    scene = dataclasses.replace(scene, tri_mat=torch.where(
        metal, glass_mat, scene.tri_mat).to(torch.int32))
    assert float(scene.ref_idx[glass_mat]) == 1.5
    glass = torch.nonzero(metal)[:, 0]
    v0, v1, v2 = (t[glass] for t in (scene.tri_v0, scene.tri_v1,
                                     scene.tri_v2))
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / n.norm(dim=1, keepdim=True)
    u = (v1 - v0) / (v1 - v0).norm(dim=1, keepdim=True)
    r = np.random.RandomState(5)
    w = torch.from_numpy(r.dirichlet([2.0, 2.0, 2.0], (len(glass), 16))
                         .astype(np.float32))            # (G, 16, 3)
    point = (w[..., 0:1] * v0[:, None] + w[..., 1:2] * v1[:, None]
             + w[..., 2:3] * v2[:, None])
    ang = np.deg2rad(63.0)
    d = (np.cos(ang) * n + np.sin(ang) * u)[:, None].expand_as(point)
    d = (d / d.norm(dim=-1, keepdim=True)).reshape(-1, 3).contiguous()
    o = (point.reshape(-1, 3) - 0.25 * d).contiguous()
    ids = torch.arange(o.shape[0])
    key = rng.base_key(2)
    tape = trp.record_paths(scene, o, d, ids, key, cfg)
    first = tape[0].long() - scene.num_spheres
    assert int((first == glass.repeat_interleave(16)).sum()) >= 32
    # (d . n) > 0 on a glass triangle with 1 - 1.5^2 (1 - (d . n)^2) < 0.
    dn = (d * n.repeat_interleave(16, dim=0)).sum(dim=1)
    assert bool((dn > 0).all() & (1 - 2.25 * (1 - dn * dn) < 0).all())
    _radiance_equal(scene, o, d, ids, key, cfg, tape)
    assert _f64_grads_equal(scene, o, d, ids, key, cfg, tape) >= 0.0
    s64 = _f64(scene)
    params, _ = tg.split_params(s64, fields=("tri_v0", "tri_v1", "tri_v2"))
    _, g = tg.value_and_grad(lambda q: rp.replay_kernels(
        tg.merge_params(s64, q), o.double(), d.double(), ids, key, cfg,
        tape).sum(), params)
    assert all(float(g[k][glass].abs().sum()) > 0 for k in g)


def test_column_slice_of_a_wider_tape(host_lib):
    """A tape that is a column slice of a wider one (its row stride larger
    than its rays) gives what its contiguous copy gives."""
    p, _ = _case("random-spheres")
    o, d = _port_rays(p)
    lo, hi = 40, 200
    sl = p["tape"][:, lo:hi]
    assert sl.stride(0) > sl.shape[1] and not sl.is_contiguous()
    args = (p["scene"], o[lo:hi], d[lo:hi], p["ids"][lo:hi], p["key"],
            p["cfg"])
    a = _radiance_equal(*args, sl)
    b = _radiance_equal(*args, sl.contiguous())
    assert torch.equal(a, b)
    _f64_grads_equal(*args, sl)


def test_refusals(host_lib):
    """The wrapper refuses what K14 and K15 do not take."""
    p, _ = _case("three-spheres")
    o, d = _port_rays(p)
    scene, ids, key, cfg, tape = (p["scene"], p["ids"], p["key"], p["cfg"],
                                  p["tape"])

    def call(**kw):
        a = dict(scene=scene, origin=o, direction=d, ray_ids=ids, key=key,
                 cfg=cfg, tape=tape)
        a.update(kw)
        return rp.replay_kernels(**a)
    with pytest.raises(ValueError, match="float32 or float64"):
        call(origin=o.half(), direction=d.half())
    with pytest.raises(ValueError, match="direction"):
        call(direction=d.double())
    with pytest.raises(ValueError, match="payload table"):
        call(origin=o.double(), direction=d.double())
    with pytest.raises(ValueError, match="requires grad"):
        call(origin=o.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="requires grad"):
        call(direction=d.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="ray_ids"):
        call(ray_ids=ids[:-1])
    with pytest.raises(ValueError, match="tape"):
        call(tape=tape.long())
    with pytest.raises(ValueError, match="tape"):
        call(tape=tape[:, :-1])
    with pytest.raises(ValueError, match="strides"):
        call(tape=tape.t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        call(origin=torch.cat([o, o], dim=1)[:, ::2])
    with pytest.raises(ValueError, match="primitive"):
        call(scene=dataclasses.replace(
            scene, sphere_center=scene.sphere_center[:0],
            sphere_radius=scene.sphere_radius[:0],
            sphere_mat=scene.sphere_mat[:0]))
    with pytest.raises(ValueError, match="no replay kernel"):
        rp.replay(scene, o.to("meta"), d.to("meta"), ids, key, cfg, tape)


def test_counters_and_the_cpu_route(host_lib):
    """On CPU tensors ``replay`` runs the plain loop (no launch), bit for
    bit; the kernels' route counts one K14 a forward and one K15 a
    backward, no K15 where no gradient is taken; the graph caches take
    both counters off a capture and add them back per replay."""
    p, _ = _case("camera-effects")
    o, d = _port_rays(p)
    args = (p["scene"], o, d, p["ids"], p["key"], p["cfg"], p["tape"])
    n14, n15 = rp.replay.launches, rp.replay.backward_launches
    with torch.no_grad():
        got = rp.replay(*args)
        assert torch.equal(got, rp.replay_plain(*args))
        assert trp.trace_rays_replay(*args).equal(got)
    assert (rp.replay.launches, rp.replay.backward_launches) == (n14, n15)
    with torch.no_grad():
        rp.replay_kernels(*args)
    params, _ = tg.split_params(p["scene"], fields=("albedo",))
    tg.value_and_grad(lambda q: rp.replay_kernels(
        tg.merge_params(p["scene"], q), *args[1:]).sum(), params)
    assert (rp.replay.launches, rp.replay.backward_launches) == (n14 + 2,
                                                                 n15 + 1)
    counters = dgraphed.launch_counters()
    assert (rp.replay, "launches") in counters
    assert (rp.replay, "backward_launches") in counters
    before = dgraphed.launches_now()
    rp.replay.launches += 2
    rp.replay.backward_launches += 1
    made = dgraphed.take_launches(before)
    assert dgraphed.launches_now() == before
    assert sorted((attr, n) for _, attr, n in made) == [
        ("backward_launches", 1), ("launches", 2)]


def test_failed_build_raises(monkeypatch):
    """A library that fails to build raises out of the wrapper's launch
    code, forward and backward: nothing falls back to the plain loop."""
    def no_library():
        raise RuntimeError("nvcc failed (1): no compiler")

    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    monkeypatch.setattr(mk, "load_mega_library", no_library)
    p, _ = _case("three-spheres")
    o, d = _port_rays(p)
    args = (p["scene"], o, d, p["ids"], p["key"], p["cfg"], p["tape"])
    n14, n15 = rp.replay.launches, rp.replay.backward_launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rp.replay_kernels(*args)
    sph, tri = rp._payload_tables(p["scene"])
    end = torch.zeros((o.shape[0],), dtype=torch.int32)
    hist = torch.zeros((p["tape"].shape[0],), dtype=torch.int32)
    save = torch.zeros((p["tape"].shape[0], o.shape[0], rp.SAVE_COLS))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rp.launch_backward(sph.detach(), None, p["ids"],
                           rng.device_key(p["key"], o.device), p["tape"],
                           p["cfg"].max_depth, p["cfg"].t_min, save, end,
                           hist, torch.ones_like(o))
    assert (rp.replay.launches, rp.replay.backward_launches) == (n14, n15)


# K15's order and sum on chosen rays of a recorded pool: the rays each case
# selects (by their miss row under K14, or their first hit), replayed
# through K14 and K15 against the plain loop.
POOL_RAYS = dict(nx=32, ny=16, spp=2)


@functools.lru_cache(maxsize=None)
def _pool(name):
    """(scene, cfg, o, d, ids, key, tape, end) of a pool of recorded rays:
    the final scene's sphere grid (random-spheres), or a field of 600
    spheres (a row apiece for most rays); ``end`` is K14's miss row of each
    ray on the host build."""
    if name == "field":
        scene, cam, cfg = build_preset("sphere-field", n=600, nx=32, ny=16,
                                       spp=2)
    else:
        scene, cam, cfg = build_preset("random-spheres", **POOL_RAYS)
    o, d, ids, key, tape = _own_case(scene, cam, cfg, seed=4)
    return scene, cfg, o, d, ids, key, tape


@functools.lru_cache(maxsize=None)
def _mirrors():
    """Rays between two facing mirrors (metal spheres of radius 1000, their
    caps at y = -1 and 1) at 1.2-1.5 rad from the plane: 23-50 bounces
    before they leave, so that most sweeps pass 32 rows (two of a deep
    warp's rounds), and a few rays cut at the depth cap."""
    from first_raytracer_tpu_torch.render.integrator import RenderConfig
    from first_raytracer_tpu_torch.scene.builders import SceneBuilder
    b = SceneBuilder()
    mirror = b.metal((0.9, 0.85, 0.8), fuzz=0.02)
    b.sphere((0.0, -1001.0, 0.0), 1000.0, mirror)
    b.sphere((0.0, 1001.0, 0.0), 1000.0, mirror)
    b.sphere((0.0, 0.0, 0.0), 0.3, b.lambertian((0.5, 0.5, 0.5)))
    scene = b.build("cpu")
    r = np.random.RandomState(0)
    n = 64
    ang, up = r.uniform(0, 2 * np.pi, n), r.uniform(2, 10, n)
    d = np.stack([np.cos(ang), up, np.sin(ang)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = 0.5 * np.stack([np.cos(ang), np.zeros(n), np.sin(ang)], 1)
    o, d = (torch.tensor(v, dtype=torch.float32) for v in (o, d))
    cfg = RenderConfig(nx=8, ny=8, spp=1, max_depth=50)
    ids, key = torch.arange(n), rng.base_key(3)
    tape = trp.record_paths(scene, o, d, ids, key, cfg)
    return scene, cfg, o, d, ids, key, tape[:trp.live_trips(tape)]


def _end_of(host_lib, scene, o, d, ids, key, cfg, tape):
    """K14's end rows and histogram of the rays (the host build)."""
    sph, tri = rp._payload_tables(scene)
    _, _, end, hist = rp.launch_forward(
        None if sph is None else sph.detach(),
        None if tri is None else tri.detach(), o, d, ids,
        rng.device_key(key, o.device), tape, cfg.max_depth, cfg.t_min)
    return end, hist


def _select(host_lib, case):
    """(scene, cfg, o, d, ids, key, tape) of the case's rays."""
    if case == "deep rays":
        return _mirrors()
    scene, cfg, o, d, ids, key, tape = _pool(
        "field" if case == "global rows" else "grid")
    end, _ = _end_of(host_lib, scene, o, d, ids, key, cfg, tape)
    r = np.random.RandomState(9)
    if case == "one deep ray":
        # The deepest ray among 63 that miss by row 2, placed mid-warp.
        shallow = torch.nonzero((end >= 0) & (end <= 2))[:, 0].numpy()
        pick = list(r.choice(shallow, 63, replace=False))
        pick.insert(37, int(torch.argmax(end)))
    elif case == "ground":
        # Rays whose first hit is the ground sphere: a block's lanes on one
        # payload row at row 0.
        ground = int(torch.argmax(scene.sphere_radius))
        pick = torch.nonzero(tape[0] == ground)[:, 0].numpy()[:300]
    elif case == "spread":
        # Up to 6 rays of each miss row, 0 to the deepest.
        pick = []
        for e in range(int(end.max()) + 1):
            at = torch.nonzero(end == e)[:, 0].numpy()
            pick += list(r.permutation(at)[:6])
        r.shuffle(pick)
    elif case == "absorbed and cut":
        # The depth cap at 3 on the full tape: rays alive past it are cut
        # (no radiance), beside rays absorbed by metals and rays that miss.
        cfg = dataclasses.replace(cfg, max_depth=3)
        pick = list(range(0, o.shape[0], 3))
    elif case == "bucket slice":
        order, groups = trp.plan_buckets(tape, 4)
        g0, n, trips = max(groups, key=lambda g: g[2])
        pick = order[g0:g0 + n]
        sl = tape.index_select(1, order)[:trips, g0:g0 + n]
        return scene, cfg, o[pick], d[pick], ids[pick], key, sl
    else:  # global rows
        pick = list(range(o.shape[0]))
    pick = torch.as_tensor(np.asarray(pick, dtype=np.int64))
    return (scene, cfg, o[pick], d[pick], ids[pick], key,
            tape[:, pick].contiguous())


ORDER_CASES = ["one deep ray", "ground", "spread", "absorbed and cut",
               "bucket slice", "global rows", "deep rays"]


@pytest.mark.parametrize("case", ORDER_CASES)
def test_sweep_cases_equal_plain(host_lib, case):
    """K14 ``torch.equal`` to the plain loop and K15's float64 gradients
    within 1e-8 of its autograd on rays chosen to load the order and the
    sum: one deep ray among shallow ones, every lane on the ground's row,
    miss rows spread over 0 to the deepest, rays cut at the cap or
    absorbed (end = -1), a bucket's column slice of the sorted tape, a
    field whose rows take the global sum, and rays between two mirrors
    whose sweeps pass 32 rows (a deep warp's second round)."""
    scene, cfg, o, d, ids, key, tape = _select(host_lib, case)
    end, _ = _end_of(host_lib, scene, o, d, ids, key, cfg, tape)
    if case == "one deep ray":
        assert int(end.max()) >= 8 and int((end > 2).sum()) == 1
    elif case == "ground":
        assert o.shape[0] >= 256
    elif case == "spread":
        assert int(end.max()) >= 8 and len(set(end.tolist())) >= 8
    elif case == "absorbed and cut":
        assert int((end < 0).sum()) >= 10 and int((end >= 0).sum()) >= 10
    elif case == "bucket slice":
        assert tape.stride(0) > tape.shape[1] and tape.shape[1] >= 32
    elif case == "deep rays":
        assert int((end > 32).sum()) >= 32 and int((end < 0).sum()) >= 1
    else:
        # Most rows are hit by fewer rays than claim a shared row.
        _, hits = torch.unique(tape[tape >= 0], return_counts=True)
        assert int((hits < rp.HOT_PEERS).sum()) > 128
    _radiance_equal(scene, o, d, ids, key, cfg, tape)
    _f64_grads_equal(scene, o, d, ids, key, cfg, tape)


@pytest.mark.parametrize("case", ORDER_CASES)
def test_order_is_deepest_first(host_lib, case):
    """K14's histogram counts the rays by miss row, and K15's order is a
    permutation of the rays with a miss row (end >= 0), deepest first."""
    scene, cfg, o, d, ids, key, tape = _select(host_lib, case)
    end, hist = _end_of(host_lib, scene, o, d, ids, key, cfg, tape)
    hit = end[end >= 0].long()
    assert torch.equal(hist.long(), torch.bincount(
        hit, minlength=tape.shape[0]))
    perm = rp.launch_order(end, hist).long()
    assert torch.equal(torch.sort(perm).values,
                       torch.nonzero(end >= 0)[:, 0])
    depth = end[perm]
    assert bool((depth[:-1] >= depth[1:]).all())


@pytest.mark.parametrize("n", [1500, 5000])
def test_order_across_blocks(host_lib, n):
    """K15's order of more rays than one block of the order's launch takes
    (1024): each block's runs land after the cursors' earlier ones, the
    whole a permutation of the rays with a miss row, deepest first."""
    r = np.random.RandomState(n)
    end = torch.from_numpy(np.where(r.rand(n) < 0.1, -1,
                                    r.geometric(0.4, n) - 1).clip(max=50)
                           .astype(np.int32))
    hist = torch.bincount(end[end >= 0].long(), minlength=51).int()
    perm = rp.launch_order(end, hist).long()
    assert torch.equal(torch.sort(perm).values,
                       torch.nonzero(end >= 0)[:, 0])
    depth = end[perm]
    assert bool((depth[:-1] >= depth[1:]).all())


def test_emulated_atomic_cas(tmp_path):
    """The host emulation's atomicCAS (K15's claim of a shared row):
    swaps only where the word holds the expected value, and returns what
    it held."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the emulation")
    from first_raytracer_tpu_torch.kernels.host_emu.build import HERE
    src = tmp_path / "cas.cc"
    src.write_text("""
#include <cuda_runtime.h>
int main() {
  unsigned long long w = ~0ull;
  if (atomicCAS(&w, ~0ull, 7ull) != ~0ull || w != 7ull) return 1;
  if (atomicCAS(&w, ~0ull, 9ull) != 7ull || w != 7ull) return 2;
  if (atomicCAS(&w, 7ull, 3ull) != 7ull || w != 3ull) return 3;
  return 0;
}
""")
    exe = tmp_path / "cas"
    subprocess.run(["g++", "-std=c++20", "-I", HERE, "-o", str(exe),
                    str(src)], check=True)
    assert subprocess.run([str(exe)]).returncode == 0
