"""K11 (the dense closest hit), K12 (the recorders' pass: lockstep, length
and pool modes) and K13 (the pool recorder's regeneration) on the CPU, and
the recorders and the occupancy scan that run through them.

- Their sources (``kernels/csrc/dense_hit.cu``, ``wavefront_pass.cu``),
  compiled by g++ through the host emulation (``kernels/host_emu``) and
  driven by the wrappers' own launch code on CPU tensors, against their
  plain versions on clones of the same state, ``torch.equal`` on every
  tensor: K11 against ``intersect_brute`` (prim, t, hit) on camera rays
  and one bounce's rays of spheres only (random-spheres: every material,
  the checker ground), triangles only (triangle-mesh's), both
  (triangle-mesh, and a field of 1100 spheres past a tile of 512, and a
  triangle field past a tile of 256 with its feature spheres),
  camera-effects (a checker, a lens), and exact ties (every sphere twice,
  every triangle twice, rays down the shared edge of two triangles: the
  lowest id wins); K12 bounce by bounce against ``record_step_plain`` in
  lockstep mode (the tape) and length mode (the lengths), through the last
  live bounce and inert bounces past the depth cap, and at a bounce
  counter past ``max_depth`` (the scratch row), the counter advanced once
  a bounce; K12's pool launch, K13 folded in, pass by pass against
  ``record_shade_plain`` then ``record_regenerate_plain`` (the flat tape's
  last entry aside, which the plain pass scatters its non-writing lanes to
  and nothing reads), over pools of 1 and 3 tiles with 4 blocks in flight
  (``frt_emu_interleave``) and inert passes after the stream ends, K12's
  scan words checked, and over 40 tiles with every block in flight and
  stale status words of an earlier pass.
  The plain versions' bare ``torch.sqrt`` and ``torch.sin`` run as the card
  and the emulation round them (``test_torch_wavefront_pass._card_rounding``).
- The split plain versions compose to the pool recorder's pass as it was
  before the split (its body, copied here): every tensor of the state,
  the flat tape's last entry included, ``torch.equal``, pass by pass.
- The lockstep and pool recorders and the occupancy scan with their seams
  on the host build (K11, K12, K13), against the JAX package's
  ``record_paths``, ``record_paths_pool`` and ``wavefront_occupancy`` at
  ``tests/test_torch_replay.py``'s and ``tests/test_torch_metrics.py``'s
  bounds (tapes: under 0.5% of entries parted, the entries where the two
  packages' tapes without a kernel part; occupancy: the counts equal), and
  ``torch.equal`` to the same loops on the plain versions.
- The wrappers refuse what their kernels do not take, launch nothing for
  no rays (but K12's lockstep mode, whose one block advances the counter),
  raise when the library fails to build, leave the CPU on the plain
  versions, and the graph caches count K11's, K12's and K13's launches per
  replay.

The JAX package is imported inside the test that compares with it.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import contextlib
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.core.vecmath import constant
from first_raytracer_tpu_torch.diff import graphed as dgraphed
from first_raytracer_tpu_torch.diff import record_pass as rp
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.kernels import dense_hit as dh
from first_raytracer_tpu_torch.geometry.sphere import BIG
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.materials.scatter import scatter
from first_raytracer_tpu_torch.render import integrator
from first_raytracer_tpu_torch.render.camera import camera_rays_plain
from first_raytracer_tpu_torch.render.integrator import (UP, intersect_brute,
                                                         recompute_hit)
from first_raytracer_tpu_torch.scene.builders import build_preset
from test_torch_wavefront_pass import (_LAUNCH_ENTRY, _card_rounding,
                                       _clone, _interleaved)

SETS = ("random-spheres", "triangles-only", "triangle-mesh",
        "camera-effects", "field1100", "mixed-field")


def _scene(name):
    """(scene, camera, cfg) of a set, small."""
    if name == "random-spheres":
        return build_preset(name, nx=24, ny=12, spp=2, checker_ground=True)
    if name in ("triangle-mesh", "triangles-only"):
        scene, cam, cfg = build_preset("triangle-mesh", nx=24, ny=12, spp=2)
        if name == "triangles-only":
            scene = dataclasses.replace(
                scene, sphere_center=scene.sphere_center[:0],
                sphere_radius=scene.sphere_radius[:0],
                sphere_mat=scene.sphere_mat[:0])
        return scene, cam, cfg
    if name == "camera-effects":
        return build_preset(name, nx=24, ny=12, spp=2)
    if name == "field1100":
        return build_preset("sphere-field", n=1100, nx=24, ny=12, spp=2)
    return build_preset("triangle-field", n=600, nx=24, ny=12, spp=2)


@pytest.fixture(scope="module")
def host_lib():
    """``wavefront_pass.cu`` and ``dense_hit.cu`` built by g++ for the
    host, bound as the card's library and reached through
    ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = build_host_library(units=("wavefront_pass.cu", "dense_hit.cu"))
    mk.bind_wavefront_pass(lib)
    mk.bind_dense_hit(lib)

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


def _brute(scene, o, d, t_min):
    with _card_rounding():
        return intersect_brute(scene, o, d, t_min)


def _k11_equal(what, scene, o, d, t_min=1e-3):
    """K11 against ``intersect_brute`` on the rays (o, d), bit for bit;
    returns the plain (prim, t, hit)."""
    before = dh.dense_hit.launches
    got = dh._launch_cuda(scene, o, d, t_min)
    want = _brute(scene, o, d, t_min)
    assert dh.dense_hit.launches == before + 1
    for name, a, b in zip(("prim", "t", "hit"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (what, name)
    return want


def _bounce_rays(scene, cfg, key, o, d):
    """The rays of one bounce from the hits of (o, d): those that go on."""
    state = trp.record_state(o, d, cfg=cfg)
    prim, _, hit = _brute(scene, o, d, cfg.t_min)
    with _card_rounding():
        rp.record_step_plain(state, prim, hit, scene=scene, key=key,
                             ray_ids=torch.arange(o.shape[0]), cfg=cfg)
    alive = state["alive"]
    return state["o"][alive].contiguous(), state["dr"][alive].contiguous()


@pytest.mark.parametrize("name", SETS)
def test_k11_equals_plain(host_lib, name):
    """K11 on a set's camera rays and on its first bounce's rays: prim, t
    and hit bit-equal to ``intersect_brute``."""
    scene, cam, cfg = _scene(name)
    key, ids = rng.base_key(4), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    _, _, hit = _k11_equal(f"{name}: camera rays", scene, o, d)
    assert bool(hit.any())
    bo, bd = _bounce_rays(scene, cfg, key, o, d)
    assert bo.shape[0] > 0
    _k11_equal(f"{name}: bounce rays", scene, bo, bd)


def _edge_scene(scene):
    """Two triangles sharing the diagonal from (-1, 0, -1) to (1, 0, 1) of
    a unit floor quad, each twice (ids 0-3), on ``scene``'s materials."""
    a, b = (-1.0, 0.0, -1.0), (1.0, 0.0, 1.0)
    v0 = torch.tensor([a, a, a, a])
    v1 = torch.tensor([(1.0, 0.0, -1.0), b, (1.0, 0.0, -1.0), b])
    v2 = torch.tensor([b, (-1.0, 0.0, 1.0), b, (-1.0, 0.0, 1.0)])
    empty = scene.sphere_center[:0]
    return dataclasses.replace(
        scene, sphere_center=empty, sphere_radius=scene.sphere_radius[:0],
        sphere_mat=scene.sphere_mat[:0], tri_v0=v0, tri_v1=v1, tri_v2=v2,
        tri_mat=torch.zeros((4,), dtype=torch.int32))


def test_k11_exact_ties(host_lib):
    """Exact ties: every sphere of random-spheres twice (the copy at id +
    Ns never wins), every triangle of triangle-mesh twice, and rays
    straight down the shared edge of two triangles (each twice): the
    lowest id wins, bit-equal to ``intersect_brute``."""
    scene, cam, cfg = _scene("random-spheres")
    key, ids = rng.base_key(8), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    twice = dataclasses.replace(
        scene, sphere_center=scene.sphere_center.repeat(2, 1),
        sphere_radius=scene.sphere_radius.repeat(2),
        sphere_mat=scene.sphere_mat.repeat(2))
    prim, _, hit = _k11_equal("spheres twice", twice, o, d)
    assert bool(hit.any()) and bool((prim < scene.num_spheres).all())
    mesh, mcam, mcfg = _scene("triangle-mesh")
    mo, md = camera_rays_plain(mcam, mcfg.nx, mcfg.ny, mcfg.spp, key,
                               torch.arange(mcfg.num_rays))
    tris = dataclasses.replace(
        mesh, **{f: getattr(mesh, f).repeat(2, *([1] * (getattr(
            mesh, f).dim() - 1))) for f in ("tri_v0", "tri_v1", "tri_v2",
                                            "tri_mat")})
    prim, _, hit = _k11_equal("triangles twice", tris, mo, md)
    ns, nt = mesh.num_spheres, mesh.num_triangles
    assert bool(hit.any()) and bool((prim < ns + nt).all())
    edge = _edge_scene(scene)
    s = torch.linspace(-0.9, 0.9, 97)
    eo = torch.stack([s, torch.ones_like(s), s], dim=1)
    ed = torch.tensor([0.0, -1.0, 0.0]).expand(97, 3).contiguous()
    prim, t, hit = _k11_equal("a shared edge", edge, eo, ed)
    assert bool(hit.all()) and bool((prim <= 1).all())
    assert bool((t == 1.0).all())


def _lockstep(host_lib, scene, cfg, key, o, d, mode, extra=2):
    """Every bounce of the lockstep recorder's state (``mode``: "tape" or
    "length") and ``extra`` inert ones past the last live bounce: K12
    against ``record_step_plain`` on clones of the same state, bit for
    bit.  Returns (bounces, the final state)."""
    ids = torch.arange(o.shape[0]) * 3 + 1
    state = trp.record_state(o, d, cfg=cfg, tape=mode == "tape")
    if mode == "length":
        state["length"] = torch.zeros(ids.shape, dtype=torch.int64)
    bounces, inert = 0, 0
    while inert < extra:
        inert += not bool(state["alive"].any())
        prim, _, hit = _brute(scene, state["o"], state["dr"], cfg.t_min)
        got, want = _clone(state), _clone(state)
        counter = "launches" if mode == "tape" else "length_launches"
        before = getattr(rp.record_step, counter)
        rp._launch_step(got, prim, hit, scene=scene, key=key, ray_ids=ids,
                        cfg=cfg)
        assert getattr(rp.record_step, counter) == before + 1
        with _card_rounding():
            rp.record_step_plain(want, prim, hit, scene=scene, key=key,
                                 ray_ids=ids, cfg=cfg)
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, (mode, bounces, bad)
        assert int(got["d"]) == int(state["d"]) + 1  # advanced once
        state = want
        bounces += 1
    return bounces, state


@pytest.mark.parametrize("mode", ["tape", "length"])
@pytest.mark.parametrize("depth", [3, 50], ids=["cap3", "cap50"])
@pytest.mark.parametrize("name", SETS[:4])
def test_lockstep_bounces_equal_plain(host_lib, name, depth, mode):
    """Every bounce of the lockstep recorder, and two inert bounces past
    its last live one (the tape's scratch row): K12 in lockstep mode (the
    tape) and in length mode (the lengths) against ``record_step_plain``,
    bit for bit."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    key = rng.base_key(depth)
    ids = torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    bounces, state = _lockstep(host_lib, scene, cfg, key, o, d, mode)
    assert 2 < bounces <= depth + 3
    if mode == "length":
        assert int(state["length"].max()) <= depth + 1
        assert int(state["length"].sum()) > cfg.num_rays
    else:
        assert bool((state["tape"][bounces - 2:] == -1).all())


def test_lockstep_counter_past_the_depth_cap(host_lib):
    """A state whose rays are all alive at the bounce counter
    ``max_depth`` (the last row: hits recorded, no path goes on) and past
    it (as after the loop's end: -1 over the scratch row, every path
    ended): bit-equal to the plain version, the tape and the lengths
    together."""
    scene, cam, cfg = _scene("random-spheres")
    cfg = dataclasses.replace(cfg, max_depth=4)
    key, ids = rng.base_key(2), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    prim, _, hit = _brute(scene, o, d, cfg.t_min)
    for d_now in (4, 5, 9):
        state = trp.record_state(o, d, cfg=cfg)
        state["length"] = torch.zeros(ids.shape, dtype=torch.int64)
        state["tape"][cfg.max_depth + 1] = 7
        state["d"].fill_(d_now)
        got, want = _clone(state), _clone(state)
        rp._launch_step(got, prim, hit, scene=scene, key=key, ray_ids=ids,
                        cfg=cfg)
        with _card_rounding():
            rp.record_step_plain(want, prim, hit, scene=scene, key=key,
                                 ray_ids=ids, cfg=cfg)
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        assert not bad, (d_now, bad)
        assert not bool(got["alive"].any())
        assert torch.equal(got["length"], torch.ones_like(got["length"]))
        row = got["tape"][min(d_now, cfg.max_depth + 1)]
        assert bool((row >= 0).any() if d_now == 4 else (row == -1).all())


def _record_bounce_before(scene, accel, intersect_fn, key, o, dr, ids,
                          depth, t_min):
    """The recorders' shared bounce as it was before the K12 seam."""
    prim, _, hit = intersect_fn(scene, accel, o, dr, t_min)
    t, p, n, mat = recompute_hit(scene, o, dr, prim, t_min)
    hit = hit & (t < BIG)
    p = torch.where(hit[:, None], p, 0.0)
    up = constant(UP, torch.float32, o.device)
    n = torch.where(hit[:, None], n, up)
    new_dir, _, ok = scatter(scene, mat, dr, p, n,
                             rng.bounce_uniforms(key, ids, depth))
    return prim, hit, p, new_dir, ok


def _record_pool_pass_before(state, *, scene, camera, key, ray_ids, cfg,
                             intersect_fn):
    """The pool recorder's pass as it was before its split at the K12 and
    K13 seams (its torch body, the closest hit from ``intersect_fn``)."""
    C, R = state["alive"].shape[0], ray_ids.shape[0]
    o, d, ids, col, depth, alive = (state[k] for k in rp.RECORD_ROWS)
    prim, hit, p, new_dir, ok = _record_bounce_before(
        scene, None, intersect_fn, key, o, d, ids, depth, cfg.t_min)
    write = alive & hit
    state["tape"].scatter_(0, torch.where(
        write, depth * R + col, (cfg.max_depth + 1) * R), prim)
    cont = write & ok & (depth < cfg.max_depth)
    n_alive = cont.sum()
    slot = torch.arange(C, dtype=torch.int64)
    dest = torch.where(cont, torch.cumsum(cont, 0) - 1,
                       n_alive + torch.cumsum(~cont, 0) - 1)
    src = torch.empty_like(dest).index_copy_(0, dest, slot)
    cursor = state["cursor"]
    is_tail = slot >= n_alive
    fresh_idx = cursor + slot - n_alive
    f_ids = ray_ids[fresh_idx.clamp(0, max(R - 1, 0))]
    fo, fd = camera_rays_plain(camera, cfg.nx, cfg.ny, cfg.spp, key, f_ids)
    tail = is_tail[:, None]
    o.copy_(torch.where(tail, fo, p[src]))
    d.copy_(torch.where(tail, fd, new_dir[src]))
    ids.copy_(torch.where(is_tail, f_ids, ids[src]))
    col.copy_(torch.where(is_tail, fresh_idx.clamp(0, max(R - 1, 0)),
                          col[src]))
    depth.copy_(torch.where(is_tail, 0, depth[src] + 1))
    alive.copy_(~is_tail | (fresh_idx < R))
    cursor.add_(torch.minimum(C - n_alive, (R - cursor).clamp(min=0)))


@pytest.mark.parametrize("name", ["random-spheres", "triangle-mesh"])
def test_split_plain_composes_to_the_pass_before(name):
    """``record_shade_plain`` then ``record_regenerate_plain`` equal the
    pool recorder's pass as it was, every tensor of its state (the flat
    tape's last entry too) ``torch.equal``, pass by pass over a pool of
    100 slots, two inert passes past the stream's end included."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=6)
    key = rng.base_key(11)
    ray_ids = torch.arange(5, cfg.num_rays - 3) * 1
    state = trp.record_pool_state(cam, key, ray_ids, cfg=cfg, pool_size=100)
    before = {k: v.clone() for k, v in state.items()
              if k not in ("record", "scan")}
    passes = inert = 0
    while inert < 2:
        inert += not bool(state["alive"].any())
        prim, _, hit = intersect_brute(scene, state["o"], state["d"],
                                       cfg.t_min)
        rp.record_shade_plain(state, prim, hit, scene=scene, key=key,
                              ray_ids=ray_ids, cfg=cfg)
        rp.record_regenerate_plain(state, camera=cam, key=key,
                                   ray_ids=ray_ids, cfg=cfg)
        _record_pool_pass_before(before, scene=scene, camera=cam, key=key,
                                 ray_ids=ray_ids, cfg=cfg,
                                 intersect_fn=integrator.default_intersect)
        bad = [k for k in before if not torch.equal(state[k], before[k])]
        assert not bad, (passes, bad)
        passes += 1
    assert passes > 4 and int(state["cursor"]) == ray_ids.shape[0]


# Blocks the emulation's card holds at once (host_emu/cuda_runtime.h: two
# multiprocessors of two blocks), the most K12's persistent pool grid has.
EMU_RESIDENT = 4


def _record_scan_words(what, got, want, passes):
    """K12's pool-mode scan words (``got``) after ``passes`` passes on
    them: the ticket at passes x (tiles + the grid's blocks), and every
    tile's word an inclusive prefix of this pass (epoch passes - 1),
    nondecreasing by at most a tile from tile to tile, the last the plain
    record's survivors.  Then hands them to ``want``: the plain version
    keeps none."""
    scan = got["scan"]
    tiles = scan.numel() - 1
    words = scan[1:]
    counts = words & 0xFFFFFFFF
    flags = (words >> 32) & 3
    epochs = words >> 34
    assert int(scan[0]) == passes * (tiles + min(tiles, EMU_RESIDENT)), what
    assert bool((flags == 2).all()), (what, flags)
    assert bool((epochs == passes - 1).all()), (what, epochs)
    steps = torch.diff(counts, prepend=counts.new_zeros(1))
    assert bool(((steps >= 0) & (steps <= rp.RECORD_TILE)).all()), what
    assert int(counts[-1]) == int(want["record"][0]), what
    want["scan"] = scan


def _fused_vs_plain(what, state, prim, hit, *, scene, cam, key, ray_ids,
                    cfg, passes):
    """K12's pool launch (K13 folded in) on a clone of ``state`` against
    ``record_shade_plain`` then ``record_regenerate_plain`` on another,
    bit for bit but for the flat tape's last entry, its scan words checked
    as the ``passes``-th pass on them; its launch counters move once.
    Returns the plain state."""
    got, want = _clone(state), _clone(state)
    before = rp.record_shade.launches, rp.record_shade.refill_launches
    rp._launch_shade(got, prim, hit, scene=scene, camera=cam, key=key,
                     ray_ids=ray_ids, cfg=cfg)
    assert (rp.record_shade.launches, rp.record_shade.refill_launches) \
        == (before[0] + 1, before[1] + 1)
    with _card_rounding():
        rp.record_shade_plain(want, prim, hit, scene=scene, key=key,
                              ray_ids=ray_ids, cfg=cfg)
        rp.record_regenerate_plain(want, camera=cam, key=key,
                                   ray_ids=ray_ids, cfg=cfg)
    _record_scan_words(what, got, want, passes)
    assert int(got["tape"][-1]) == int(state["tape"][-1])
    want["tape"][-1] = got["tape"][-1]  # the plain pass's scratch entry
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, (what, bad)
    return want


def _pool_passes(host_lib, scene, cam, cfg, key, ray_ids, pool, extra=2,
                 stale=0):
    """Every pass of the pool recorder over ``ray_ids`` and ``extra`` inert
    passes after: K12's pool launch, K13 folded in, against
    ``record_shade_plain`` then ``record_regenerate_plain`` (its scan
    words checked and handed on), on clones of the same state, bit for bit
    but for the flat tape's last entry; with ``stale``, on scan words as
    that many earlier passes left them (the last one's words inclusive
    prefixes of garbage counts).  Returns (passes, survivors)."""
    state = trp.record_pool_state(cam, key, ray_ids, cfg=cfg,
                                  pool_size=pool)
    if stale:
        tiles = state["scan"].numel() - 1
        state["scan"][0] = stale * (tiles + min(tiles, EMU_RESIDENT))
        words = torch.arange(tiles, dtype=torch.int64)
        state["scan"][1:] = ((stale - 1) << 34) | (2 << 32) | (977 * words
                                                               + 5)
    passes = survivors = inert = 0
    while inert < extra:
        inert += not bool(state["alive"].any())
        prim, _, hit = _brute(scene, state["o"], state["d"], cfg.t_min)
        state = _fused_vs_plain(f"K12 and K13, pass {passes}", state, prim,
                                hit, scene=scene, cam=cam, key=key,
                                ray_ids=ray_ids, cfg=cfg,
                                passes=stale + passes + 1)
        survivors += int(state["record"][0])
        passes += 1
    assert int(state["cursor"]) == ray_ids.shape[0]
    return passes, survivors


# Pools of 1 tile (partial) and 3 tiles (the last partial).
POOLS = {"1block": 200, "3blocks": 2 * 256 + 88}


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("depth", [3, 50], ids=["cap3", "cap50"])
@pytest.mark.parametrize("name", SETS[:4])
def test_pool_passes_equal_plain(host_lib, name, depth, pool):
    """Every pass of the pool recorder over a stream of scattered ray ids
    that ends inside a pass, and two inert passes after it, with 4 blocks
    in flight: K12's pool launch, K13 folded in, against the plain versions,
    bit for bit."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    ray_ids = torch.randperm(cfg.num_rays,
                             generator=torch.Generator().manual_seed(depth))
    ray_ids = ray_ids[:cfg.num_rays - 37].contiguous()
    with _interleaved(host_lib, 4, seed=depth + len(name)):
        passes, survivors = _pool_passes(host_lib, scene, cam, cfg,
                                         rng.base_key(7), ray_ids,
                                         POOLS[pool])
    assert passes > 3 and survivors > 0


def test_pool_at_the_depth_cap_and_stale_words(host_lib):
    """A pool of 40 tiles, every block of the grid in flight, whose scan
    words hold a word of the last pass for every tile (an inclusive prefix
    of garbage counts), with a dead slot in every five and a slot at the
    depth cap in every three: K12's pool launch bit-equal to the plain
    versions, nothing past the cap goes on, the stale words are never
    taken for this pass's."""
    scene, cam, cfg = build_preset("random-spheres", nx=64, ny=32, spp=8)
    cfg = dataclasses.replace(cfg, max_depth=5)
    C = 40 * rp.RECORD_TILE - 17
    key, ray_ids = rng.base_key(6), torch.arange(cfg.num_rays)
    state = trp.record_pool_state(cam, key, ray_ids, cfg=cfg, pool_size=C)
    state["alive"][::5] = False
    state["depth"][1::3] = cfg.max_depth
    tiles = state["scan"].numel() - 1
    state["scan"][0] = 2 * (tiles + EMU_RESIDENT)
    words = torch.arange(tiles, dtype=torch.int64)
    state["scan"][1:] = (1 << 34) | (2 << 32) | (977 * words + 5)
    prim, _, hit = _brute(scene, state["o"], state["d"], cfg.t_min)
    with _interleaved(host_lib, 64, seed=3) as seen:
        got = _fused_vs_plain("K12 and K13", state, prim, hit, scene=scene,
                              cam=cam, key=key, ray_ids=ray_ids, cfg=cfg,
                              passes=3)
        assert seen()[0] > 0  # look-backs waited on fresh words
    n_alive = int(got["record"][0])
    assert 0 < n_alive and bool((got["depth"][:n_alive] <= 5).all())
    capped = state["alive"] & (state["depth"] == cfg.max_depth)
    went_on = set(got["ids"][:n_alive].tolist())
    assert not went_on & set(state["ids"][capped].tolist())
    R = ray_ids.shape[0]
    assert bool((got["tape"][cfg.max_depth * R:-1] >= 0).any())


@contextlib.contextmanager
def _through_host_build(monkeypatch):
    """The recorders' and the occupancy scan's seams on the host build:
    the CPU's plain versions replaced by the kernels' launch code (K11 in
    place of ``dense_hit_plain``, which ``dense_hit`` runs on the CPU,
    with the loops' liveness masks)."""
    with monkeypatch.context() as m:
        m.setattr(dh, "dense_hit_plain", dh._launch_cuda)
        m.setattr(rp, "record_step_plain", rp._launch_step)
        m.setattr(trp, "record_shade", rp._launch_shade)
        yield


JAX_PRESETS = [
    ("three-spheres", dict(nx=24, ny=12, spp=2)),
    ("random-spheres", dict(nx=16, ny=8, spp=2)),
    ("triangle-mesh", dict(nx=16, ny=8, spp=2)),
]


@pytest.mark.parametrize("name,kw", JAX_PRESETS,
                         ids=[p[0] for p in JAX_PRESETS])
def test_recorders_through_kernels_match_jax(host_lib, monkeypatch, name,
                                             kw):
    """The lockstep recorder, the pool recorder (64 slots) and the
    occupancy scan (every ray of the frame) through K11, K12 and K13
    against the JAX package's ``record_paths``, ``record_paths_pool`` and
    ``wavefront_occupancy``: the tapes part from JAX's on under 0.5% of
    entries, on the entries where the plain tapes do
    (``tests/test_torch_replay.py``'s bound), the occupancy counts equal
    (``tests/test_torch_metrics.py``'s); and each equal to the same loop on
    the plain versions."""
    import jax.numpy as jnp

    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.diff.replay import (
        record_paths as jax_record, record_paths_pool as jax_record_pool)
    from first_raytracer_tpu.render.camera import generate_rays as jax_rays
    from first_raytracer_tpu.scene import builders as jb
    from first_raytracer_tpu.utils.metrics import (
        wavefront_occupancy as jax_occupancy)
    from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                                   scene_from_numpy)
    from first_raytracer_tpu_torch.render.integrator import RenderConfig
    from first_raytracer_tpu_torch.utils.metrics import wavefront_occupancy

    js, jc, jcfg = jb.build_preset(name, **kw)
    jcfg = dataclasses.replace(jcfg, max_depth=10)
    key = jrng.base_key(1)
    jids = jnp.arange(jcfg.num_rays, dtype=jnp.int32)
    jo, jd = jax_rays(jc, jcfg.nx, jcfg.ny, jcfg.spp, jids,
                      jrng.camera_uniforms(key, jids))
    want = np.asarray(jax_record(js, jo, jd, jids, key, jcfg))
    want_pool = np.asarray(jax_record_pool(js, jc, jcfg, key, jids,
                                           pool_size=64))
    want_occ = jax_occupancy(js, jc, jcfg, seed=0,
                             num_rays=jcfg.num_rays)
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    cfg = RenderConfig(nx=jcfg.nx, ny=jcfg.ny, spp=jcfg.spp,
                       max_depth=jcfg.max_depth, t_min=jcfg.t_min)
    tkey, ids = rng.base_key(1), torch.arange(cfg.num_rays)
    o, d = camera_rays_plain(tc, cfg.nx, cfg.ny, cfg.spp, tkey, ids)

    def loops():
        return (trp.record_paths(ts, o, d, ids, tkey, cfg),
                trp.record_paths_pool(ts, tc, cfg, tkey, ids, pool_size=64),
                wavefront_occupancy(ts, tc, cfg, seed=0,
                                    num_rays=cfg.num_rays, device="cpu"))

    counters = ((dh.dense_hit, "launches"), (rp.record_step, "launches"),
                (rp.record_step, "length_launches"),
                (rp.record_shade, "launches"),
                (rp.record_shade, "refill_launches"))
    before = [getattr(f, a) for f, a in counters]
    with _through_host_build(monkeypatch), _card_rounding():
        lock, pool, occ = loops()
    made = [getattr(f, a) - n for (f, a), n in zip(counters, before)]
    assert all(n > 0 for n in made), made
    parted = lock.numpy() != want
    assert parted.mean() < 0.005
    assert ((pool.numpy() != want_pool) <= (parted | (want_pool != want))
            ).all()
    assert torch.equal(pool, lock)
    for k in ("rays", "alive_per_bounce", "bounce_histogram"):
        assert occ[k] == want_occ[k], k
    with _card_rounding():
        plain_lock, plain_pool, plain_occ = loops()
    assert torch.equal(lock, plain_lock) and torch.equal(pool, plain_pool)
    assert occ == plain_occ


def test_wrappers_refuse_what_kernels_do_not_take(host_lib):
    """A float64 ray or state, a tensor ``t_min``, a scene without a
    primitive, a misshapen tape, record or scan, a state without its
    arrival word, a camera that carries a gradient and an empty stream are
    refused before the launch; no rays launch nothing but K12's lockstep
    mode, whose one block still advances the counter; another device has
    no kernel."""
    scene, cam, cfg = _scene("random-spheres")
    key, ids = rng.base_key(0), torch.arange(64)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    with pytest.raises(ValueError, match="origin"):
        dh._launch_cuda(scene, o.double(), d, 1e-3)
    with pytest.raises(ValueError, match="t_min"):
        dh._launch_cuda(scene, o, d, torch.tensor(1e-3))
    none = dataclasses.replace(
        _edge_scene(scene), tri_v0=scene.tri_v0[:0], tri_v1=scene.tri_v1[:0],
        tri_v2=scene.tri_v2[:0], tri_mat=scene.tri_mat[:0])
    with pytest.raises(ValueError, match="primitive"):
        dh._launch_cuda(none, o, d, 1e-3)
    with pytest.raises(ValueError, match="sphere_center"):
        dh._launch_cuda(dataclasses.replace(
            scene, sphere_center=scene.sphere_center.t().contiguous().t()),
            o, d, 1e-3)
    prim, _, hit = _brute(scene, o, d, cfg.t_min)
    step = trp.record_state(o, d, cfg=cfg)
    kw = dict(scene=scene, key=key, ray_ids=ids, cfg=cfg)
    with pytest.raises(ValueError, match="'o'"):
        rp._launch_step(dict(step, o=step["o"].double()), prim, hit, **kw)
    with pytest.raises(ValueError, match="'tape'"):
        rp._launch_step(dict(step, tape=step["tape"][:-1]), prim, hit, **kw)
    with pytest.raises(ValueError, match="'arrivals'"):
        rp._launch_step(dict(step, arrivals=step["arrivals"][None]), prim,
                        hit, **kw)
    pool = trp.record_pool_state(cam, key, ids, cfg=cfg, pool_size=64)
    pkw = dict(kw, camera=cam)
    with pytest.raises(ValueError, match="'scan'"):
        rp._launch_shade(dict(pool, scan=pool["scan"][:1]), prim, hit, **pkw)
    with pytest.raises(ValueError, match="'record'"):
        rp._launch_shade(dict(pool, record=pool["record"][:1]), prim, hit,
                         **pkw)
    lens = dataclasses.replace(cam, u=cam.u.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="requires grad"):
        rp._launch_shade(pool, prim, hit, **dict(pkw, camera=lens))
    with pytest.raises(ValueError, match="stream"):
        rp._launch_shade(pool, prim, hit, **dict(pkw, ray_ids=ids[:0]))
    before = (dh.dense_hit.launches, rp.record_step.launches,
              rp.record_shade.launches)
    dh._launch_cuda(scene, o[:0], d[:0], 1e-3)
    empty = trp.record_state(o[:0], d[:0], cfg=cfg)
    rp._launch_step(empty, prim[:0], hit[:0], **dict(kw, ray_ids=ids[:0]))
    empty_pool = trp.record_pool_state(cam, key, ids, cfg=cfg, pool_size=0)
    rp._launch_shade(empty_pool, prim[:0], hit[:0], **pkw)
    assert (dh.dense_hit.launches, rp.record_step.launches,
            rp.record_shade.launches) == (before[0], before[1] + 1,
                                          before[2])
    assert int(empty["d"]) == 1 and int(empty["arrivals"]) == 0
    meta = {k: v.to("meta") for k, v in step.items()}
    with pytest.raises(ValueError, match="device"):
        dh.dense_hit(scene, o.to("meta"), d.to("meta"), 1e-3)
    with pytest.raises(ValueError, match="device"):
        rp.record_step(meta, prim.to("meta"), hit.to("meta"), **kw)
    with pytest.raises(ValueError, match="device"):
        rp.record_shade(meta, prim.to("meta"), hit.to("meta"), **pkw)


def test_failed_build_raises(monkeypatch):
    """A library that fails to build raises out of the wrappers' launch
    code: nothing falls back to the plain versions."""
    def no_library():
        raise RuntimeError("nvcc failed (1): no compiler")

    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    monkeypatch.setattr(mk, "load_mega_library", no_library)
    scene, cam, cfg = _scene("camera-effects")
    key, ids = rng.base_key(0), torch.arange(32)
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    prim, _, hit = intersect_brute(scene, o, d, cfg.t_min)
    pool = trp.record_pool_state(cam, key, ids, cfg=cfg, pool_size=32)
    kw = dict(scene=scene, key=key, ray_ids=ids, cfg=cfg)
    counters = ((dh.dense_hit, "launches"), (rp.record_step, "launches"),
                (rp.record_shade, "launches"),
                (rp.record_shade, "refill_launches"))
    before = [getattr(f, a) for f, a in counters]
    for launch in (lambda: dh._launch_cuda(scene, o, d, 1e-3),
                   lambda: rp._launch_step(trp.record_state(o, d, cfg=cfg),
                                           prim, hit, **kw),
                   lambda: rp._launch_shade(pool, prim, hit, camera=cam,
                                            **kw)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            launch()
    assert [getattr(f, a) for f, a in counters] == before


def test_cpu_recorders_run_the_plain_versions(monkeypatch):
    """On the CPU the recorders' bodies and the occupancy scan take the
    plain versions and draw through the plain Threefry and camera rays: no
    launch code of K7, K8, K11, K12 or K13 is called."""
    from first_raytracer_tpu_torch.render import camera as rcam
    from first_raytracer_tpu_torch.utils import metrics

    def refused(*args, **kwargs):
        raise AssertionError("a CPU pass called a kernel's launch code")

    scene, cam, cfg = _scene("camera-effects")
    key, ids = rng.base_key(0), torch.arange(64)
    static = dict(cfg=cfg, intersect_fn=integrator.default_intersect)
    inputs = dict(scene=scene, camera=cam, accel=None, key=key, ray_ids=ids)
    lock = trp.camera_record_state(**inputs, **static)
    pool = trp.record_pool_state(**inputs, pool_size=32, **static)
    length = metrics._length_state(**inputs, **static)
    for mod, name in ((dh, "_launch_cuda"), (rp, "_launch_step"),
                      (rp, "_launch_shade"), (rng, "uniforms"),
                      (rcam, "_launch_cuda")):
        monkeypatch.setattr(mod, name, refused)
    trp.record_bounce(lock, **inputs, **static)
    trp.record_pool_pass(pool, **inputs, **static)
    metrics._length_pass(length, **inputs, **static)
    assert int(lock["d"]) == 1 and int(length["d"]) == 1
    assert int(length["length"].sum()) == 64
    assert int(pool["record"][1]) == 32 and int(pool["cursor"]) >= 32


def test_graph_caches_count_k11_to_k13():
    """K11's (all, and those given a liveness mask), K12's (each mode) and
    K13's (its refills, folded into K12's pool launch) counters are among
    those the graph caches take off a capture and add back per replay."""
    counters = dgraphed.launch_counters()
    for c in ((dh.dense_hit, "launches"), (dh.dense_hit, "masked_launches"),
              (rp.record_step, "launches"),
              (rp.record_step, "length_launches"),
              (rp.record_shade, "launches"),
              (rp.record_shade, "refill_launches")):
        assert c in counters
    before = dgraphed.launches_now()
    dh.dense_hit.launches += 3
    dh.dense_hit.masked_launches += 2
    rp.record_step.length_launches += 2
    rp.record_shade.refill_launches += 1
    made = dgraphed.take_launches(before)
    assert dgraphed.launches_now() == before
    assert sorted((fn.__name__, attr, n) for fn, attr, n in made) == [
        ("dense_hit", "launches", 3), ("dense_hit", "masked_launches", 2),
        ("record_shade", "refill_launches", 1),
        ("record_step", "length_launches", 2)]
