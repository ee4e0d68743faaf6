"""K9 (the wavefront pass's shading and compaction) and K10 (the pool's
regeneration) on the CPU, and the loops that run through them.

- Their source (``kernels/csrc/wavefront_pass.cu``), compiled by g++
  through the host emulation (``kernels/host_emu``) and driven by the
  wrappers' own launch code on CPU tensors, pass by pass against
  ``shade_plain`` and ``regenerate_plain`` on clones of the same state,
  ``torch.equal`` for every tensor of the state (the compacted pool, the
  slots past its survivors as they were, its output rows, segment counts,
  cursor and pass record), K9's scan words checked on their own and then
  handed to the plain side, so that each pass's K9 meets the words of the
  last: the pool (a depth per slot) over every pass of a small frame whose
  stream ends inside a pass (its tail wraps past ``num_rays``, so dead
  slots), and the chunked batch (a 0-d depth) over every trip; at a depth
  cap of 3 (paths cut there) and of 50; on random-spheres (every material,
  its checker ground), a triangles-only mesh, camera-effects (a checker, a
  lens) and a field of triangles and spheres (``prim >= Ns`` a triangle).
  The pool's passes run with the emulation's resident blocks interleaved
  (``frt_emu_interleave``: 4 blocks in flight, as the 2 x 2 it reports,
  or every block at once, their fibers swept in seeded random orders), at
  pools of 1 block, 3 blocks with a partial last one and 40 blocks, whose
  look-backs wait on predecessors that have published only their
  aggregates and, with every block in flight, go on past a window of 32;
  in passes where no slot survives and where every slot does; with stale
  status words of an earlier pass poisoned; and K10 writes only the tail
  and the cursor.  The plain versions' bare ``torch.sqrt`` and
  ``torch.sin`` run as the card and the emulation round them, correctly:
  torch's float32 ones on this CPU are vectorised approximations an ulp
  off on a fraction of inputs (``probes/torch_arith.py``).
- The pool and the chunked loops with ``shade`` and ``regenerate`` pointed
  at the host build, against the JAX package's ``render_rays_regenerative``
  and ``render_ray_batch`` at ``tests/test_torch_wavefront_graph.py``'s
  bounds (``(|a - b| > 1e-3).mean() < 0.01`` per ray, median below 1e-5;
  segment totals within 0.1%), and bit-equal to the same loops on the
  plain versions.
- The wrappers refuse what their kernels do not take (a float64 state, an
  int64 material column, a camera that carries a gradient, another
  device), launch nothing
  for no slots, raise when their library fails to build, and the graph
  caches count K9's and K10's launches per replay.
- Marked ``cuda`` (skipped here): on CUDA tensors ``pool_pass`` and
  ``trip`` launch K9 and K10 and equal their plain versions.

The JAX package is imported inside the tests that compare with it, so that
this file also runs on a GPU host without JAX (``--noconftest``).
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import contextlib
import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import graphed as dgraphed
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.render import regenerative as treg
from first_raytracer_tpu_torch.render import wavefront_pass as wp
from first_raytracer_tpu_torch.render.api import (batch_state,
                                                  render_ray_batch)
from first_raytracer_tpu_torch.render.integrator import default_intersect
from first_raytracer_tpu_torch.render.regenerative import (pool_pass,
                                                           pool_state)
from first_raytracer_tpu_torch.scene.builders import build_preset

# The card's launch code, which ``host_lib`` replaces for this module's
# host tests.
_LAUNCH_ENTRY = mk.launch_entry
_SQRT, _SIN = torch.sqrt, torch.sin
SETS = ("random-spheres", "triangles-only", "camera-effects",
        "mixed-field")


def _scene(name, device="cpu"):
    """(scene, camera, cfg) of a set, small."""
    if name == "random-spheres":
        scene, cam, cfg = build_preset(name, nx=32, ny=16, spp=2,
                                       checker_ground=True, device=device)
    elif name == "triangles-only":
        scene, cam, cfg = build_preset("triangle-mesh", nx=32, ny=16, spp=2,
                                       device=device)
        scene = dataclasses.replace(
            scene, sphere_center=scene.sphere_center[:0],
            sphere_radius=scene.sphere_radius[:0],
            sphere_mat=scene.sphere_mat[:0])
    elif name == "camera-effects":
        scene, cam, cfg = build_preset(name, nx=32, ny=16, spp=2,
                                       device=device)
    else:
        scene, cam, cfg = build_preset("triangle-field", n=300, nx=32, ny=16,
                                       spp=2, device=device)
    return scene, cam, cfg


@pytest.fixture(scope="module")
def host_lib():
    """``wavefront_pass.cu`` built by g++ for the host, bound as the
    card's library and reached through ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = mk.bind_wavefront_pass(build_host_library(
        units=("wavefront_pass.cu",)))

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


def _rounded_sin(x):
    """``torch.sin`` of a float32 tensor in float64 rounded once, as the
    emulation's sinf (and ``core.vecmath.sin`` on the CPU)."""
    if x.dtype == torch.float32:
        return _SIN(x.double()).float()
    return _SIN(x)


@contextlib.contextmanager
def _card_rounding():
    """The plain versions' bare sqrt and sin rounded as the kernels'."""
    torch.sqrt, torch.sin = _ieee_sqrt, _rounded_sin
    try:
        yield
    finally:
        torch.sqrt, torch.sin = _SQRT, _SIN


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


@contextlib.contextmanager
def _interleaved(lib, resident, seed=0):
    """The emulation's launches with ``resident`` blocks in flight at once,
    their fibers swept in orders drawn from ``seed``; yields a function
    that returns (spins, look-back windows, windows gone on past,
    aggregates summed) since."""
    lib.frt_emu_interleave(resident, seed)

    def seen():
        out = (ctypes.c_ulonglong * 3)()
        lib.frt_emu_look_backs(out)
        return (int(lib.frt_emu_spins()), *map(int, out))
    try:
        yield seen
    finally:
        lib.frt_emu_interleave(0, 0)


def _scan_words(what, got, want, launches):
    """K9's scan words (``got``) after ``launches`` launches on them: the
    ticket at launches x blocks, and every tile's word an inclusive prefix
    of this pass (epoch launches - 1), nondecreasing by at most a tile
    from tile to tile, the last the plain record's survivors.  Then hands
    them to ``want``: the plain version keeps none."""
    scan = got["scan"]
    blocks = scan.numel() - 1
    words = scan[1:]
    counts = words & 0xFFFFFFFF
    flags = (words >> 32) & 3
    epochs = words >> 34
    assert int(scan[0]) == launches * blocks, what
    assert bool((flags == 2).all()), (what, flags)
    assert bool((epochs == launches - 1).all()), (what, epochs)
    steps = torch.diff(counts, prepend=counts.new_zeros(1))
    assert bool(((steps >= 0) & (steps <= wp.BLOCK)).all()), what
    assert int(counts[-1]) == int(want["record"][0]), what
    want["scan"] = scan


def _assert_equal(what, got, want):
    """Every tensor of ``want`` equal to ``got``'s."""
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, (what, bad)


def _passes(scene, cam, cfg, key, start, n, pool, state=None):
    """Every pass of a pool of ``pool`` slots over ``n`` ids from
    ``start``: K9 against ``shade_plain`` (its scan words checked) and
    K10 against ``regenerate_plain``, on clones of the same state, bit for
    bit.  Returns (passes, survivors over the passes)."""
    static = dict(cfg=cfg, num_rays=n, pool_size=pool)
    if state is None:
        state = pool_state(scene, cam, key, start, **static)
    passes = survivors = 0
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["o"],
                                         state["d"], cfg.t_min)
        got, want = _clone(state), _clone(state)
        before = wp.shade.launches, wp.regenerate.launches
        wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start, num_rays=n)
        with _card_rounding():
            wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                           start_id=start, num_rays=n)
        launches = int(state["scan"][0]) // (state["scan"].numel() - 1) + 1
        _scan_words(f"K9, pass {passes}", got, want, launches)
        _assert_equal(f"K9, pass {passes}", got, want)
        survivors += int(want["record"][0])
        wp._launch_regenerate(got, camera=cam, key=key, start_id=start,
                              **static)
        with _card_rounding():
            wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                                **static)
        assert (wp.shade.launches, wp.regenerate.launches) == (
            before[0] + 1, before[1] + 1)
        _assert_equal(f"K10, pass {passes}", got, want)
        state = want
        passes += 1
    assert int(state["cursor"]) == n
    return passes, survivors


@pytest.mark.parametrize("depth", [3, 50], ids=["cap3", "cap50"])
@pytest.mark.parametrize("name", SETS)
def test_pool_passes_equal_plain(host_lib, name, depth):
    """Every pass of a pool of three blocks, the last a partial one, whose
    stream ends inside a pass, with 4 blocks in flight: K9 against
    ``shade_plain`` and K10 against ``regenerate_plain``, on clones of the
    same state, bit for bit."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    start, n = torch.tensor(3), cfg.num_rays - 7
    with _interleaved(host_lib, 4, seed=depth + len(name)):
        passes, survivors = _passes(scene, cam, cfg, rng.base_key(5), start,
                                    n, 2 * wp.BLOCK + 88)
    assert passes > 2 and survivors > 0


# Pools of 1 block (partial), 3 blocks (the last partial) and 40 blocks,
# past a look-back window of 32 tiles.
POOLS = {"1block": wp.BLOCK - 56, "3blocks": 2 * wp.BLOCK + 88,
         "40blocks": 40 * wp.BLOCK - 50}
# Blocks in flight: one after another, the emulation's 2 x 2, every block.
SCHEDULES = {"serial": 0, "resident4": 4, "all": 64}


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("pool", POOLS)
def test_pool_sizes_equal_plain(host_lib, pool, schedule):
    """Every pass of random-spheres at 64x32 @ 8 (depth cap 3) through
    pools of 1, 3 and 40 blocks, with the blocks run one after another,
    4 in flight and all in flight: bit-equal to the plain versions.  With
    blocks in flight the look-backs wait (spins) on predecessors that have
    published only their aggregates; with every one of 40 in flight they
    go on past a window of 32 tiles."""
    scene, cam, cfg = build_preset("random-spheres", nx=64, ny=32, spp=8)
    cfg = dataclasses.replace(cfg, max_depth=3)
    C = POOLS[pool]
    with _interleaved(host_lib, SCHEDULES[schedule], seed=C) as seen:
        passes, _ = _passes(scene, cam, cfg, rng.base_key(9),
                            torch.tensor(0), cfg.num_rays - 100, C)
        spins, windows, crossings, aggregates = seen()
    assert passes > 2
    blocks = -(-C // wp.BLOCK)
    if blocks > 1 and schedule != "serial":
        assert spins > 0 and aggregates > 0, (spins, aggregates)
    if schedule == "serial":
        assert spins == 0 and aggregates == 0
    if blocks > 32 and schedule == "all":
        assert crossings > 0, (windows, crossings)


def _ground_rays(scene, C):
    """C rays straight down onto the scene's largest sphere (the ground),
    outside the field of small spheres: every one hits it."""
    g = int(torch.argmax(scene.sphere_radius))
    top = scene.sphere_center[g] + torch.tensor(
        [15.0, float(scene.sphere_radius[g]) + 1.0, 15.0])
    k = torch.arange(C, dtype=torch.float32)
    o = top + torch.stack([k % 37 * 0.1, k * 0.0, k // 37 * 0.1], 1)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(C, 3).contiguous()
    return o, d


@pytest.mark.parametrize("blocks", [3, 40])
@pytest.mark.parametrize("survive", ["all", "none"])
def test_pass_where_all_or_no_slot_survives(host_lib, survive, blocks):
    """A pass of live slots whose rays all hit the lambertian ground: below
    the depth cap every slot survives (the pool stays as compacted, K10
    writes no slot and leaves the cursor), at the cap none does (K10
    refills every slot); bit-equal to the plain versions, with 4 blocks in
    flight."""
    scene, cam, cfg = build_preset("random-spheres", nx=64, ny=32, spp=8)
    cfg = dataclasses.replace(cfg, max_depth=4)
    C = blocks * wp.BLOCK - 30
    key, start, n = rng.base_key(4), torch.tensor(11), cfg.num_rays - 11
    static = dict(cfg=cfg, num_rays=n, pool_size=C)
    state = pool_state(scene, cam, key, start, **static)
    state["o"], state["d"] = _ground_rays(scene, C)
    state["depth"].fill_(4 if survive == "none" else 2)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    assert bool(hit.all())
    got, want = _clone(state), _clone(state)
    with _interleaved(host_lib, 4, seed=blocks):
        wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start, num_rays=n)
        wp._launch_regenerate(got, camera=cam, key=key, start_id=start,
                              **static)
    with _card_rounding():
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=n)
        record = want["record"].clone()
        wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                            **static)
    _scan_words("K9", got, want, 1)
    _assert_equal("K9 and K10", got, want)
    assert int(record[0]) == (C if survive == "all" else 0)
    assert int(record[1]) == int(state["cursor"])
    if survive == "all":
        assert torch.equal(got["ids"], state["ids"])
        assert torch.equal(got["depth"], state["depth"] + 1)
        assert int(got["cursor"]) == int(state["cursor"])
    else:
        assert int(got["cursor"]) == min(int(state["cursor"]) + C, n)
        assert bool((got["depth"] == 0).all())


@pytest.mark.parametrize("name", SETS)
def test_k9_compacts_in_place(host_lib, name):
    """K9 in pool mode over a pool with a dead slot in every four and a
    slot at the depth cap in every four, the stream ending inside the pass:
    the survivors' next states in order at the front (their ids those of
    the slots that went on, in slot order), the slots past them as they
    were, no segment or sky for a dead slot; K10 then refills the tail,
    its slots past the stream's end dead.  Bit-equal to the plain versions
    at each seam."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=1)
    key, start = rng.base_key(2), torch.tensor(0)
    C = wp.BLOCK + 40
    n = C + 60  # the stream ends inside the first pass's tail
    static = dict(cfg=cfg, num_rays=n, pool_size=C)
    state = pool_state(scene, cam, key, start, **static)
    state["alive"][::4] = False
    state["depth"][1::4] = 1  # at the cap: ends after this pass
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    got, want = _clone(state), _clone(state)
    with _interleaved(host_lib, 4, seed=len(name)):
        wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start, num_rays=n)
    with _card_rounding():
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=n)
    _scan_words("K9", got, want, 1)
    _assert_equal("K9", got, want)
    n_alive = int(got["record"][0])
    assert 0 < n_alive <= C // 2
    went_on = state["ids"][(state["ids"] % 4 >= 2)]
    assert set(got["ids"][:n_alive].tolist()) <= set(went_on.tolist())
    assert bool((torch.diff(got["ids"][:n_alive]) > 0).all())
    assert bool(got["alive"][:n_alive].all())
    for k in wp.POOL_ROWS:
        assert torch.equal(got[k][n_alive:], state[k][n_alive:]), k
    assert int(got["segments"].sum()) == int(state["alive"].sum())
    assert bool((got["segments"][0:C:4] == 0).all())
    wp._launch_regenerate(got, camera=cam, key=key, start_id=start,
                          **static)
    with _card_rounding():
        wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                            **static)
    _assert_equal("K10", got, want)
    assert int(got["cursor"]) == n
    assert int(got["alive"].sum()) == n_alive + (n - C)


def test_stale_status_words_are_not_read(host_lib):
    """K9 over 40 blocks, all in flight, whose scan words hold a word of
    the last pass for every tile (an inclusive prefix of garbage counts):
    no look-back takes one for this pass's, and the pass equals the plain
    version; three launches on the same words leave the ticket at three
    passes of tiles and every word tagged with the third."""
    scene, cam, cfg = build_preset("random-spheres", nx=64, ny=32, spp=8)
    C = 40 * wp.BLOCK
    key, start, n = rng.base_key(6), torch.tensor(0), cfg.num_rays
    state = pool_state(scene, cam, key, start, cfg=cfg, num_rays=n,
                       pool_size=C)
    state["alive"][5::7] = False
    blocks = state["scan"].numel() - 1
    epoch = 2
    state["scan"][0] = epoch * blocks
    tiles = torch.arange(blocks, dtype=torch.int64)
    state["scan"][1:] = ((epoch - 1) << 34) | (2 << 32) | (977 * tiles + 5)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    want = _clone(state)
    with _card_rounding():
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=n)
    for seed in range(3):
        got = _clone(state)
        got["scan"] = state["scan"]  # the words carry over
        with _interleaved(host_lib, 64, seed=seed) as seen:
            wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg,
                             start_id=start, num_rays=n)
            assert seen()[0] > 0  # look-backs waited on fresh words
        check = _clone(want)
        _scan_words(f"K9, launch {seed}", got, check, epoch + seed + 1)
        _assert_equal(f"K9, launch {seed}", got, check)


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_look_back_under_interleavings(host_lib, seed):
    """40 blocks all in flight, the first twenty tiles dead but for one
    slot in nine, the rest alive, so survivors move many tiles back into
    slots their owners read earlier in the same launch: every seed's
    schedule gives the plain version's pool, and its look-backs go on past
    a window of 32 tiles."""
    scene, cam, cfg = build_preset("random-spheres", nx=64, ny=32, spp=8)
    cfg = dataclasses.replace(cfg, max_depth=6)
    C = 40 * wp.BLOCK - 17
    key, start, n = rng.base_key(seed), torch.tensor(0), cfg.num_rays
    static = dict(cfg=cfg, num_rays=n, pool_size=C)
    state = pool_state(scene, cam, key, start, **static)
    front = torch.arange(C) < 20 * wp.BLOCK
    state["alive"] &= ~front | (torch.arange(C) % 9 == 0)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    got, want = _clone(state), _clone(state)
    with _interleaved(host_lib, 64, seed=seed) as seen:
        wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start, num_rays=n)
        spins, windows, crossings, aggregates = seen()
    with _card_rounding():
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=n)
    _scan_words("K9", got, want, 1)
    _assert_equal("K9", got, want)
    assert spins > 0 and crossings > 0 and aggregates > 32


def test_k10_writes_the_tail_and_cursor_only(host_lib):
    """K10 from a pass record: the slots below its survivors unchanged
    bit for bit, the tail refilled, the cursor written from the record's
    (the cursor's own value is not read), the record left as it was."""
    scene, cam, cfg = _scene("camera-effects")
    key, start = rng.base_key(3), torch.tensor(5)
    C, n = 3 * wp.BLOCK - 9, cfg.num_rays - 5
    static = dict(cfg=cfg, num_rays=n, pool_size=C)
    state = pool_state(scene, cam, key, start, **static)
    state["o"].add_(0.25)
    state["depth"].fill_(3)
    state["record"].copy_(torch.tensor([301, n - 200]))
    state["cursor"].fill_(-12345)
    got, want = _clone(state), _clone(state)
    wp._launch_regenerate(got, camera=cam, key=key, start_id=start,
                          **static)
    with _card_rounding():
        wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                            **static)
    _assert_equal("K10", got, want)
    for k in wp.POOL_ROWS:
        assert torch.equal(got[k][:301], state[k][:301]), k
    assert bool((got["depth"][301:] == 0).all())
    assert int(got["alive"][301:].sum()) == 200
    assert int(got["cursor"]) == n
    assert torch.equal(got["record"], state["record"])


@pytest.mark.parametrize("depth", [3, 50], ids=["cap3", "cap50"])
@pytest.mark.parametrize("name", SETS)
def test_trips_equal_plain(host_lib, name, depth):
    """Every trip of a chunked batch (a 0-d depth): K9 against
    ``shade_plain`` on clones of the same carry, bit for bit."""
    scene, cam, cfg = _scene(name)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    key = rng.base_key(-1)
    ids = torch.arange(2, cfg.num_rays - 1)
    state = batch_state(scene, cam, key, ids, cfg=cfg)
    trips = 0
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["origin"],
                                         state["direction"], cfg.t_min)
        got, want = _clone(state), _clone(state)
        wp._launch_shade(got, prim, hit, scene=scene, key=key, cfg=cfg)
        with _card_rounding():
            wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg)
        _assert_equal(f"K9, trip {trips}", got, want)
        state = want
        state["depth"].add_(1)
        trips += 1
    assert trips <= depth + 1 and int(state["segments"].sum()) > ids.numel()


@contextlib.contextmanager
def _through_host_build(monkeypatch):
    """``pool_pass`` and ``trip`` with their seams on the host build: the
    CPU's plain versions replaced by the kernels' launch code."""
    with monkeypatch.context() as m:
        m.setattr(wp, "shade_plain", wp._launch_shade)
        m.setattr(wp, "regenerate_plain", wp._launch_regenerate)
        yield


JAX_PRESETS = [
    ("three-spheres", dict(nx=32, ny=16, spp=4)),
    ("random-spheres", dict(nx=32, ny=16, spp=4)),
    ("triangle-mesh", dict(nx=32, ny=16, spp=4)),
    ("camera-effects", dict(nx=24, ny=12, spp=4)),
]


def _jax_case(name, kw):
    from first_raytracer_tpu.scene import builders as jb
    from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                                   scene_from_numpy)
    from first_raytracer_tpu_torch.render.integrator import RenderConfig

    js, jc, cfg = jb.build_preset(name, **kw)
    cfg = dataclasses.replace(cfg, max_depth=12)
    return (js, jc, cfg, scene_from_numpy(js.as_numpy()),
            camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


def _assert_near_jax(got, segs, want, jsegs):
    """``tests/test_torch_wavefront_graph.py``'s bounds."""
    diff = np.abs(got.numpy() - np.asarray(want))
    assert np.isfinite(got.numpy()).all()
    assert (diff > 1e-3).mean() < 0.01, diff.max()
    assert np.median(diff) < 1e-5
    jsegs = np.asarray(jsegs)
    assert abs(int(segs.sum()) - int(jsegs.sum())) <= 1e-3 * jsegs.sum()


@pytest.mark.parametrize("name,kw", JAX_PRESETS,
                         ids=[p[0] for p in JAX_PRESETS])
def test_loops_through_kernels_match_jax(host_lib, monkeypatch, name, kw):
    """The pool (256 slots, a range that starts past 0) and the chunked
    batch through K9 and K10 against the JAX package's pool and batch, and
    bit-equal to the same loops on the plain versions (the pool's init and
    the dense sweep, torch ops in both, rounding their square roots as the
    kernels do)."""
    import jax.numpy as jnp

    from first_raytracer_tpu.core import rng as jrng
    from first_raytracer_tpu.render import integrator as jint
    from first_raytracer_tpu.render.api import render_ray_batch as jax_batch
    from first_raytracer_tpu.render.camera import generate_rays as jax_rays
    from first_raytracer_tpu.render.regenerative import (
        render_rays_regenerative as jax_pool)

    js, jc, cfg, ts, tc, tcfg = _jax_case(name, kw)
    start, n = 37, cfg.num_rays - 48
    jids = jnp.arange(start, start + n, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, jids,
                    jrng.camera_uniforms(jrng.base_key(0), jids))
    _, jsegs = jint.trace_rays(js, o, d, jids, jrng.base_key(0), cfg,
                               return_stats=True)
    ids = torch.arange(start, start + n)

    def loops():
        pool = treg.render_rays_regenerative(
            ts, tc, tcfg, rng.base_key(0), start, n, pool_size=256,
            return_stats=True)
        batch = render_ray_batch(ts, tc, tcfg, rng.base_key(0), ids,
                                 return_stats=True)
        return pool, batch

    with _through_host_build(monkeypatch), _card_rounding():
        before = wp.shade.launches, wp.regenerate.launches
        (rad, segs), (brad, bsegs) = loops()
        k9, k10 = (wp.shade.launches - before[0],
                   wp.regenerate.launches - before[1])
    assert k10 > 0 and k9 > k10  # a pass each, and the batch's trips
    want = jax_pool(js, jc, cfg, jrng.base_key(0), jnp.int32(start), n,
                    pool_size=256)
    _assert_near_jax(rad, segs, want, jsegs)
    _assert_near_jax(brad, bsegs,
                     jax_batch(js, jc, cfg, jrng.base_key(0), jids), jsegs)
    with _card_rounding():
        (prad, psegs), (pbrad, pbsegs) = loops()
    assert torch.equal(rad, prad) and torch.equal(segs, psegs)
    assert torch.equal(brad, pbrad) and torch.equal(bsegs, pbsegs)


def test_wrappers_refuse_what_kernels_do_not_take(host_lib):
    """A float64 state, an int64 material column, a camera that carries a
    gradient and a misshapen pass record or scan are refused before the
    launch; no slots launch nothing; another device has no kernel."""
    scene, cam, cfg = _scene("random-spheres")
    key, start = rng.base_key(0), torch.tensor(0)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=64)
    state = pool_state(scene, cam, key, start, **static)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    kw = dict(scene=scene, key=key, cfg=cfg, start_id=start,
              num_rays=cfg.num_rays)
    bad = dict(state, o=state["o"].double())
    with pytest.raises(ValueError, match="'o'"):
        wp._launch_shade(bad, prim, hit, **kw)
    wide = dataclasses.replace(scene, tri_mat=scene.tri_mat.long())
    with pytest.raises(ValueError, match="scene.tri_mat"):
        wp._launch_shade(state, prim, hit, **dict(kw, scene=wide))
    with pytest.raises(ValueError, match="'record'"):
        wp._launch_regenerate(dict(state, record=state["record"][:1]),
                              camera=cam, key=key, start_id=start, **static)
    with pytest.raises(ValueError, match="'scan'"):
        wp._launch_shade(dict(state, scan=state["scan"][:1]), prim, hit, **kw)
    lens = dataclasses.replace(cam, u=cam.u.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="requires grad"):
        wp._launch_regenerate(state, camera=lens, key=key, start_id=start,
                              **static)
    empty = {k: (v[:0] if k in wp.POOL_ROWS else v)
             for k, v in state.items()}
    empty["scan"] = state["scan"][:1]
    before = wp.shade.launches, wp.regenerate.launches
    wp._launch_shade(empty, prim[:0], hit[:0], **kw)
    assert (wp.shade.launches, wp.regenerate.launches) == before
    meta = {k: v.to("meta") for k, v in state.items()}
    with pytest.raises(ValueError, match="device"):
        wp.shade(meta, prim.to("meta"), hit.to("meta"), **kw)
    with pytest.raises(ValueError, match="device"):
        wp.regenerate(meta, camera=cam, key=key, start_id=start, **static)


def test_failed_build_raises(monkeypatch):
    """A library that fails to build raises out of the wrappers' launch
    code: nothing falls back to the plain versions."""
    def no_library():
        raise RuntimeError("nvcc failed (1): no compiler")

    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    monkeypatch.setattr(mk, "load_mega_library", no_library)
    scene, cam, cfg = _scene("camera-effects")
    key, start = rng.base_key(0), torch.tensor(0)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=32)
    state = pool_state(scene, cam, key, start, **static)
    prim, _, hit = default_intersect(scene, None, state["o"], state["d"],
                                     cfg.t_min)
    before = wp.shade.launches, wp.regenerate.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wp._launch_shade(state, prim, hit, scene=scene, key=key, cfg=cfg,
                         start_id=start, num_rays=cfg.num_rays)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        wp._launch_regenerate(state, camera=cam, key=key, start_id=start,
                              **static)
    assert (wp.shade.launches, wp.regenerate.launches) == before


def test_cpu_passes_run_the_plain_versions(monkeypatch):
    """On the CPU ``pool_pass`` and ``trip`` take the plain versions and
    draw through the plain Threefry and camera rays: no wrapper of K7, K8,
    K9 or K10 is called."""
    from first_raytracer_tpu_torch.render import camera as rcam
    from first_raytracer_tpu_torch.render.integrator import trip

    def refused(*args, **kwargs):
        raise AssertionError("a CPU pass called a kernel's wrapper")

    scene, cam, cfg = _scene("camera-effects")
    key, start = rng.base_key(0), torch.tensor(0)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=64)
    state = pool_state(scene, cam, key, start, **static)
    batch = batch_state(scene, cam, key, torch.arange(64), cfg=cfg)
    for mod, name in ((wp, "_launch_shade"), (wp, "_launch_regenerate"),
                      (rng, "uniforms"), (rng, "bounce_uniforms"),
                      (rcam, "camera_rays"), (treg, "camera_rays")):
        monkeypatch.setattr(mod, name, refused)
    pool_pass(state, scene=scene, camera=cam, accel=None, key=key,
              start_id=start, intersect_fn=default_intersect, **static)
    trip(batch, scene=scene, accel=None, key=key, cfg=cfg,
         intersect_fn=default_intersect)
    assert int(state["segments"].sum()) == 64
    assert int(batch["segments"].sum()) == 64


def test_graph_caches_count_k9_and_k10():
    """K9's and K10's counters are among those the graph caches take off a
    capture and add back per replay."""
    counters = dgraphed.launch_counters()
    assert (wp.shade, "launches") in counters
    assert (wp.regenerate, "launches") in counters
    before = dgraphed.launches_now()
    wp.shade.launches += 2
    wp.regenerate.launches += 1
    made = dgraphed.take_launches(before)
    assert dgraphed.launches_now() == before
    assert sorted((fn.__name__, n) for fn, _, n in made) == [
        ("regenerate", 1), ("shade", 2)]


@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: K9 and K10 are CUDA kernels")
    monkeypatch.setattr(mk, "launch_entry", _LAUNCH_ENTRY)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS)
def test_cuda_passes_launch_k9_and_k10(cuda_device, name):
    """On CUDA tensors a pool pass launches K9 and K10 once each and a
    trip K9 once, each pass bit-equal to the plain versions on the card."""
    scene, cam, cfg = _scene(name, device=cuda_device)
    key = rng.base_key(0).to(cuda_device)
    start = torch.tensor(0, device=cuda_device)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=128)
    state = pool_state(scene, cam, key, start, **static)
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["o"],
                                         state["d"], cfg.t_min)
        want = _clone(state)
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg,
                       start_id=start, num_rays=cfg.num_rays)
        wp.regenerate_plain(want, camera=cam, key=key, start_id=start,
                            **static)
        before = wp.shade.launches, wp.regenerate.launches
        pool_pass(state, scene=scene, camera=cam, accel=None, key=key,
                  start_id=start, intersect_fn=default_intersect, **static)
        torch.cuda.synchronize()
        assert (wp.shade.launches, wp.regenerate.launches) == (
            before[0] + 1, before[1] + 1)
        want["scan"] = state["scan"]  # K9's own words
        _assert_equal("pool pass", state, want)
    ids = torch.arange(cfg.num_rays, device=cuda_device)
    state = batch_state(scene, cam, key, ids, cfg=cfg)
    from first_raytracer_tpu_torch.render.integrator import trip
    while bool(state["alive"].any()):
        prim, _, hit = default_intersect(scene, None, state["origin"],
                                         state["direction"], cfg.t_min)
        want = _clone(state)
        wp.shade_plain(want, prim, hit, scene=scene, key=key, cfg=cfg)
        want["depth"].add_(1)
        before = wp.shade.launches
        trip(state, scene=scene, accel=None, key=key, cfg=cfg,
             intersect_fn=default_intersect)
        torch.cuda.synchronize()
        assert wp.shade.launches == before + 1
        _assert_equal("trip", state, want)
