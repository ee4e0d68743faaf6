"""The direct gradient step and the occupancy scan as fixed-shape loops, on
the CPU (``diff/replay.py``'s recorder bodies through
``render/graphed.py::run_loop``, ``diff/grad.py``'s direct step,
``utils/metrics.py::_path_lengths``).

- The lockstep recorder (``record_state``/``record_bounce``) and the pool
  recorder (``record_pool_state``/``record_pool_pass``, pools of 256, 1000
  and 4096 slots) give tapes ``torch.equal`` to the op-by-op recorders
  they replace (``_eager_record_paths`` and ``_eager_record_paths_pool``
  below, copied from them) on random-spheres and triangle-mesh at 32x16 @ 2
  and sphere_field(1100), on the dense sweep and on K4's and K5's plain
  versions (whose lowest-id rule gives the dense sweep's tape); and agree
  with the JAX package's ``record_paths`` and ``record_paths_pool`` on the
  dense sweep as ``tests/test_torch_replay.py::
  test_recorders_with_an_accel_match_jax`` holds them: the entries that
  part from JAX's lockstep tape are below 0.5%, and those that part from
  JAX's pool tape are among them and the few where JAX's own pool and
  lockstep tapes part (4 of 9216 entries on random-spheres with a pool of
  256).
- One to four passes per read of the alive flag give the same tapes, also
  at a depth cap the paths reach (the inert passes past the cap write the
  scratch row, never row ``max_depth``).
- After a warm call a recorder pass and an occupancy pass make no tensor
  from host data and read nothing back (counted as
  ``tests/test_torch_wavefront_graph.py`` counts it).
- ``render_loss_and_grads``, ``sgd_step`` and three ``make_fit_step``
  steps with Adam: ``torch.equal`` to the op-by-op step
  (``_eager_loss_and_grads``), and against JAX's ``render_loss_and_grads``,
  ``sgd_step`` and ``make_fit_step`` with ``optax.adam`` at the bounds of
  ``tests/test_torch_grad.py``: the loss ``rtol=1e-5``, the albedo and
  fuzz gradients and the updated parameters ``rtol=1e-4, atol=1e-6`` (its
  tape-swap bound), the centres' gradient by its cosine with JAX's (at
  least 0.999) and its norm (within 3%), as ``tests/test_torch_replay.py``
  holds gradients that rest on grazing rays, and the Adam trajectory of
  the albedo by loss ``rtol=1e-4``.
- ``wavefront_occupancy``'s counts equal JAX's ``_occupancy_scan``'s
  (ratios to 1e-12, ``tests/test_torch_metrics.py``'s bounds and sizes)
  and the op-by-op loop's lengths.
- ``cli fit --device cpu`` without ``--fast`` prints the recorder loops'
  and the replay graphs' counters.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff import grad as jg
from first_raytracer_tpu.diff.replay import (
    record_paths as jax_record, record_paths_pool as jax_record_pool)
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu.utils.metrics import (
    wavefront_occupancy as jax_occupancy)
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               params_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.core.vecmath import constant
from first_raytracer_tpu_torch.diff import grad as tg
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.geometry.sphere import BIG
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
from first_raytracer_tpu_torch.materials.scatter import scatter
from first_raytracer_tpu_torch.render import graphed
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.render.graphed import LoopCache
from first_raytracer_tpu_torch.render.integrator import (
    UP, RenderConfig, default_intersect, recompute_hit)
from first_raytracer_tpu_torch.utils import metrics as tm
from test_torch_cli import _run_cli
from test_torch_wavefront_graph import _HostTraffic

SCENES = {
    "random-spheres": ("random-spheres", dict(nx=32, ny=16, spp=2)),
    "triangle-mesh": ("triangle-mesh", dict(nx=32, ny=16, spp=2)),
    "field1100": ("sphere-field", dict(n=1100, nx=32, ny=16, spp=2)),
}
DEPTH = 8


@functools.lru_cache(maxsize=None)
def _case(name, depth=DEPTH):
    """Both packages' scene, camera and config."""
    preset, kw = SCENES[name]
    js, jc, cfg = jb.build_preset(preset, **kw)
    cfg = dataclasses.replace(cfg, max_depth=depth)
    return js, jc, cfg, scene_from_numpy(js.as_numpy()), \
        camera_from_numpy(jc), RenderConfig(
            nx=cfg.nx, ny=cfg.ny, spp=cfg.spp, max_depth=cfg.max_depth,
            t_min=cfg.t_min)


def _rays(cam, cfg, key, ids):
    return generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         trng.camera_uniforms(key, ids))


# The op-by-op recorders and occupancy loop that the fixed-shape bodies
# replace, as they were: a host read of "any ray alive" every bounce, and
# the pool's compaction sized from the data.

def _eager_bounce(scene, accel, intersect_fn, key, o, dr, ids, depth,
                  t_min):
    prim, _, hit = intersect_fn(scene, accel, o, dr, t_min)
    t, p, n, mat = recompute_hit(scene, o, dr, prim, t_min)
    hit = hit & (t < BIG)
    p = torch.where(hit[:, None], p, 0.0)
    n = torch.where(hit[:, None], n, constant(UP, torch.float32, o.device))
    new_dir, _, ok = scatter(scene, mat, dr, p, n,
                             trng.bounce_uniforms(key, ids, depth))
    return prim, hit, p, new_dir, ok


@torch.no_grad()
def _eager_record_paths(scene, origin, direction, ray_ids, key, cfg,
                        accel=None, intersect_fn=default_intersect):
    R = origin.shape[0]
    tape = torch.full((cfg.max_depth + 1, R), -1, dtype=torch.int32)
    o, dr = origin, direction
    alive = torch.ones((R,), dtype=torch.bool)
    for d in range(cfg.max_depth + 1):
        if not bool(alive.any()):
            break
        prim, hit, p, new_dir, ok = _eager_bounce(
            scene, accel, intersect_fn, key, o, dr, ray_ids, d, cfg.t_min)
        tape[d] = torch.where(alive & hit, prim, -1)
        alive = alive & hit & ok & (d < cfg.max_depth)
        o = torch.where(alive[:, None], p, o)
        dr = torch.where(alive[:, None], new_dir, dr)
    return tape


@torch.no_grad()
def _eager_record_paths_pool(scene, camera, cfg, key, ray_ids, accel=None,
                             intersect_fn=default_intersect,
                             pool_size=8192):
    R, C, D = ray_ids.shape[0], pool_size, cfg.max_depth + 1
    tape = torch.full((D * R,), -1, dtype=torch.int32)

    def fresh_rays(stream_idx):
        ids = ray_ids[stream_idx.clamp(0, R - 1)]
        return (ids, *_rays(camera, cfg, key, ids))

    slot = torch.arange(C)
    ids, o, d = fresh_rays(slot)
    col = slot
    depth = torch.zeros((C,), dtype=torch.int64)
    alive = slot < min(C, R)
    cursor = min(C, R)
    while bool(alive.any()):
        prim, hit, p, new_dir, ok = _eager_bounce(
            scene, accel, intersect_fn, key, o, d, ids, depth, cfg.t_min)
        write = alive & hit
        tape[(depth * R + col)[write]] = prim[write]
        cont = write & ok & (depth < cfg.max_depth)
        keep = torch.nonzero(cont)[:, 0]
        n_alive = keep.shape[0]
        fresh_idx = cursor + torch.arange(C - n_alive)
        f_ids, fo, fd = fresh_rays(fresh_idx)
        o = torch.cat([p[keep], fo])
        d = torch.cat([new_dir[keep], fd])
        ids = torch.cat([ids[keep], f_ids])
        col = torch.cat([col[keep], fresh_idx.clamp(0, R - 1)])
        depth = torch.cat([depth[keep] + 1, torch.zeros_like(fresh_idx)])
        alive = torch.cat([torch.ones_like(keep, dtype=torch.bool),
                           fresh_idx < R])
        cursor += min(C - n_alive, max(R - cursor, 0))
    return tape.reshape(D, R)


@torch.no_grad()
def _eager_path_lengths(scene, camera, cfg, key, ray_ids, accel):
    o, d = _rays(camera, cfg, key, ray_ids)
    alive = torch.ones((o.shape[0],), dtype=torch.bool)
    length = torch.zeros((o.shape[0],), dtype=torch.int64)
    for depth in range(cfg.max_depth + 1):
        if not bool(alive.any()):
            break
        length += alive
        _, hit, p, new_dir, ok = _eager_bounce(
            scene, accel, default_intersect, key, o, d, ray_ids, depth,
            cfg.t_min)
        alive = alive & hit & ok & (depth < cfg.max_depth)
        o = torch.where(alive[:, None], p, o)
        d = torch.where(alive[:, None], new_dir, d)
    return length


def _eager_loss_and_grads(params, scene, camera, cfg, key, ray_ids, target,
                          accel=None):
    """The op-by-op direct step: ``value_and_grad`` of the MSE of the
    replay of ``_eager_record_paths``' tape."""
    def loss(p):
        s = tg.merge_params(scene, p)
        o, d = _rays(camera, cfg, key, ray_ids)
        tape = _eager_record_paths(s, o, d, ray_ids, key, cfg, accel)
        rad = trp.trace_rays_replay(s, o, d, ray_ids, key, cfg, tape)
        return torch.mean((rad - target) ** 2)

    return tg.value_and_grad(loss, params)


@pytest.fixture
def loops(monkeypatch):
    """A new ``LoopCache`` in place of ``render.graphed.LOOPS``."""
    cache = LoopCache()
    monkeypatch.setattr(graphed, "LOOPS", cache)
    return cache


ACCELS = {"dense sweep": lambda s: None,
          "K4 plain": ip.pack_scene_pallas,
          "K5 plain": ic.pack_scene_clustered}
PLAIN_FN = {"dense sweep": default_intersect,
            "K4 plain": ip.intersect_pallas_reference,
            "K5 plain": ic.intersect_clustered_reference}


@functools.lru_cache(maxsize=None)
def _lockstep(name):
    """Key 1's camera rays of a scene and the op-by-op recorder's tape on
    the dense sweep."""
    *_, ts, tc, tcfg = _case(name)
    key, ids = trng.base_key(1), torch.arange(tcfg.num_rays)
    o, d = _rays(tc, tcfg, key, ids)
    return o, d, _eager_record_paths(ts, o, d, ids, key, tcfg)


@functools.lru_cache(maxsize=None)
def _jax_tape(name, pool=None):
    """JAX's lockstep tape, or its pool tape of ``pool`` slots, on the
    dense sweep, key 1."""
    js, jc, cfg, *_ = _case(name)
    key = jrng.base_key(1)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    if pool:
        return np.asarray(jax_record_pool(js, jc, cfg, key, ids,
                                          pool_size=pool))
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    return np.asarray(jax_record(js, o, d, ids, key, cfg))


@pytest.mark.parametrize("pool", [256, 1000, 4096])
@pytest.mark.parametrize("name", list(SCENES))
def test_recorders_equal_eager_and_match_jax(loops, name, pool):
    *_, ts, tc, tcfg = _case(name)
    key, ids = trng.base_key(1), torch.arange(tcfg.num_rays)
    o, d, want = _lockstep(name)
    lock = trp.record_paths(ts, o, d, ids, key, tcfg)
    cam = trp.record_camera_paths(ts, tc, tcfg, key, ids)
    got = trp.record_paths_pool(ts, tc, tcfg, key, ids, pool_size=pool)
    assert lock.shape == got.shape == (tcfg.max_depth + 1, tcfg.num_rays)
    assert lock.dtype == got.dtype == torch.int32
    assert torch.equal(lock, want) and torch.equal(cam, want)
    assert torch.equal(got, _eager_record_paths_pool(ts, tc, tcfg, key, ids,
                                                     pool_size=pool))
    assert torch.equal(got, lock)
    assert loops.captures == 0 and loops.syncs >= 3
    jax_lock, jax_pool = _jax_tape(name), _jax_tape(name, pool)
    parted = lock.numpy() != jax_lock
    jax_parts = jax_pool != jax_lock
    assert parted.mean() < 0.005 and jax_parts.mean() < 0.005
    assert ((lock.numpy() != jax_pool) <= (parted | jax_parts)).all()


@pytest.mark.parametrize("name,accel", [("random-spheres", "K4 plain"),
                                        ("field1100", "K5 plain")])
def test_recorders_with_an_accel(loops, name, accel):
    """K4's and K5's plain versions in both recorders (a pool of 1000):
    the op-by-op recorder's tape, which the lowest-id rule makes the dense
    sweep's (held to JAX's above)."""
    *_, ts, tc, tcfg = _case(name)
    key, ids = trng.base_key(1), torch.arange(tcfg.num_rays)
    acc, fn = ACCELS[accel](ts), PLAIN_FN[accel]
    o, d, dense = _lockstep(name)
    lock = trp.record_paths(ts, o, d, ids, key, tcfg, acc, fn)
    got = trp.record_paths_pool(ts, tc, tcfg, key, ids, acc, fn,
                                pool_size=1000)
    assert torch.equal(lock, _eager_record_paths(ts, o, d, ids, key, tcfg,
                                                 acc, fn))
    assert torch.equal(got, lock) and torch.equal(lock, dense)


@pytest.mark.parametrize("recorder", ["lockstep", "pool", "lengths"])
@pytest.mark.parametrize("passes", [1, 2, 3, 4])
def test_passes_per_read_change_nothing(monkeypatch, loops, recorder,
                                        passes):
    """At a depth cap that paths reach (three of three-spheres' glass
    paths bounce to it): the tape, or the lengths, equal the op-by-op
    loop's for every block length, and the flag is read once a block."""
    js, jc, cfg = jb.three_spheres(nx=24, ny=12, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=3)
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    tcfg = RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp, max_depth=3,
                        t_min=cfg.t_min)
    key, ids = trng.base_key(2), torch.arange(tcfg.num_rays)
    monkeypatch.setattr(graphed, "PASSES_PER_READ", passes)
    o, d = _rays(tc, tcfg, key, ids)
    want = _eager_record_paths(ts, o, d, ids, key, tcfg)
    assert int((want[-1] >= 0).sum()) > 0  # the cap is reached
    if recorder == "lockstep":
        got = trp.record_paths(ts, o, d, ids, key, tcfg)
    elif recorder == "pool":
        got = trp.record_paths_pool(ts, tc, tcfg, key, ids, pool_size=96)
    else:
        got = tm._path_lengths(ts, tc, tcfg, key, ids, None)
        want = _eager_path_lengths(ts, tc, tcfg, key, ids, None)
        assert int((got == tcfg.max_depth + 1).sum()) > 0
    assert torch.equal(got, want)
    assert loops.passes == passes * loops.syncs
    assert loops.live_passes <= loops.passes < loops.live_passes + passes


def test_bounce_draw_of_a_device_counter():
    """The bounce uniforms of a 0-d int64 depth are the Python int's bits."""
    key, ids = trng.base_key(7), torch.arange(1052)
    for d in (0, 3, 50):
        assert torch.equal(
            trng.bounce_uniforms(key, ids, torch.tensor(d)),
            trng.bounce_uniforms(key, ids, d))


def test_the_loop_makes_the_replays_camera_rays():
    """The camera rays that the recorder's init makes are the ones the
    replay's body makes, bit for bit."""
    *_, ts, tc, tcfg = _case("random-spheres")
    key, ids = trng.base_key(0), torch.arange(tcfg.num_rays).flip(0)
    state = trp.camera_record_state(tc, key, ids, cfg=tcfg)
    o, d = tg._rays(tc, tcfg, key, ids)
    assert torch.equal(state["o"], o) and torch.equal(state["dr"], d)
    assert state["tape"].shape == (tcfg.max_depth + 2, tcfg.num_rays)
    assert state["d"].shape == () and state["d"].dtype == torch.int64


PASS_CASES = [("lockstep", "dense sweep"), ("lockstep", "K4 plain"),
              ("lockstep", "K5 plain"), ("pool", "dense sweep"),
              ("pool", "K4 plain"), ("pool", "K5 plain"),
              ("lengths", "dense sweep")]


@pytest.mark.parametrize("loop,accel", PASS_CASES,
                         ids=[f"{a}-{b}" for a, b in PASS_CASES])
def test_no_host_traffic_in_a_pass(monkeypatch, loop, accel):
    *_, ts, tc, tcfg = _case("triangle-mesh" if accel == "K5 plain"
                             else "random-spheres")
    inputs = dict(scene=ts, camera=tc, accel=ACCELS[accel](ts),
                  key=trng.base_key(3), ray_ids=torch.arange(300))
    static = dict(cfg=tcfg, intersect_fn=PLAIN_FN[accel])
    if loop == "pool":
        static["pool_size"] = 64
        init, step = trp.record_pool_state, trp.record_pool_pass
    elif loop == "lockstep":
        init, step = trp.camera_record_state, trp.record_bounce
    else:
        init, step = tm._length_state, tm._length_pass
    state = init(**inputs, **static)
    step(state, **inputs, **static)  # the warm call
    want = {k: v.clone() for k, v in state.items()}
    step(state, **inputs, **static)
    after = state
    state = {k: v.clone() for k, v in want.items()}
    traffic = _HostTraffic(monkeypatch)
    step(state, **inputs, **static)
    monkeypatch.undo()
    assert traffic.calls == []
    assert all(torch.equal(state[k], after[k]) for k in state)


def _grad_case(fields=("albedo", "fuzz", "sphere_center")):
    """random-spheres 16x8 @ 2 at depth 8, the parameters at 0.8 x the
    truth's and the target the truth's radiance (JAX's ray_radiance)."""
    js, jc, cfg = jb.random_scene(nx=16, ny=8, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=DEPTH)
    key = jrng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    true_params, _ = jg.split_params(js, fields=fields)
    target = jg.ray_radiance(true_params, js, jc, cfg, key, ids)
    bad = {k: v * 0.8 for k, v in true_params.items()}
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    tcfg = RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                        max_depth=cfg.max_depth, t_min=cfg.t_min)
    port = dict(scene=ts, camera=tc, cfg=tcfg, key=trng.base_key(0),
                ids=torch.arange(cfg.num_rays),
                target=torch.from_numpy(np.array(target)))
    return (js, jc, cfg, key, ids, target, bad), port


def _params(bad):
    return params_from_numpy({k: np.asarray(v) for k, v in bad.items()})


def test_direct_step_equals_eager_and_matches_jax(loops):
    (js, jc, cfg, key, ids, target, bad), t = _grad_case()
    args = (t["scene"], t["camera"], t["cfg"], t["key"], t["ids"],
            t["target"])
    params = _params(bad)
    loss, grads = tg.render_loss_and_grads(params, *args)
    want_loss, want = _eager_loss_and_grads(params, *args)
    assert float(loss) == float(want_loss)
    for k in params:
        assert torch.equal(grads[k], want[k]), k
    assert loops.syncs >= 1 and loops.captures == 0
    jloss, jgrads = jg.render_loss_and_grads(bad, js, jc, cfg, key, ids,
                                             target)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("albedo", "fuzz"):
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # The centres' gradient rests on grazing rays, whose hits the two
    # packages round apart: tests/test_torch_replay.py's bound for them.
    g = grads["sphere_center"].double().flatten()
    w = torch.from_numpy(np.asarray(jgrads["sphere_center"],
                                    np.float64)).flatten()
    assert float(g @ w / (g.norm() * w.norm())) >= 0.999
    assert abs(float(g.norm() / w.norm()) - 1.0) <= 0.03
    # The pool recorder in the loss gives the same tape, so the same step.
    pool_loss, pool_grads = tg.render_loss_and_grads(params, *args,
                                                     record_pool=100)
    assert float(pool_loss) == float(loss)
    assert all(torch.equal(pool_grads[k], grads[k]) for k in params)


def test_sgd_step_matches_jax():
    (js, jc, cfg, key, ids, target, bad), t = _grad_case()
    params = _params(bad)
    loss, new = tg.sgd_step(params, t["scene"], t["camera"], t["cfg"],
                            t["key"], t["ids"], t["target"], lr=0.3)
    want_loss, grads = _eager_loss_and_grads(
        params, t["scene"], t["camera"], t["cfg"], t["key"], t["ids"],
        t["target"])
    assert float(loss) == float(want_loss)
    for k in params:
        assert torch.equal(new[k], (params[k] - 0.3 * grads[k]).detach())
    jloss, jnew = jg.sgd_step(bad, js, jc, cfg, key, ids, target, lr=0.3)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_fit_step_with_adam_matches_jax():
    """The albedo, as tests/test_torch_grad.py fits it: Adam's update of a
    near-zero gradient (the centres') can flip sign between packages."""
    import optax

    (js, jc, cfg, key, ids, target, bad), t = _grad_case(("albedo",))
    opt = optax.adam(0.02)
    jstep = jg.make_fit_step(js, jc, cfg, ids, target, opt)
    jp, state, jlosses = dict(bad), opt.init(bad), []
    for _ in range(3):
        jl, jp, state = jstep(jp, state, key)
        jlosses.append(float(jl))

    params, eager = _params(bad), _params(bad)
    step = tg.make_fit_step(t["scene"], t["camera"], t["cfg"], t["ids"],
                            t["target"], tg.make_optimizer("adam", params,
                                                           0.02),
                            device="cpu")
    eager_opt = tg.make_optimizer("adam", eager, 0.02)
    losses = []
    for _ in range(3):
        losses.append(float(step(params, t["key"])))
        eloss, egrads = _eager_loss_and_grads(
            eager, t["scene"], t["camera"], t["cfg"], t["key"], t["ids"],
            t["target"])
        tg.apply_grads(eager_opt, eager, egrads)
        assert losses[-1] == float(eloss)
        assert all(torch.equal(params[k], eager[k]) for k in params)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]


OCCUPANCY_CASES = [("three-spheres", 24, 12, "dense sweep"),
                   ("random-spheres", 16, 8, "dense sweep"),
                   ("triangle-mesh", 16, 8, "dense sweep"),
                   ("random-spheres", 16, 8, "K4 plain"),
                   ("random-spheres", 16, 8, "K5 plain")]


@pytest.mark.parametrize("name,nx,ny,accel", OCCUPANCY_CASES,
                         ids=[f"{c[0]}-{c[3]}" for c in OCCUPANCY_CASES])
def test_occupancy_equals_jax_and_eager(loops, name, nx, ny, accel):
    """At ``tests/test_torch_metrics.py``'s sizes, every ray of the frame
    at the preset's depth."""
    js, jc, cfg = jb.build_preset(name, nx=nx, ny=ny, spp=2)
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    tcfg = RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                        max_depth=cfg.max_depth, t_min=cfg.t_min)
    acc = ACCELS[accel](ts)
    got = tm.wavefront_occupancy(ts, tc, tcfg, seed=0, accel=acc,
                                 device="cpu")
    want = jax_occupancy(js, jc, cfg, seed=0)
    for k in ("rays", "alive_per_bounce", "bounce_histogram",
              "alive_frac_per_bounce"):
        assert got[k] == want[k], k
    for k in ("avg_path_length", "wavefront_efficiency"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    ids = torch.arange(tcfg.num_rays)
    assert torch.equal(
        tm._path_lengths(ts, tc, tcfg, trng.base_key(0), ids, acc),
        _eager_path_lengths(ts, tc, tcfg, trng.base_key(0), ids, acc))
    assert loops.syncs >= 2 and loops.captures == 0


def test_cli_fit_direct_prints_loop_counters():
    """``fit`` without ``--fast`` on the CPU: the recorder's loop ran its
    passes (one flag read a block of ``PASSES_PER_READ``, the target's
    recording and each step's), and nothing was captured."""
    proc = _run_cli("--preset", "three-spheres", "--nx", "12", "--ny", "6",
                    "--spp", "2", "--fields", "albedo", "--opt", "adam",
                    "--lr", "0.05", "--steps", "2", cmd="fit")
    assert proc.returncode == 0, proc.stderr
    last = json.loads(proc.stdout.splitlines()[-1])
    assert last["graphs"] == {"captures": 0, "replays": 0}
    loops = last["loops"]
    assert set(loops) == {"captures", "replays", "passes", "live_passes",
                          "syncs"}
    assert loops["captures"] == loops["replays"] == 0
    assert loops["syncs"] >= 3 and loops["live_passes"] >= 3
    assert loops["passes"] == graphed.PASSES_PER_READ * loops["syncs"]
