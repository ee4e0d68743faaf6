"""K12's packed windows, its bounce counter and its pool launch with K13
folded in, on the CPU: ``kernels/csrc/wavefront_pass.cu`` compiled by g++
through the host emulation (``kernels/host_emu``), driven by the wrappers'
own launch code on CPU tensors, against the plain seams on clones of the
same state, ``torch.equal`` on every tensor.

- Lockstep and length modes with a set count of live rays in every window
  of ``record_pass.STEP_WINDOW`` rays (0, 1, 31, 32, 33, half, all) at ray
  counts off the window (0, 1, 255, 257, 1000, 1025), at a bounce inside
  the depth cap, at the cap and past it: the tape's row, the lengths, the
  rays, the liveness and the counter against ``record_step_plain``.
- The counter advanced exactly once a launch over repeated launches, with
  the blocks one after another and interleaved (fewer blocks in flight
  than the grid, and more), the arrival word cleared after each.
- The pool launch pass by pass against ``record_shade_plain`` then
  ``record_regenerate_plain``: pools of 1, 255, 256, 257 slots, 3 tiles
  and 2^12, streams that run out inside a pass, scan words left by five
  earlier passes (garbage counts, never taken for this pass's), with the
  blocks one after another and with fewer and more blocks in flight than
  the persistent grid.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import record_pass as rp
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.render.camera import camera_rays_plain
from first_raytracer_tpu_torch.scene.builders import build_preset
from test_torch_record_pass import _brute, _pool_passes, host_lib
from test_torch_wavefront_pass import _card_rounding, _clone, _interleaved

__all__ = ["host_lib"]  # the fixture, imported

W = rp.STEP_WINDOW
COUNTS = (0, 1, 255, 257, 1000, 1025)
LIVE = ("0", "1", "31", "32", "33", "half", "all")
CASES = [(n, k) for n in COUNTS for k in (LIVE if n else ("0",))]


def _scene():
    """(scene, camera, cfg): random-spheres with a checker ground, 1152
    camera rays, a depth cap of 5."""
    scene, cam, cfg = build_preset("random-spheres", nx=48, ny=24, spp=1,
                                   checker_ground=True)
    return scene, cam, dataclasses.replace(cfg, max_depth=5)


def _window_mask(n, live, seed):
    """(n,) bool: in each window of ``W`` rays (the last may be short, m
    rays), ``live`` of them alive at places drawn from ``seed``: a count,
    "half" (m // 2) or "all"."""
    gen = np.random.default_rng(seed)
    mask = np.zeros(n, dtype=bool)
    for lo in range(0, n, W):
        m = min(W, n - lo)
        k = {"half": m // 2, "all": m}.get(live)
        k = min(int(live), m) if k is None else k
        mask[lo + gen.choice(m, size=k, replace=False)] = True
    return torch.from_numpy(mask)


def _step_state(n, live, mode, bounce, seed):
    """The recorder's state of ``n`` camera rays at the bounce counter
    ``bounce`` with ``_window_mask``'s liveness; in length mode lengths
    drawn from ``seed``, so that a dead ray's shows it was left alone."""
    scene, cam, cfg = _scene()
    key = rng.base_key(seed)
    ids = torch.arange(n) * 7 % cfg.num_rays
    o, d = camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    state = trp.record_state(o, d, cfg=cfg, tape=mode == "tape")
    state["alive"].copy_(_window_mask(n, live, seed))
    state["d"].fill_(bounce)
    if mode == "length":
        state["length"] = torch.from_numpy(np.random.default_rng(
            seed).integers(0, 9, n))
    else:
        state["tape"].copy_(torch.from_numpy(np.random.default_rng(
            seed).integers(-1, 50, tuple(state["tape"].shape)).astype(
                np.int32)))
    return scene, cfg, key, ids, state


def _step_vs_plain(what, scene, cfg, key, ids, state):
    """K12 on a clone of ``state`` against ``record_step_plain`` on
    another: every tensor equal, the counter advanced once, the arrival
    word clear.  Returns the plain state."""
    prim, _, hit = _brute(scene, state["o"], state["dr"], cfg.t_min)
    got, want = _clone(state), _clone(state)
    rp._launch_step(got, prim, hit, scene=scene, key=key, ray_ids=ids,
                    cfg=cfg)
    with _card_rounding():
        rp.record_step_plain(want, prim, hit, scene=scene, key=key,
                             ray_ids=ids, cfg=cfg)
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, (what, bad)
    assert int(got["d"]) == int(state["d"]) + 1, what
    assert int(got["arrivals"]) == 0, what
    return want


@pytest.mark.parametrize("mode", ["tape", "length"])
@pytest.mark.parametrize("n,live", CASES,
                         ids=[f"{n}rays-{k}live" for n, k in CASES])
def test_step_windows_equal_plain(host_lib, n, live, mode):
    """A bounce inside the depth cap with a set count of live rays in every
    window: K12 bit-equal to ``record_step_plain``, only the live rays'
    lengths and rays moved, the dead rays' tape entries -1."""
    scene, cfg, key, ids, state = _step_state(n, live, mode, 1, n + 3)
    want = _step_vs_plain(f"{n} rays, {live} live a window", scene, cfg,
                          key, ids, state)
    dead = ~state["alive"]
    if mode == "length":
        assert torch.equal(want["length"][dead], state["length"][dead])
        assert torch.equal(want["length"] - state["length"],
                           state["alive"].long())
    else:
        assert bool((want["tape"][1][dead] == -1).all())
        assert torch.equal(want["tape"][2:], state["tape"][2:])


@pytest.mark.parametrize("mode", ["tape", "length"])
@pytest.mark.parametrize("bounce", [5, 6, 9], ids=["at-cap", "past-cap",
                                                   "far-past-cap"])
@pytest.mark.parametrize("n", COUNTS)
def test_step_windows_at_the_depth_cap(host_lib, n, bounce, mode):
    """Half of every window alive at the depth cap (hits recorded, no ray
    goes on) and past it (the scratch row all -1, every ray ended): K12
    bit-equal to ``record_step_plain``."""
    scene, cfg, key, ids, state = _step_state(n, "half", mode, bounce, n)
    want = _step_vs_plain(f"{n} rays at bounce {bounce}", scene, cfg, key,
                          ids, state)
    assert not bool(want["alive"].any())
    if mode == "tape" and bounce > cfg.max_depth:
        assert bool((want["tape"][cfg.max_depth + 1] == -1).all())


@pytest.mark.parametrize("mode", ["tape", "length"])
@pytest.mark.parametrize("resident", [0, 2, 3, 8],
                         ids=["sequential", "2-in-flight", "3-in-flight",
                              "8-in-flight"])
def test_step_counter_once_a_launch(host_lib, resident, mode):
    """Eight bounces in a row over 2300 rays (five windows; the last
    short): after each launch the counter has moved by exactly one and the
    arrival word is clear, with the blocks one after another, fewer in
    flight than the grid, and more; every bounce bit-equal to the plain
    seam."""
    scene, cfg, key, ids, state = _step_state(2300, "all", mode, 0, 11)
    with _interleaved(host_lib, resident, seed=resident + 1):
        for b in range(8):
            state = _step_vs_plain(f"bounce {b}", scene, cfg, key, ids,
                                   state)
            assert int(state["d"]) == b + 1


POOLS = {"1": 1, "255": 255, "256": 256, "257": 257,
         "3tiles": 3 * rp.RECORD_TILE - 5, "2^12": 1 << 12}


@pytest.mark.parametrize("resident", [0, 2, 8],
                         ids=["sequential", "2-in-flight", "8-in-flight"])
@pytest.mark.parametrize("pool", POOLS)
def test_fused_pool_passes(host_lib, pool, resident):
    """Every pass of the pool recorder over a stream of scattered ids a
    half pool and 37 longer than the pool (it runs out inside a pass), and
    two inert passes after, on scan words five earlier passes left: K12's
    pool launch with K13 folded in bit-equal to ``record_shade_plain`` then
    ``record_regenerate_plain``, with the blocks one after another, fewer
    in flight than the persistent grid (up to 4 blocks here) and more."""
    C = POOLS[pool]
    scene, cam, cfg = build_preset("random-spheres", nx=96, ny=48, spp=2,
                                   checker_ground=True)
    cfg = dataclasses.replace(cfg, max_depth=4)
    R = C + C // 2 + 37
    ray_ids = torch.randperm(cfg.num_rays, generator=torch.Generator(
    ).manual_seed(C))[:R].contiguous()
    with _interleaved(host_lib, resident, seed=C + resident):
        passes, survivors = _pool_passes(host_lib, scene, cam, cfg,
                                         rng.base_key(C % 7), ray_ids, C,
                                         stale=5)
    assert passes > 2 and (survivors > 0 or C == 1)
