"""The differentiable scan (``method="scan"``) as one captured program, on
the CPU, and the direct step's loss over a count.

``diff.grad.render_loss_and_grads_scan`` hands its body
(``scan_loss_and_grads``: the camera rays, ``max_depth + 1`` unrolled
trips, the loss and ``torch.autograd.grad``) to ``SCAN_GRAPHS``, a
``GraphCache``: on a CUDA device a capture and its replays, on the CPU the
body run eagerly on the cache's static buffers.  Each trip's closest hit
is given the rays' liveness (``render.integrator.closest_hit``), so that
K11 sweeps only the live rays and gives the dead ones the miss.

- The cache's route is ``torch.equal`` to the eager
  ``value_and_grad(render_loss(..., method="scan"))`` in the loss and
  every gradient, on the ``SHALLOW`` presets of tests/test_torch_replay.py
  and again on other parameters, keys and targets of one signature (a
  stale buffer would show).
- Against the JAX package's ``render_loss_and_grads(method="scan")`` on
  the same presets, seeds and fields: the scan finds its own hits, so both
  packages' tapes are recorded first and shown equal (the same selection);
  then the loss within ``rtol=1e-5`` and every gradient within
  ``rtol=1e-4, atol=1e-6``, the bounds at which tests/test_torch_replay.py
  holds the port's replay to JAX's.  random-spheres 16x8 @ 2 at depth 50,
  whose ground row most rays read (K17's sum on its hot row): its tapes
  agree on all but 3 of 5120 entries (one ray trapped between the ground
  and a sphere, rows 16-18), and it takes test_torch_replay.py's bounds
  for this scene (the loss ``rtol=1e-4``, each gradient's cosine at least
  0.999 and its norm within 3%): at the shallow presets' bounds it fails
  on the route before K16 and K17 as well (the loss 1.2e-5 apart, the
  geometry gradients up to 145 times the bound).  triangle-mesh is left out: 5 of its
  144 rays meet the edge that two floor triangles share, where the two
  packages' Moller-Trumbore distances differ by an ulp (or tie in one
  package and not in the other), so the winner flips on 6 tape entries and
  the two scans differentiate different paths.
- The liveness mask changes no value: radiance and every gradient
  ``torch.equal`` to the route whose closest hit takes five arguments and
  sweeps every ray, every gradient finite; the mask reaches the closest
  hit on every trip and some trips have dead rays.
- After a warm call the scan body makes no tensor from host data and reads
  nothing back (tests/test_torch_replay_graph.py's count, the CPU's
  stand-in for capturability).
- ``tape_loss_and_grads`` without ``num_values`` is bit-equal to the mean
  body it had before; two halves of the rays over the whole batch's count,
  summed, equal the whole within ``rtol=1e-6``.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff.grad import (
    render_loss_and_grads as jax_loss_grads, split_params as jax_split)
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (params_from_numpy,
                                               params_to_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.diff import grad as tg
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.diff.graphed import GraphCache
from first_raytracer_tpu_torch.render.integrator import default_intersect
from test_torch_replay import SHALLOW, _case, _port_rays
from test_torch_replay_graph import _HostTraffic


def _args(p):
    return (p["scene"], p["camera"], p["cfg"], p["key"], p["ids"])


def _eager_scan(params, p, target, intersect_fn=None):
    """The scan's value and gradient op by op, as ``render_loss_and_grads``
    computed it before the graph: ``value_and_grad`` of ``render_loss``."""
    return tg.value_and_grad(
        lambda q: tg.render_loss(q, *_args(p), target, None, intersect_fn,
                                 method="scan"), params)


def _equal(got, want):
    assert torch.equal(got[0], want[0])
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


@pytest.mark.parametrize("name", SHALLOW)
def test_scan_graph_body_equals_eager(name):
    p, _ = _case(name)
    params = params_from_numpy(p["params"])
    want = _eager_scan(params, p, p["target"])
    _equal(tg.render_loss_and_grads(params, *_args(p), p["target"],
                                    method="scan"), want)
    # Other values of the same signature through one cache, in turns.
    cache = GraphCache()
    g = torch.Generator().manual_seed(7)
    for i in range(3):
        q = {k: (v * (1 + 0.05 * i * torch.rand(v.shape, generator=g)))
             for k, v in params.items()}
        key = trng.base_key(1 + 10 * i)
        target = torch.rand(p["target"].shape, generator=g)
        got = cache.run(
            tg.scan_loss_and_grads,
            dict(cfg=p["cfg"], intersect_fn=default_intersect,
                 num_values=None),
            dict(params=q, scene=p["scene"], camera=p["camera"], key=key,
                 ray_ids=p["ids"], target=target, accel=None),
            torch.device("cpu"))
        pi = dict(p, key=key)
        _equal(got, _eager_scan(q, pi, target))
    assert len(cache.entries) == 1 and cache.captures == cache.replays == 0


@functools.lru_cache(maxsize=None)
def _jax_scan(name):
    """JAX's differentiable scan on ``_case(name)``'s preset, seed, fields
    and zero target: (loss, grads)."""
    if name == "random-spheres":
        js, jc, cfg = jb.random_scene(nx=16, ny=8, spp=2)
    else:
        js, jc, cfg = jb.build_preset(name, nx=12, ny=6, spp=2)
        cfg = dataclasses.replace(cfg, max_depth=8)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    params, _ = jax_split(js)
    loss, grads = jax_loss_grads(params, js, jc, cfg, jrng.base_key(1), ids,
                                 jnp.zeros((cfg.num_rays, 3), jnp.float32),
                                 method="scan")
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("name", ["three-spheres", "camera-effects",
                                  "random-spheres"])
def test_scan_matches_jax_scan(name):
    p, _ = _case(name)
    # The same selection: the port's tape of its rays equals JAX's (on
    # random-spheres at depth 50 per entry above 0.999).
    o, d = _port_rays(p)
    tape = trp.record_paths(p["scene"], o, d, p["ids"], p["key"], p["cfg"])
    tape = tape[:trp.live_trips(tape)]
    if name != "random-spheres":
        assert torch.equal(tape, p["tape"])
    else:
        assert tape.shape == p["tape"].shape
        assert float((tape == p["tape"]).double().mean()) > 0.999
    loss, grads = tg.render_loss_and_grads(params_from_numpy(p["params"]),
                                           *_args(p), p["target"],
                                           method="scan")
    want_loss, want_grads = _jax_scan(name)
    got = params_to_numpy(grads)
    assert set(got) == set(want_grads)
    if name != "random-spheres":
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        for k, g in want_grads.items():
            np.testing.assert_allclose(got[k], g, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        return
    # The final scene's float32 gradients are ill-conditioned between
    # the packages (grazing rays): tests/test_torch_replay.py's bounds for
    # this scene, the loss rtol=1e-4, each gradient's cosine with JAX's at
    # least 0.999 and its norm within 3% (measured 1.2e-5; 1 - 1.2e-4 and
    # 1.1%, both on sphere_radius).
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-4)
    for k, g in want_grads.items():
        a, b = g.ravel(), got[k].ravel()
        assert a.shape == b.shape and np.isfinite(b).all(), k
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0.0:
            assert nb == 0.0, k
            continue
        assert a @ b / (na * nb) >= 0.999, k
        assert abs(nb / na - 1.0) <= 0.03, k


def _five_arguments(scene, accel, origin, direction, t_min):
    """The dense closest hit without the liveness mask: every ray swept."""
    return default_intersect(scene, accel, origin, direction, t_min)


@pytest.mark.parametrize("name", SHALLOW)
def test_scan_mask_changes_nothing(name):
    p, _ = _case(name)
    params = params_from_numpy(p["params"])
    dead = []

    def masked(scene, accel, origin, direction, t_min, alive=None):
        assert alive is not None and alive.shape == (origin.shape[0],)
        dead.append(int((~alive).sum()))
        return default_intersect(scene, accel, origin, direction, t_min,
                                 alive)
    masked.takes_alive = True

    with torch.no_grad():
        rad = tg.ray_radiance(params, *_args(p), intersect_fn=masked,
                              method="scan")
        rad_all = tg.ray_radiance(params, *_args(p),
                                  intersect_fn=_five_arguments,
                                  method="scan")
    assert torch.equal(rad, rad_all)
    assert len(dead) == p["cfg"].max_depth + 1 and max(dead) > 0
    got = tg.render_loss_and_grads(params, *_args(p), p["target"],
                                   intersect_fn=masked, method="scan")
    want = tg.render_loss_and_grads(params, *_args(p), p["target"],
                                    intersect_fn=_five_arguments,
                                    method="scan")
    _equal(got, want)
    assert all(bool(torch.isfinite(g).all()) for g in got[1].values())
    assert float(got[1]["albedo"].abs().max()) > 0.0


@pytest.mark.parametrize("name", ["three-spheres", "triangle-mesh"])
def test_scan_body_no_host_traffic_after_a_warm_call(monkeypatch, name):
    p, _ = _case(name)
    params = params_from_numpy(p["params"])
    static = dict(cfg=p["cfg"], intersect_fn=default_intersect,
                  num_values=None)

    def body():
        return tg.scan_loss_and_grads(
            params, p["scene"], p["camera"], p["key"], p["ids"],
            p["target"], None, **static)

    want = body()
    traffic = _HostTraffic(monkeypatch)
    got = body()
    monkeypatch.undo()
    assert traffic.calls == []
    _equal(got, want)


def test_tape_body_over_a_count():
    p, _ = _case("random-spheres")
    params = params_from_numpy(p["params"])
    target = torch.from_numpy(np.random.RandomState(0).rand(
        *p["target"].shape).astype(np.float32))
    scene, cam, cfg, key, ids, tape = (p["scene"], p["camera"], p["cfg"],
                                       p["key"], p["ids"], p["tape"])
    o, d = _port_rays(p)

    def mean_loss(q):  # the body's loss before it took num_values
        rad = trp.trace_rays_replay(tg.merge_params(scene, q), o, d, ids,
                                    key, cfg, tape)
        return torch.mean((rad - target) ** 2)

    _equal(tg.tape_loss_and_grads(params, scene, cam, key, ids, target,
                                  tape, cfg=cfg),
           tg.value_and_grad(mean_loss, params))
    loss, grads = tg.render_loss_and_grads_tape(params, scene, cam, cfg,
                                                key, ids, target, tape)
    h = len(ids) // 2
    halves = [tg.render_loss_and_grads_tape(
        params, scene, cam, cfg, key, ids[a:a + h], target[a:a + h],
        tape[:, a:a + h], num_values=target.numel()) for a in (0, h)]
    np.testing.assert_allclose(float(halves[0][0] + halves[1][0]),
                               float(loss), rtol=1e-6)
    for k, g in grads.items():
        np.testing.assert_allclose((halves[0][1][k] + halves[1][1][k]
                                    ).numpy(), g.numpy(), rtol=1e-6,
                                   err_msg=k)
