"""The port's tape replay and its gradients against the JAX package's.

JAX's wavefront tape is fed to both packages, so selection is identical and
only the replay's arithmetic differs.  The two packages round differently
(XLA contracts multiply-adds, ``jnp.cbrt`` against a correctly rounded cube
root, XLA's and libm's sin and cos), and the oc-form sphere quadratic
cancels: at the final scene's camera distance ``b^2 - c`` loses ~1e-5 of
absolute precision, so on a near-grazing hit t, and with it the scattered
direction, moves by up to ~1e-3.  Bounds:

- depth 8 at 12x6 @ 2 (tests/test_replay.py's setup) on three-spheres,
  triangle-mesh and camera-effects: radiance ``rtol=1e-5, atol=1e-5``
  (measured max 3.8e-6), loss ``rtol=1e-5``, every gradient ``rtol=1e-4,
  atol=1e-6`` (the JAX package's tape-swap bound,
  tests/test_record_mega.py:109-112);
- random-spheres 16x8 @ 2 at its full depth 50, where two rays graze:
  radiance 99% of values within 3e-5 and all within 1e-3 (measured 8.5e-6
  and 1.1e-4), loss ``rtol=1e-4`` (measured 1.2e-5), each gradient's
  cosine with JAX's at least 0.999 and its norm within 3% (measured
  1 - 1.1e-4 and 1.2%, both on ``sphere_radius``).
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
    render_loss_and_grads_tape as jax_loss_grads_tape,
    split_params as jax_split)
from first_raytracer_tpu.diff.replay import (live_trips as jax_live_trips,
                                             plan_buckets as jax_plan,
                                             record_paths as jax_record,
                                             trace_rays_replay as jax_replay)
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               params_from_numpy,
                                               params_to_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.diff import grad as tg
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.render.integrator import RenderConfig

SHALLOW = ["three-spheres", "triangle-mesh", "camera-effects"]
CASES = SHALLOW + ["random-spheres"]


@functools.lru_cache(maxsize=None)
def _case(name):
    """Both packages' state for a preset, JAX's tape, JAX's replay."""
    if name == "random-spheres":
        js, jc, cfg = jb.random_scene(nx=16, ny=8, spp=2)
    else:
        js, jc, cfg = jb.build_preset(name, nx=12, ny=6, spp=2)
        cfg = dataclasses.replace(cfg, max_depth=8)
    key = jrng.base_key(1)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    tape = jax_record(js, o, d, ids, key, cfg)
    tape = np.asarray(tape[:jax_live_trips(tape)])
    rad = np.asarray(jax_replay(js, o, d, ids, key, cfg, jnp.asarray(tape)))
    params, _ = jax_split(js)
    target = np.zeros((cfg.num_rays, 3), np.float32)
    loss, grads = jax_loss_grads_tape(params, js, jc, cfg, key, ids,
                                      jnp.asarray(target), jnp.asarray(tape))
    tcfg = RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                        max_depth=cfg.max_depth, t_min=cfg.t_min)
    port = dict(scene=scene_from_numpy(js.as_numpy()),
                camera=camera_from_numpy(jc), cfg=tcfg,
                key=trng.base_key(1), ids=torch.arange(cfg.num_rays),
                tape=torch.from_numpy(tape), target=torch.from_numpy(target),
                params={k: np.asarray(v) for k, v in params.items()})
    want = dict(rad=rad, loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})
    return port, want


def _port_rays(p):
    return generate_rays(p["camera"], p["cfg"].nx, p["cfg"].ny, p["cfg"].spp,
                         p["ids"], trng.camera_uniforms(p["key"], p["ids"]))


@pytest.mark.parametrize("name", CASES)
def test_replay_radiance_matches_jax(name):
    p, want = _case(name)
    o, d = _port_rays(p)
    got = trp.trace_rays_replay(p["scene"], o, d, p["ids"], p["key"],
                                p["cfg"], p["tape"]).numpy()
    assert got.shape == want["rad"].shape and np.isfinite(got).all()
    if name in SHALLOW:
        np.testing.assert_allclose(got, want["rad"], rtol=1e-5, atol=1e-5)
    else:
        diff = np.abs(got - want["rad"])
        assert np.quantile(diff, 0.99) < 3e-5 and diff.max() < 1e-3


@pytest.mark.parametrize("name", CASES)
def test_replay_grads_match_jax(name):
    p, want = _case(name)
    loss, grads = tg.render_loss_and_grads_tape(
        params_from_numpy(p["params"]), p["scene"], p["camera"], p["cfg"],
        p["key"], p["ids"], p["target"], p["tape"])
    assert set(grads) == set(tg.DIFF_FIELDS)
    got = params_to_numpy(grads)
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


@pytest.mark.parametrize("spp,max_groups", [(2, 6), (4, 4)])
def test_live_trips_and_plan_match_jax(spp, max_groups):
    js, jc, cfg = jb.random_scene(nx=16, ny=8, spp=spp)
    key = jrng.base_key(1)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    tape = np.asarray(jax_record(js, o, d, ids, key, cfg))
    order, groups = trp.plan_buckets(torch.from_numpy(tape), max_groups)
    want_order, want_groups = jax_plan(jnp.asarray(tape), max_groups)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want_order))
    assert groups == want_groups
    assert sum(n for _, n, _ in groups) == cfg.num_rays
    assert trp.live_trips(torch.from_numpy(tape)) == jax_live_trips(tape)
    empty = torch.full((5, 7), -1, dtype=torch.int32)
    assert trp.live_trips(empty) == 1
    assert trp.plan_buckets(empty)[1] == jax_plan(jnp.asarray(empty))[1]


def test_bucketed_matches_flat_replay():
    """Depth buckets change only the f32 summation order
    (tests/test_replay_planned.py:44-58 bounds)."""
    p, _ = _case("random-spheres")
    params = params_from_numpy(p["params"])
    r = np.random.RandomState(0)
    target = torch.from_numpy(r.rand(*p["target"].shape).astype(np.float32))
    args = (p["scene"], p["camera"], p["cfg"], p["key"], p["ids"], target,
            p["tape"])
    l_flat, g_flat = tg.render_loss_and_grads_tape(params, *args)
    l_b, g_b = tg.render_loss_and_grads_bucketed(params, *args)
    assert len(trp.plan_buckets(p["tape"], 4)[1]) > 1
    np.testing.assert_allclose(float(l_b), float(l_flat), rtol=1e-5)
    for k in g_flat:
        np.testing.assert_allclose(g_b[k].numpy(), g_flat[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", SHALLOW)
def test_replay_matches_scan(name):
    """Replay and the direct differentiable scan agree in radiance and
    gradients (the JAX package's bounds, tests/test_replay.py:50-97)."""
    p, _ = _case(name)
    fields = (("tri_v0", "tri_v1", "tri_v2", "albedo")
              if name == "triangle-mesh" else
              ("albedo", "sphere_center", "fuzz", "ref_idx"))
    params, _ = tg.split_params(p["scene"], fields=fields)
    args = (p["scene"], p["camera"], p["cfg"], p["key"], p["ids"])
    with torch.no_grad():
        rad_r = tg.ray_radiance(params, *args, method="replay")
        rad_s = tg.ray_radiance(params, *args, method="scan")
    np.testing.assert_allclose(rad_r.numpy(), rad_s.numpy(), rtol=1e-4,
                               atol=1e-5)
    l_r, g_r = tg.render_loss_and_grads(params, *args, p["target"],
                                        method="replay")
    l_s, g_s = tg.render_loss_and_grads(params, *args, p["target"],
                                        method="scan")
    np.testing.assert_allclose(float(l_r), float(l_s), rtol=1e-6)
    for k in fields:
        np.testing.assert_allclose(g_r[k].numpy(), g_s[k].numpy(),
                                   rtol=2e-3, atol=1e-7, err_msg=k)
        assert bool((g_r[k] != 0).any()), k


@pytest.mark.parametrize("name", ["triangle-mesh", "random-spheres"])
def test_every_gradient_is_finite(name):
    """All DIFF_FIELDS on the lockstep-recorded replay: finite everywhere
    (dead and missing lanes feed no Inf or NaN backward); albedo moves."""
    p, _ = _case(name)
    params, _ = tg.split_params(p["scene"])
    loss, grads = tg.render_loss_and_grads(
        params, p["scene"], p["camera"], p["cfg"], p["key"], p["ids"],
        p["target"])
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert g.shape == params[k].shape and bool(torch.isfinite(g).all()), k
    assert float(grads["albedo"].abs().max()) > 0.0


def test_tape_semantics_and_trim():
    """Tape entries are -1 or valid global ids, death is final, and
    replaying ``tape[:live_trips]`` changes nothing."""
    p, _ = _case("three-spheres")
    o, d = _port_rays(p)
    tape = trp.record_paths(p["scene"], o, d, p["ids"], p["key"], p["cfg"])
    assert tape.shape == (p["cfg"].max_depth + 1, p["cfg"].num_rays)
    assert tape.dtype == torch.int32
    assert int(tape.min()) >= -1
    assert int(tape.max()) < p["scene"].num_primitives
    dead = torch.zeros(tape.shape[1], dtype=torch.bool)
    for row in tape:
        assert not bool((dead & (row >= 0)).any())
        dead |= row < 0
    assert float((tape[0] >= 0).float().mean()) > 0.5
    params = params_from_numpy(p["params"])
    args = (p["scene"], p["camera"], p["cfg"], p["key"], p["ids"],
            p["target"])
    l_full, g_full = tg.render_loss_and_grads_tape(params, *args, tape)
    l_trim, g_trim = tg.render_loss_and_grads_tape(
        params, *args, tape[:trp.live_trips(tape)])
    assert float(l_full) == float(l_trim)
    for k in g_full:
        assert torch.equal(g_full[k], g_trim[k]), k


# The recorders on each closest hit.  JAX's Pallas intersectors run in
# interpret mode; its default dispatch takes the flat BVH to its walk.
ACCELS = ["dense", "clustered", "bvh"]


def _accels(kind, js, ts):
    """(JAX accel, JAX intersect_fn, port accel) of one kind."""
    from first_raytracer_tpu.accel.build import build_bvh as jax_bvh
    from first_raytracer_tpu.kernels import intersect_clustered as jic
    from first_raytracer_tpu.kernels import intersect_pallas as jip
    from first_raytracer_tpu_torch.accel.build import build_bvh
    from first_raytracer_tpu_torch.kernels import intersect_clustered as tic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as tip

    if kind == "bvh":
        return jax_bvh(js, backend="numpy"), None, build_bvh(ts)
    jmod, tmod, pack = {
        "dense": (jip, tip, "pack_scene_pallas"),
        "clustered": (jic, tic, "pack_scene_clustered")}[kind]
    jfn = getattr(jmod, "intersect_pallas" if kind == "dense"
                  else "intersect_clustered")
    return (getattr(jmod, pack)(js),
            functools.partial(jfn, interpret=True),
            getattr(tmod, pack)(ts))


@pytest.mark.parametrize("kind", ACCELS)
@pytest.mark.parametrize("name", ["three-spheres", "triangle-mesh"])
def test_recorders_with_an_accel_match_jax(name, kind):
    """The pool recorder with an accel gives the lockstep one's tape.  With
    K4 or K5 (the dense sweep's lowest-id rule) that is the port's tape
    without an accel, and JAX's tape of the same accel (depth 8, 12x6 @ 2)
    wherever the two packages' tapes without an accel agree: on the
    triangle mesh 6 of 1296 entries part between coplanar faces, whose t
    differ by an ulp of the two packages' rounding, the same entries with
    and without an accel.  The BVH walk keeps the first hit in walk order
    among equal t, so on coplanar faces its tape is held to JAX's walk's
    alone, on all but 0.5% of entries."""
    js, jc, cfg = jb.build_preset(name, nx=12, ny=6, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=8)
    key = jrng.base_key(1)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    ts, tc = scene_from_numpy(js.as_numpy()), camera_from_numpy(jc)
    tcfg = RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                        max_depth=cfg.max_depth, t_min=cfg.t_min)
    jacc, jfn, tacc = _accels(kind, js, ts)
    want = np.asarray(jax_record(js, o, d, ids, key, cfg, accel=jacc,
                                 intersect_fn=jfn))
    tkey, tids = trng.base_key(1), torch.arange(cfg.num_rays)
    to, td = generate_rays(tc, tcfg.nx, tcfg.ny, tcfg.spp, tids,
                           trng.camera_uniforms(tkey, tids))
    got = trp.record_paths(ts, to, td, tids, tkey, tcfg, accel=tacc)
    got_pool = trp.record_paths_pool(ts, tc, tcfg, tkey, tids, tacc,
                                     pool_size=64)
    torch.testing.assert_close(got_pool, got)
    if kind == "bvh":
        assert (got.numpy() != want).mean() < 0.005
        return
    plain = trp.record_paths(ts, to, td, tids, tkey, tcfg)
    torch.testing.assert_close(got, plain)
    parted = plain.numpy() != np.asarray(jax_record(js, o, d, ids, key, cfg))
    assert parted.mean() < 0.005
    np.testing.assert_array_equal(got.numpy() != want, parted)
