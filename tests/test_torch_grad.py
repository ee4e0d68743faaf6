"""The port's gradient entry points and fit steps against the JAX package.

Bounds:
- the first fit step's loss: ``rtol=1e-5`` against JAX's
  ``make_fit_step_replay`` on the same target (measured 7e-7), and the
  five-step Adam trajectory by loss ``rtol=1e-4`` (measured 2.1e-5 at the
  fifth step; parameters are not compared, since a near-zero gradient can
  flip the sign of an Adam update);
- five Adam steps (lr 0.05) from ``albedo * 0.6`` end below 0.6 x the
  first loss (tests/test_replay_planned.py:137-161);
- the pool recorder inside the loss: bit-equal to the lockstep one.

Run as a script, this file writes the golden that chip_smoke.py holds the
card's full-width gradient step against, computed by the JAX package on the
CPU (``JAX_PLATFORMS=cpu`` is forced):

    python tests/test_torch_grad.py --write-golden

It records the final scene's first 2^17 ray ids (1200x800 @ 10 spp, depth
50, seed 0) with JAX's wavefront ``record_paths`` and takes
``render_loss_and_grads_bucketed`` of the mean squared radiance (zero
target) over every ``DIFF_FIELDS`` leaf.  It writes the tape beside the
golden (``GOLDEN_TAPE``, int16, all 51 rows), so that the card can replay
JAX's own selection.  Then it replays that tape with JAX in float64
(``f64``): the geometry, fuzz and index gradients of this configuration
rest on a few near-tangent rays, where float32 rounding of the sphere
quadratic's discriminant moves them by tens of percent in either package,
so the card's float32 step is held to the loss and the albedo gradient,
and its float64 replay of JAX's tape to every field.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "first_raytracer_tpu_torch", "data",
                      "grad_golden_final_2p17.json")
GOLDEN_TAPE = GOLDEN.replace(".json", "_tape.npz")
GOLDEN_RAYS = 1 << 17

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from first_raytracer_tpu.core import rng as jrng  # noqa: E402
from first_raytracer_tpu.diff import grad as jg  # noqa: E402
from first_raytracer_tpu.diff import replay as jrp  # noqa: E402
from first_raytracer_tpu.render import camera as jcam  # noqa: E402
from first_raytracer_tpu.scene import builders as jb  # noqa: E402
from first_raytracer_tpu_torch.convert import (  # noqa: E402
    camera_from_numpy, params_from_numpy, params_to_numpy, scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng  # noqa: E402
from first_raytracer_tpu_torch.diff import grad as tg  # noqa: E402
from first_raytracer_tpu_torch.kernels import record_mega as trm  # noqa: E402
from first_raytracer_tpu_torch.render import integrator  # noqa: E402


def _port(js, jc, cfg):
    return (scene_from_numpy(js.as_numpy()), camera_from_numpy(jc),
            integrator.RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                                    max_depth=cfg.max_depth,
                                    t_min=cfg.t_min))


def test_fit_step_replay_converges_and_matches_jax():
    import optax

    js, jc, cfg = jb.random_scene(nx=16, ny=8, spp=2)
    key = jrng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    true_params, _ = jg.split_params(js, fields=("albedo",))
    target = jg.ray_radiance(true_params, js, jc, cfg, key, ids)
    bad = dataclasses.replace(js, albedo=js.albedo * 0.6)
    params, _ = jg.split_params(bad, fields=("albedo",))
    opt = optax.adam(0.05)
    jax_step = jg.make_fit_step_replay(bad, jc, cfg, ids, target, opt,
                                       interpret=True)
    state = opt.init(params)
    jax_losses = []
    for _ in range(5):
        loss, params, state = jax_step(params, state, key)
        jax_losses.append(float(loss))

    ts, tc, tcfg = _port(bad, jc, cfg)
    tparams = params_from_numpy({"albedo": np.asarray(bad.albedo)})
    step = tg.make_fit_step_replay(
        ts, tc, tcfg, torch.arange(cfg.num_rays),
        torch.from_numpy(np.asarray(target)),
        torch.optim.Adam(tparams.values(), lr=0.05), device="cpu")
    losses = [float(step(tparams, trng.base_key(0))) for _ in range(5)]
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert losses[-1] < 0.6 * losses[0], losses


def test_fit_step_replay_recorder_branches(monkeypatch):
    """Non-contiguous ids take the wavefront recorder (never K2b); a scene
    past the dense recorder's 1024 spheres takes the clustered recorder
    (K3t's plain version here) with a layout frozen at construction, and
    its steps match JAX's ``make_fit_step_replay`` on the same scene: the
    first loss to ``rtol=1e-5`` and a three-step Adam trajectory to
    ``1e-4``.  The albedo is fitted: with the sphere centres moved too, one
    of the 72 rays re-hits the sphere it leaves, and the two packages'
    replays of that hit land on different roots, 1% of the loss (ROADMAP
    Queue 3); the repack of moved geometry is held to JAX's in
    tests/test_torch_mega_clustered.py.
    """
    js, jc, cfg = jb.three_spheres(nx=8, ny=4, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    ids = torch.arange(tcfg.num_rays).flip(0)
    target = torch.zeros((tcfg.num_rays, 3))
    params, _ = tg.split_params(ts, fields=("albedo",))
    opt = torch.optim.SGD(params.values(), lr=0.1)

    def no_kernel(*args, **kwargs):
        raise AssertionError("a megakernel recorder on non-contiguous ids")

    monkeypatch.setattr(trm, "record_paths_mega", no_kernel)
    monkeypatch.setattr(trm, "record_paths_mega_clustered", no_kernel)
    step = tg.make_fit_step_replay(ts, tc, tcfg, ids, target, opt,
                                   device="cpu")
    before = params["albedo"].detach().clone()
    assert np.isfinite(float(step(params, trng.base_key(0))))
    assert not torch.equal(params["albedo"], before)  # updated in place
    monkeypatch.undo()

    import optax

    fields = ("albedo",)
    big, bc, bcfg = jb.sphere_field(n=1100, nx=12, ny=6, spp=1)
    bcfg = dataclasses.replace(bcfg, max_depth=8)
    key = jrng.base_key(0)
    bids = jnp.arange(bcfg.num_rays, dtype=jnp.int32)
    true_params, _ = jg.split_params(big, fields=fields)
    btarget = jg.ray_radiance(true_params, big, bc, bcfg, key, bids)
    bad = dataclasses.replace(big, albedo=big.albedo * 0.6)
    jparams, _ = jg.split_params(bad, fields=fields)
    jopt = optax.adam(0.02)
    jstep = jg.make_fit_step_replay(bad, bc, bcfg, bids, btarget, jopt,
                                    interpret=True)
    state = jopt.init(jparams)
    jax_losses = []
    for _ in range(3):
        loss, jparams, state = jstep(jparams, state, key)
        jax_losses.append(float(loss))

    tbad, tbc, tbcfg = _port(bad, bc, bcfg)
    tparams = params_from_numpy({k: np.asarray(getattr(bad, k))
                                 for k in fields})
    real, calls = trm.record_paths_mega_clustered, []

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(trm, "record_paths_mega_clustered", counted)
    bstep = tg.make_fit_step_replay(
        tbad, tbc, tbcfg, torch.arange(bcfg.num_rays),
        torch.from_numpy(np.asarray(btarget)),
        torch.optim.Adam(tparams.values(), lr=0.02), device="cpu")
    losses = [float(bstep(tparams, trng.base_key(0))) for _ in range(3)]
    assert len(calls) == 3  # the clustered recorder took every step
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)


def test_fit_steps_and_optimizers():
    """``make_fit_step`` with SGD takes ``sgd_step``'s step; every CLI
    optimizer name builds; the entry points default to the GPU."""
    js, jc, cfg = jb.three_spheres(nx=8, ny=4, spp=2)
    ts, tc, tcfg = _port(js, jc, cfg)
    ids = torch.arange(tcfg.num_rays)
    r = np.random.RandomState(3)
    target = torch.from_numpy(r.rand(tcfg.num_rays, 3).astype(np.float32))
    params, _ = tg.split_params(ts, fields=("albedo", "fuzz"))
    key = trng.base_key(0)
    loss0, want = tg.sgd_step(params, ts, tc, tcfg, key, ids, target,
                              lr=0.3)
    step = tg.make_fit_step(ts, tc, tcfg, ids, target,
                            tg.make_optimizer("sgd", params, 0.3),
                            device="cpu")
    assert float(step(params, key)) == float(loss0)
    for k in params:
        torch.testing.assert_close(params[k].detach(), want[k], rtol=0,
                                   atol=1e-7)
    for name in ("adam", "adamw", "rmsprop"):
        assert isinstance(tg.make_optimizer(name, params, 0.1),
                          torch.optim.Optimizer)
    with pytest.raises(ValueError, match="optimizer"):
        tg.make_optimizer("lion", params, 0.1)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tg.make_fit_step(ts, tc, tcfg, ids, target,
                             tg.make_optimizer("sgd", params, 0.3))


def test_pool_recorder_in_the_loss():
    js, jc, cfg = jb.three_spheres(nx=12, ny=6, spp=2)
    ts, tc, tcfg = _port(js, jc, dataclasses.replace(cfg, max_depth=8))
    ids = torch.arange(tcfg.num_rays)
    target = torch.zeros((tcfg.num_rays, 3))
    params, _ = tg.split_params(ts, fields=("albedo", "sphere_radius"))
    args = (ts, tc, tcfg, trng.base_key(0), ids, target)
    l0, g0 = tg.render_loss_and_grads(params, *args)
    l1, g1 = tg.render_loss_and_grads(params, *args, record_pool=64)
    assert float(l0) == float(l1)
    for k in params:
        assert torch.equal(g0[k], g1[k]), k


def test_params_cross_as_numpy():
    js, _, _ = jb.camera_showcase(nx=4, ny=2, spp=1)
    jparams, _ = jg.split_params(js)
    tparams = params_from_numpy({k: np.asarray(v)
                                 for k, v in jparams.items()})
    assert all(v.requires_grad and v.dtype == torch.float32
               for v in tparams.values())
    back = params_to_numpy(tparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    ts = scene_from_numpy(js.as_numpy())
    merged = tg.merge_params(ts, tparams)
    assert merged.albedo is tparams["albedo"]
    assert tuple(tg.DIFF_FIELDS) == tuple(jg.DIFF_FIELDS)


def test_golden_is_well_formed():
    """The committed JAX golden for chip_smoke.py's gradient step."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert golden["config"]["num_rays"] == GOLDEN_RAYS
    assert golden["loss"] > 0.0
    js, _, cfg = jb.random_scene()
    assert golden["config"]["max_depth"] == cfg.max_depth
    assert set(golden["fields"]) == set(jg.DIFF_FIELDS)
    for k, g in golden["fields"].items():
        values = np.asarray(g["values"], np.float64)
        assert values.size == np.asarray(getattr(js, k)).size, k
        assert np.isfinite(values).all(), k
        np.testing.assert_allclose(values.sum(), g["sum"], rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(np.linalg.norm(values), g["l2"],
                                   rtol=1e-6)
        assert g["values"][:16] == g["first16"], k
    assert golden["fields"]["albedo"]["l2"] > 0.0
    f64 = golden["f64"]
    assert set(f64["fields"]) == set(jg.DIFF_FIELDS)
    assert abs(f64["loss"] / golden["loss"] - 1.0) < 1e-3
    for k, g in f64["fields"].items():
        assert len(g["values"]) == len(golden["fields"][k]["values"]), k
        assert np.isfinite(g["values"]).all(), k
    assert f64["fields"]["albedo"]["f32"]["rel_err"] < 1e-3
    fwd = golden["forward_replay"]
    np.testing.assert_allclose(
        fwd["f64_rel"], abs(fwd["loss"] - f64["loss"]) / f64["loss"],
        rtol=1e-4)
    np.testing.assert_allclose(
        fwd["spread"], abs(fwd["loss"] - golden["loss"]) / golden["loss"],
        rtol=1e-4)
    with np.load(GOLDEN_TAPE) as saved:
        tape = saved["tape"]
    assert tape.shape == (cfg.max_depth + 1, GOLDEN_RAYS)
    assert tape.min() == -1 and tape.max() < js.num_primitives
    np.testing.assert_array_equal((tape >= 0).sum(axis=1),
                                  golden["tape"]["hits_per_row"])


def _f32(x):
    return float(f"{float(x):.9g}")


def _spread(a, b):
    """Cosine, norm ratio and relative L2 error of gradient ``b`` against
    ``a``."""
    a, b = a.astype(np.float64).ravel(), b.astype(np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0.0:
        return dict(cosine=None, norm_ratio=None, rel_err=None,
                    other_norm=_f32(nb))
    return dict(cosine=_f32(a @ b / (na * nb)), norm_ratio=_f32(nb / na),
                rel_err=_f32(np.linalg.norm(b - a) / na))


class _Float32As64:
    """``jax.numpy`` with ``float32`` read as ``float64``: JAX's replay
    (``diff/replay.py``) makes its throughput and radiance carries float32,
    which a float64 scan would otherwise refuse."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_f64_loss_and_grads(scene, cam, cfg, key, ids, tape):
    """JAX's bucketed loss and gradients on ``tape`` with the scene, the
    camera and the replay in float64 (the uniforms stay float32, as in the
    port)."""
    def up(x):
        return (x.astype(jnp.float64)
                if jnp.issubdtype(x.dtype, jnp.floating) else x)

    saved, jrp.jnp = jrp.jnp, _Float32As64()
    try:
        with jax.enable_x64(True):
            scene64 = jax.tree_util.tree_map(up, scene)
            params, _ = jg.split_params(scene64)
            loss, grads = jg.render_loss_and_grads_bucketed(
                params, scene64, jax.tree_util.tree_map(up, cam), cfg, key,
                ids, jnp.zeros((ids.shape[0], 3), jnp.float64),
                jnp.asarray(tape))
            return float(loss), {k: np.asarray(v, np.float64)
                                 for k, v in grads.items()}
    finally:
        jrp.jnp = saved


def _f64(obj):
    """A copy of a port scene or camera with its float tensors in float64."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double()
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).is_floating_point()})


GRAD_CHECK_RAYS = 4096


@functools.lru_cache(maxsize=None)
def _golden_case():
    """JAX's tape of the final scene's first ``GRAD_CHECK_RAYS`` ray ids
    (the golden's), and JAX's float64 loss and gradients on it."""
    with np.load(GOLDEN_TAPE) as saved:
        tape = saved["tape"][:, :GRAD_CHECK_RAYS].astype(np.int32)
    js, jc, cfg = jb.random_scene()
    loss64, grads64 = _jax_f64_loss_and_grads(
        js, jc, cfg, jrng.base_key(0),
        jnp.arange(GRAD_CHECK_RAYS, dtype=jnp.int32), tape)
    return tape, loss64, grads64


def test_float32_loss_matches_jax_float32():
    """The float32 loss of the final scene on JAX's tape of its first 4096
    ray ids: the port's bucketed replay against JAX's, both on the CPU.
    Bounds: ``rtol=1e-5`` against JAX's float32 loss (measured 4.9e-6),
    and no farther from JAX's float64 loss than twice JAX's own float32
    distance (measured 1.1e-6 against 3.9e-6).  At 2^17 rays the port's
    loss is 3.4e-4 from float64 and the golden's JAX loss 1.7e-5, but JAX's
    forward replay (``trace_rays_replay``) of the same tape is 3.5e-4 from
    it too: a few chaotic rays carry the difference, and XLA rounds them
    by the program it compiles (PERF.md)."""
    rays = GRAD_CHECK_RAYS
    tape, loss64, _ = _golden_case()
    js, jc, cfg = jb.random_scene()
    jparams, _ = jg.split_params(js, fields=("albedo",))
    jloss, _ = jg.render_loss_and_grads_bucketed(
        jparams, js, jc, cfg, jrng.base_key(0),
        jnp.arange(rays, dtype=jnp.int32), jnp.zeros((rays, 3), jnp.float32),
        jnp.asarray(tape))
    ts, tc, tcfg = _port(js, jc, cfg)
    params, _ = tg.split_params(ts, fields=("albedo",))
    loss, _ = tg.render_loss_and_grads_bucketed(
        params, ts, tc, tcfg, trng.base_key(0), torch.arange(rays),
        torch.zeros((rays, 3)), torch.from_numpy(tape))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert abs(float(loss) - loss64) <= 2 * abs(float(jloss) - loss64)


def test_float32_loss_within_jax_forward_replay_spread():
    """The repaired bound of the card's float32 loss (chip_smoke.py phase
    6), at 4096 rays on the CPU: the port's bucketed replay on JAX's tape
    against JAX's forward replay (``trace_rays_replay``) of the same tape,
    the JAX program that computes the same float32 values, within the
    spread between JAX's two float32 programs that the golden records at
    2^17 rays (forward replay against the gradient program: 3.7e-4).
    Measured: 4.9e-6 here, 8.6e-6 at 2^17 rays."""
    rays = GRAD_CHECK_RAYS
    with open(GOLDEN) as f:
        spread = json.load(f)["forward_replay"]["spread"]
    tape, _, _ = _golden_case()
    js, jc, cfg = jb.random_scene()
    want = _jax_forward_loss(js, jc, cfg, jrng.base_key(0),
                             jnp.arange(rays, dtype=jnp.int32), tape)
    ts, tc, tcfg = _port(js, jc, cfg)
    params, _ = tg.split_params(ts, fields=("albedo",))
    loss, _ = tg.render_loss_and_grads_bucketed(
        params, ts, tc, tcfg, trng.base_key(0), torch.arange(rays),
        torch.zeros((rays, 3)), torch.from_numpy(tape))
    assert 1e-4 < spread < 1e-3
    assert abs(float(loss) - want) / want <= spread


def test_rehit_case_parts_on_one_grazing_entry():
    """The case of ``test_fit_step_replay_recorder_branches`` with the
    sphere centres moved too lies inside the JAX package's own spread
    (ROADMAP, "Deviations inside the reference"): on sphere_field(1100) at
    12x6 @ 1, depth 8, with the centres moved by 0.01, JAX's clustered
    recorder and JAX's wavefront ``record_paths`` part on rays 12, 56 and
    57 (ray 57's fourth segment: sphere 240 in the clustered recorder, the
    ground sphere in the wavefront one).  The port's recorder (K3t's plain
    version, its sphere root in float64) records every ray as the port's
    wavefront ``record_paths`` does on the scene in float64, and parts from
    JAX's clustered recorder only on rays where that float64 recorder does
    too: 57, and 55, whose bounce off sphere 6 grazes sphere 5, which both
    JAX recorders in float32 miss."""
    from first_raytracer_tpu.kernels.megakernel_clustered import (
        pack_scene_mega_clustered as jax_pack)
    from first_raytracer_tpu.kernels.record_mega import (
        record_paths_mega_clustered as jax_record)
    from first_raytracer_tpu_torch.diff.replay import record_paths
    from first_raytracer_tpu_torch.kernels import megakernel_clustered as tmc
    from first_raytracer_tpu_torch.render.camera import generate_rays

    big, bc, bcfg = jb.sphere_field(n=1100, nx=12, ny=6, spp=1)
    bcfg = dataclasses.replace(bcfg, max_depth=8)
    moved = dataclasses.replace(big, albedo=big.albedo * 0.6,
                                sphere_center=big.sphere_center + 0.01)
    key = jrng.base_key(0)
    want = np.asarray(jax_record(
        jax_pack(moved, sort_from=bc.origin), bc, bcfg, key, ray0=0,
        num_rays=bcfg.num_rays, interpret=True))
    ids = jnp.arange(bcfg.num_rays, dtype=jnp.int32)
    o, d = jcam.generate_rays(bc, bcfg.nx, bcfg.ny, bcfg.spp, ids,
                              jrng.camera_uniforms(key, ids))
    wave = np.asarray(jrp.record_paths(moved, o, d, ids, key, bcfg))
    ts, tc, tcfg = _port(moved, bc, bcfg)
    tkey = trng.base_key(0)
    got = trm.record_paths_mega_clustered(
        tmc.pack_scene_mega_clustered(ts, tc), tc, tcfg, tkey).numpy()
    tids = torch.arange(tcfg.num_rays)
    to, td = generate_rays(tc, tcfg.nx, tcfg.ny, tcfg.spp, tids,
                           trng.camera_uniforms(tkey, tids))
    f64 = dataclasses.replace(ts, **{
        f.name: getattr(ts, f.name).double()
        for f in dataclasses.fields(ts)
        if getattr(ts, f.name).is_floating_point()})
    exact = record_paths(f64, to.double(), td.double(), tids, tkey,
                         tcfg).numpy()
    jax_spread = np.nonzero((want != wave).any(axis=0))[0].tolist()
    assert jax_spread == [12, 56, 57]
    assert want[:5, 57].tolist() == [206, 0, 206, 240, 0]
    assert wave[:5, 57].tolist() == [206, 0, 206, 0, -1]
    np.testing.assert_array_equal(got, exact)
    parts = np.nonzero((got != want).any(axis=0))[0].tolist()
    assert parts == [55, 57], parts
    assert want[:2, 55].tolist() == wave[:2, 55].tolist() == [6, -1]
    assert got[:3, 55].tolist() == [6, 5, -1]


def test_float64_replay_matches_jax_float64():
    """On JAX's tape of the final scene's first 4096 rays, both replays in
    float64.  Bounds: the loss and the albedo gradient ``rtol=1e-7``
    (measured 1e-9); the geometry, fuzz and index gradients a relative L2
    error of 1e-3 (measured up to 8.5e-5: the uniforms stay float32 and go
    through each library's own sine and cosine, and a near-tangent ray
    magnifies that last-bit difference); zero gradients zero."""
    rays = GRAD_CHECK_RAYS
    tape, want_loss, want = _golden_case()
    js, jc, cfg = jb.random_scene()
    ts, tc, tcfg = _port(js, jc, cfg)
    ts, tc = _f64(ts), _f64(tc)
    params, _ = tg.split_params(ts)
    loss, grads = tg.render_loss_and_grads_bucketed(
        params, ts, tc, tcfg, trng.base_key(0), torch.arange(rays),
        torch.zeros((rays, 3), dtype=torch.float64), torch.from_numpy(tape))
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-7)
    for k, w in want.items():
        g = grads[k].detach().numpy()
        if not w.any():
            assert not g.any(), k
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err < (1e-7 if k == "albedo" else 1e-3), (k, err)


def _jax_forward_loss(scene, cam, cfg, key, ids, tape, chunk=1 << 14):
    """JAX's forward replay (``trace_rays_replay``) of ``tape`` in
    float32, in chunks of rays: the mean squared radiance, zero target."""
    rad = []
    for lo in range(0, ids.shape[0], chunk):
        c = ids[lo:lo + chunk]
        o, d = jcam.generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, c,
                                  jrng.camera_uniforms(key, c))
        rad.append(jrp.trace_rays_replay(
            scene, o, d, c, key, cfg, jnp.asarray(tape[:, lo:lo + chunk])))
    return float(jnp.mean(jnp.concatenate(rad) ** 2))


def write_golden(chunk=1 << 14):
    """The JAX package's loss and gradients at chip_smoke.py's gradient
    configuration, on the CPU, in float32 and in float64, as JSON; and its
    tape."""
    jax.config.update("jax_platforms", "cpu")
    scene, cam, cfg = jb.random_scene()
    key = jrng.base_key(0)
    ids = jnp.arange(GOLDEN_RAYS, dtype=jnp.int32)
    # Recorded in chunks of rays (each ray's entries depend on that ray
    # alone), which bounds the dense sweep's memory.
    pieces = []
    for lo in range(0, GOLDEN_RAYS, chunk):
        c = ids[lo:lo + chunk]
        o, d = jcam.generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, c,
                                  jrng.camera_uniforms(key, c))
        pieces.append(np.asarray(jrp.record_paths(scene, o, d, c, key, cfg)))
    tape = np.concatenate(pieces, axis=1)
    params, _ = jg.split_params(scene)
    target = jnp.zeros((GOLDEN_RAYS, 3), jnp.float32)
    loss, grads = jg.render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, ids, target, jnp.asarray(tape))
    fields = {}
    for k in jg.DIFF_FIELDS:
        g = np.asarray(grads[k], np.float32).ravel()
        fields[k] = dict(shape=list(np.asarray(grads[k]).shape),
                         sum=_f32(g.sum(dtype=np.float64)),
                         l2=_f32(np.linalg.norm(g.astype(np.float64))),
                         first16=[_f32(v) for v in g[:16]],
                         values=[_f32(v) for v in g])
    golden = dict(
        generator="python tests/test_torch_grad.py --write-golden",
        config=dict(scene="scene.builders.random_scene() (scene seed 7)",
                    nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                    max_depth=cfg.max_depth, t_min=cfg.t_min, seed=0,
                    ray0=0, num_rays=GOLDEN_RAYS, target="zeros",
                    loss="mean squared radiance",
                    recorder="first_raytracer_tpu.diff.replay.record_paths",
                    replay="first_raytracer_tpu.diff.grad."
                           "render_loss_and_grads_bucketed (max_groups 4)",
                    backend=f"jax {jax.__version__} on the CPU"),
        tape=dict(hits_per_row=[int(n) for n in (tape >= 0).sum(axis=1)]),
        loss=_f32(loss), fields=fields)
    loss64, grads64 = _jax_f64_loss_and_grads(scene, cam, cfg, key, ids,
                                              tape)
    golden["f64"] = dict(
        by="the same replay with jax_enable_x64, the scene, camera and "
           "carries in float64 (the uniforms float32)",
        loss=loss64,
        f32_loss_rel=_f32(abs(float(loss) - loss64) / loss64),
        fields={k: dict(values=g.ravel().tolist(),
                        f32=_spread(g, np.asarray(grads[k])))
                for k, g in grads64.items()})
    forward = _jax_forward_loss(scene, cam, cfg, key, ids, tape, chunk)
    golden["forward_replay"] = dict(
        by="first_raytracer_tpu.diff.replay.trace_rays_replay of the same "
           "tape in float32, mean squared radiance: the forward program, "
           "whose float32 loss the port's replay computes",
        loss=_f32(forward),
        f64_rel=_f32(abs(forward - loss64) / loss64),
        spread=_f32(abs(forward - float(loss)) / float(loss)))
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    np.savez_compressed(GOLDEN_TAPE, tape=tape.astype(np.int16))
    return golden


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-golden"]:
        sys.exit("usage: python tests/test_torch_grad.py --write-golden")
    g = write_golden()
    print(f"wrote {GOLDEN} and {GOLDEN_TAPE}: loss {g['loss']}")
    print(json.dumps({k: v["f32"] for k, v in g["f64"]["fields"].items()},
                     indent=1))


@pytest.mark.parametrize("kind", ["dense", "clustered", "bvh"])
def test_gradients_and_fit_step_with_an_accel(kind):
    """``render_loss_and_grads`` and ``make_fit_step`` with an accel
    against JAX's with the same accel (its Pallas intersectors in interpret
    mode), random-spheres 16x8 @ 2, albedo: the loss ``rtol=1e-5`` and the
    gradient ``rtol=1e-4, atol=1e-6`` (the tape-swap bound of
    tests/test_record_mega.py:109-112), a three-step SGD trajectory by loss
    ``rtol=1e-4``; and the port's with and without the accel equal."""
    import functools

    from first_raytracer_tpu.accel.build import build_bvh as jax_bvh
    from first_raytracer_tpu.kernels import intersect_clustered as jic
    from first_raytracer_tpu.kernels import intersect_pallas as jip
    from first_raytracer_tpu_torch.accel.build import build_bvh
    from first_raytracer_tpu_torch.kernels import intersect_clustered as tic
    from first_raytracer_tpu_torch.kernels import intersect_pallas as tip

    js, jc, cfg = jb.random_scene(nx=16, ny=8, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=8)
    key = jrng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    ts, tc, tcfg = _port(js, jc, cfg)
    if kind == "bvh":
        jacc, jfn, tacc = jax_bvh(js, backend="numpy"), None, build_bvh(ts)
    elif kind == "dense":
        jacc, tacc = jip.pack_scene_pallas(js), tip.pack_scene_pallas(ts)
        jfn = functools.partial(jip.intersect_pallas, interpret=True)
    else:
        jacc, tacc = jic.pack_scene_clustered(js), tic.pack_scene_clustered(ts)
        jfn = functools.partial(jic.intersect_clustered, interpret=True)
    true_params, _ = jg.split_params(js, fields=("albedo",))
    target = jg.ray_radiance(true_params, js, jc, cfg, key, ids, jacc, jfn)
    bad = {"albedo": js.albedo * 0.6}
    jloss, jgrads = jg.render_loss_and_grads(bad, js, jc, cfg, key, ids,
                                             target, jacc, jfn)
    tids, tkey = torch.arange(cfg.num_rays), trng.base_key(0)
    ttarget = torch.from_numpy(np.array(target))
    params = params_from_numpy({"albedo": np.asarray(bad["albedo"])})
    loss, grads = tg.render_loss_and_grads(params, ts, tc, tcfg, tkey, tids,
                                           ttarget, tacc)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(grads["albedo"].numpy(),
                               np.asarray(jgrads["albedo"]), rtol=1e-4,
                               atol=1e-6)
    plain_loss, plain_grads = tg.render_loss_and_grads(
        params, ts, tc, tcfg, tkey, tids, ttarget)
    assert float(plain_loss) == float(loss)
    torch.testing.assert_close(plain_grads["albedo"], grads["albedo"])

    import optax
    opt = optax.sgd(0.5)
    jstep = jg.make_fit_step(js, jc, cfg, ids, target, opt, accel=jacc,
                             intersect_fn=jfn)
    jp, state, jlosses = dict(bad), opt.init(bad), []
    for _ in range(3):
        jl, jp, state = jstep(jp, state, key)
        jlosses.append(float(jl))
    step = tg.make_fit_step(ts, tc, tcfg, tids, ttarget,
                            torch.optim.SGD(params.values(), lr=0.5),
                            accel=tacc, device="cpu")
    losses = [float(step(params, tkey)) for _ in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[-1] < losses[0]
