"""The replay's value and gradient as data-driven work that a CUDA graph can
capture, on the CPU.

- Threefry with the key read as data: ``tests/test_torch_rng.py`` holds
  it bit-equal to the JAX package's ``core.rng`` for base keys and raw
  words, with a scalar and a per-ray depth.
- After one warm call, a second call of ``trace_rays_replay`` and of
  ``render_loss_and_grads_bucketed`` makes no tensor from host data
  (``torch.tensor`` / ``torch.as_tensor`` of a non-tensor) and reads
  nothing back (``.tolist()``, ``.item()``, ``.cpu()``, ``.numpy()``,
  ``bool``/``int``/``float`` of a tensor): counted by monkeypatching, the
  CPU's stand-in for capturability.
- ``GraphCache``'s static buffers, run eagerly on the CPU over other keys,
  parameters, targets, scene leaves, cameras and plans of one signature in
  turn, equal the plain eager function on each, bit for bit: a stale
  buffer would show.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import pytest
import torch

from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.diff import grad as tg
from first_raytracer_tpu_torch.diff import replay as trp
from first_raytracer_tpu_torch.diff.graphed import GraphCache
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.scene.builders import build_preset


def _case(preset="random-spheres", nx=16, ny=8, spp=2, max_depth=6):
    scene, cam, cfg = build_preset(preset, nx=nx, ny=ny, spp=spp)
    cfg = dataclasses.replace(cfg, max_depth=max_depth)
    ids = torch.arange(cfg.num_rays)
    key = trng.base_key(3)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         trng.camera_uniforms(key, ids))
    tape = trp.record_paths(scene, o, d, ids, key, cfg)
    return scene, cam, cfg, ids, key, tape


class _HostTraffic:
    """Counts the calls that make a tensor from host data or read one back
    to the host, while it is installed."""

    READS = ("tolist", "item", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("tensor", "as_tensor", "from_numpy"):
            self._wrap(monkeypatch, torch, name, host_data_only=True)
        for name in self.READS:
            self._wrap(monkeypatch, torch.Tensor, name)

    def _wrap(self, monkeypatch, owner, name, host_data_only=False):
        fn = getattr(owner, name)
        calls = self.calls

        def counted(*args, **kwargs):
            if not (host_data_only and args
                    and isinstance(args[0], torch.Tensor)):
                calls.append(name)
            return fn(*args, **kwargs)

        monkeypatch.setattr(owner, name, counted)


@pytest.mark.parametrize("preset", ["random-spheres", "triangle-mesh"])
def test_no_host_traffic_after_a_warm_call(monkeypatch, preset):
    scene, cam, cfg, ids, key, tape = _case(preset)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         trng.camera_uniforms(key, ids))
    params, _ = tg.split_params(scene)
    target = torch.rand((cfg.num_rays, 3),
                        generator=torch.Generator().manual_seed(0))
    plan = trp.plan_buckets(tape)

    def replay():
        return trp.trace_rays_replay(scene, o, d, ids, key, cfg, tape)

    def bucketed():
        return tg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, tape, plan=plan)

    want_rad, (want_loss, want_grads) = replay(), bucketed()
    traffic = _HostTraffic(monkeypatch)
    rad = replay()
    loss, grads = bucketed()
    monkeypatch.undo()
    assert traffic.calls == []
    assert torch.equal(rad, want_rad) and torch.equal(loss, want_loss)
    assert all(torch.equal(grads[k], want_grads[k]) for k in want_grads)


def _changed(scene, cam, params, seed):
    """Other values of one signature: params, scene leaves the loss reads
    beyond the params, and the camera."""
    g = torch.Generator().manual_seed(seed)
    new_params = {k: (v.detach() * (1 + 0.05 * torch.rand(v.shape,
                                                          generator=g)))
                  .requires_grad_(True) for k, v in params.items()}
    scene = dataclasses.replace(
        scene, tex_scale=scene.tex_scale * (1.5 + seed))
    cam = dataclasses.replace(cam, origin=cam.origin + 0.01 * seed)
    return scene, cam, new_params


def test_static_buffers_equal_the_eager_function_on_each_call():
    scene, cam, cfg, ids, key0, tape = _case(max_depth=8)
    params0, _ = tg.split_params(scene)
    order, groups = trp.plan_buckets(tape)
    # The same groups with the deepest ray swapped into the shallowest
    # group, which cuts its path short: a stale order would show.
    assert len(groups) > 1
    order_b = order.clone()
    order_b[0], order_b[-1] = order[-1], order[0]
    cache = GraphCache()
    calls = [
        (scene, cam, params0, key0, torch.zeros((len(ids), 3)), order),
        (*_changed(scene, cam, params0, 1), trng.base_key(11),
         torch.full((len(ids), 3), 0.25), order),
        (*_changed(scene, cam, params0, 2), key0,
         torch.linspace(0, 1, 3 * len(ids)).reshape(-1, 3), order_b),
        (scene, cam, params0, trng.base_key(11),
         torch.zeros((len(ids), 3)), order),
    ]
    for s, c, p, key, target, o in calls:
        want = tg.bucketed_loss_and_grads(
            p, s, c, key, ids, target, tape, o, cfg=cfg, groups=groups,
            num_values=target.numel())
        got = cache.run(
            tg.bucketed_loss_and_grads,
            dict(cfg=cfg, groups=groups, num_values=target.numel()),
            dict(params=p, scene=s, camera=c, key=key, ray_ids=ids,
                 target=target, tape=tape, order=o),
            torch.device("cpu"))
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
        want_t = tg.tape_loss_and_grads(p, s, c, key, ids, target, tape,
                                        cfg=cfg)
        got_t = cache.run(
            tg.tape_loss_and_grads, dict(cfg=cfg),
            dict(params=p, scene=s, camera=c, key=key, ray_ids=ids,
                 target=target, tape=tape), torch.device("cpu"))
        assert torch.equal(got_t[0], want_t[0])
        assert all(torch.equal(got_t[1][k], want_t[1][k]) for k in want_t[1])
    # One entry per body; nothing captured or replayed off the card.
    assert len(cache.entries) == 2
    assert cache.captures == cache.replays == 0


def test_signatures_bound_the_cache():
    scene, cam, cfg, ids, key, tape = _case(max_depth=4)
    params, _ = tg.split_params(scene, fields=("albedo",))
    cache = GraphCache(maxsize=2)
    target = torch.zeros((len(ids), 3))
    for trips in (2, 3, 4, 2):
        cache.run(tg.tape_loss_and_grads, dict(cfg=cfg),
                  dict(params=params, scene=scene, camera=cam, key=key,
                       ray_ids=ids, target=target, tape=tape[:trips]),
                  torch.device("cpu"))
    # Three tape shapes, the two most recent kept (the last call, trips 2,
    # made its entry anew after trips 2's first was dropped).
    kept = [dict(sig[3][1])["tape"][1] for sig in cache.entries]
    assert kept == [(4, len(ids)), (2, len(ids))]
