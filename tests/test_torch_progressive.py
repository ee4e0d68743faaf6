"""The port's progressive render (checkpoint and resume) against its
one-shot render and the JAX package's progressive render.

Progressive accumulation equals the one-shot render (``atol=1e-6``,
tests/test_progressive.py:17), a killed and resumed render is bit-equal to
an uninterrupted one, a checkpoint of another seed is refused, and
``mode="mega"`` (K1's plain version on the CPU, with its sample offset)
matches the wavefront batches within the image bound
``(|a - b| > 1e-3).mean() < 0.01``, median below 1e-5.  Against JAX's
progressive render: the same image bound.
"""
import os

import numpy as np
import pytest

from first_raytracer_tpu.render.progressive import (
    progressive_render as jax_progressive)
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.accel.build import build_bvh
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.render.api import render_image
from first_raytracer_tpu_torch.render.integrator import RenderConfig
from first_raytracer_tpu_torch.render.progressive import (ProgressiveState,
                                                          progressive_render)


class Stop(Exception):
    pass


def _port(js, jc, cfg):
    return (scene_from_numpy(js.as_numpy()), camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


@pytest.fixture(scope="module")
def tiny():
    js, jc, cfg = jb.three_spheres(nx=24, ny=12, spp=2)
    return (js, jc, cfg) + _port(js, jc, cfg)


def _assert_images_close(got, want):
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert (diff > 1e-3).mean() < 0.01 and np.median(diff) < 1e-5


def _kill_after(n, path):
    def on_batch(state):
        if state.samples_done == n:
            state.save(path)
            raise Stop
    return on_batch


@pytest.mark.parametrize("batch", [1, 2])
def test_progressive_matches_oneshot(tiny, batch):
    *_, ts, tc, tcfg = tiny
    a = render_image(ts, tc, tcfg, seed=0, device="cpu").numpy()
    b = progressive_render(ts, tc, tcfg, seed=0, samples_per_batch=batch,
                           device="cpu")
    assert b.shape == a.shape and b.dtype == np.float32
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_progressive_with_an_accel(tiny):
    *_, ts, tc, tcfg = tiny
    a = progressive_render(ts, tc, tcfg, seed=0, device="cpu")
    b = progressive_render(ts, tc, tcfg, seed=0, accel=build_bvh(ts),
                           device="cpu")
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_resume_after_kill(tmp_path, tiny):
    *_, ts, tc, tcfg = tiny
    ckpt = str(tmp_path / "render.ckpt.npz")
    with pytest.raises(Stop):
        progressive_render(ts, tc, tcfg, seed=0, checkpoint_path=ckpt,
                           on_batch=_kill_after(1, ckpt), device="cpu")
    assert ProgressiveState.load(ckpt).samples_done == 1
    resumed = progressive_render(ts, tc, tcfg, seed=0, checkpoint_path=ckpt,
                                 device="cpu")
    full = progressive_render(ts, tc, tcfg, seed=0, device="cpu")
    np.testing.assert_array_equal(resumed, full)
    # The finished render is checkpointed, atomically: no temporary left.
    assert ProgressiveState.load(ckpt).samples_done == tcfg.spp
    assert os.listdir(tmp_path) == ["render.ckpt.npz"]


def test_checkpoint_rejects_wrong_seed_and_other_formats(tmp_path, tiny):
    *_, ts, tc, tcfg = tiny
    ckpt = str(tmp_path / "s.ckpt.npz")
    ProgressiveState.fresh(tcfg, seed=3).save(ckpt)
    with pytest.raises(ValueError, match="seed"):
        progressive_render(ts, tc, tcfg, seed=4, checkpoint_path=ckpt,
                           device="cpu")
    with pytest.raises(ValueError, match="npz"):
        progressive_render(ts, tc, tcfg, checkpoint_path=str(
            tmp_path / "ckpt_orbax"), device="cpu")
    with pytest.raises(ValueError, match="npz"):
        ProgressiveState.fresh(tcfg, seed=0).save(str(tmp_path / "x.ckpt"))


def test_progressive_megakernel_matches_wavefront(tmp_path):
    """``mode="mega"`` batches of two samples, killed after the first and
    resumed, against the wavefront progressive render (the JAX package's
    own test, tests/test_progressive.py:69-111)."""
    js, jc, cfg = jb.three_spheres(nx=16, ny=8, spp=4)
    ts, tc, tcfg = _port(js, jc, cfg)
    ref = progressive_render(ts, tc, tcfg, seed=0, samples_per_batch=2,
                             device="cpu")
    ck = str(tmp_path / "mega.npz")
    with pytest.raises(Stop):
        progressive_render(ts, tc, tcfg, seed=0, samples_per_batch=2,
                           mode="mega", checkpoint_path=ck,
                           on_batch=_kill_after(2, ck), device="cpu")
    img = progressive_render(ts, tc, tcfg, seed=0, samples_per_batch=2,
                             mode="mega", checkpoint_path=ck, device="cpu")
    _assert_images_close(img, ref)
    with pytest.raises(ValueError):
        progressive_render(ts, tc, tcfg, mode="ring", device="cpu")


def test_progressive_matches_jax(tiny):
    js, jc, cfg, ts, tc, tcfg = tiny
    want = np.asarray(jax_progressive(js, jc, cfg, seed=5,
                                      samples_per_batch=1))
    got = progressive_render(ts, tc, tcfg, seed=5, samples_per_batch=1,
                             device="cpu")
    _assert_images_close(got, want)
