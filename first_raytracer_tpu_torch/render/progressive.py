"""Progressive rendering with checkpoint and resume.

Port of ``first_raytracer_tpu.render.progressive``.  The resumable state is
small and explicit: per-pixel radiance sums (float64), the samples per
pixel done, and the seed.  The counter RNG makes sample ``s`` of pixel
``p`` reproducible on its own, so resuming is continuing the sample loop,
and the finished image equals a one-shot render with the same seed.

Checkpoints are ``.npz`` files, written to a temporary name and renamed
into place (a preempted save never corrupts the last one).  The JAX
package also writes orbax directories for any other path; orbax is not a
dependency of the port, so such a path raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..core import rng
from .api import render_ray_batch
from .integrator import RenderConfig

__all__ = ["ProgressiveState", "progressive_render"]


def _npz_only(path):
    if not str(path).endswith(".npz"):
        raise ValueError(f"checkpoint {path!r}: only .npz checkpoints are "
                         "supported (the JAX package's orbax format is not "
                         "ported)")


@dataclasses.dataclass
class ProgressiveState:
    """Resumable accumulator."""

    radiance_sum: np.ndarray  # (npix, 3) f64 accumulation
    samples_done: int         # samples per pixel completed
    seed: int

    def image(self, cfg: RenderConfig):
        """(ny, nx, 3) f32 mean so far, top row first (NumPy)."""
        img = (self.radiance_sum / max(self.samples_done, 1)).astype(
            np.float32)
        return img.reshape(cfg.ny, cfg.nx, 3)[::-1]

    def save(self, path):
        _npz_only(path)
        tmp = f"{path}.tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, radiance_sum=self.radiance_sum,
                     samples_done=self.samples_done, seed=self.seed)
        os.replace(tmp, path)  # atomic: a preempted save never corrupts

    @classmethod
    def load(cls, path):
        _npz_only(path)
        with np.load(path) as z:
            return cls(radiance_sum=z["radiance_sum"],
                       samples_done=int(z["samples_done"]),
                       seed=int(z["seed"]))

    @classmethod
    def fresh(cls, cfg: RenderConfig, seed: int):
        return cls(radiance_sum=np.zeros((cfg.num_pixels, 3), np.float64),
                   samples_done=0, seed=seed)


def progressive_render(scene, camera, cfg: RenderConfig, seed: int = 0,
                       accel=None, checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 4,
                       samples_per_batch: int = 1,
                       on_batch: Optional[Callable] = None,
                       mode: str = "wavefront", device="cuda"):
    """Render ``cfg.spp`` samples in resumable batches of
    ``samples_per_batch`` samples per pixel.

    Returns the final (ny, nx, 3) image (NumPy).  If ``checkpoint_path``
    exists the render resumes from it (its seed must be ``seed``); a
    checkpoint is written every ``checkpoint_every`` batches and at the
    end.  ``on_batch(state)`` runs after every batch.  ``mode``:
    ``"wavefront"`` (``render_ray_batch`` on ``accel``) or ``"mega"`` (the
    megakernel K1 with its sample offset).  The scene, camera and accel
    are moved to ``device``.
    """
    if mode not in ("wavefront", "mega"):
        raise ValueError(f"unknown mode {mode!r}")
    if checkpoint_path:
        _npz_only(checkpoint_path)
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = ProgressiveState.load(checkpoint_path)
        if state.seed != seed:
            raise ValueError(
                f"checkpoint seed {state.seed} != requested {seed}")
    else:
        state = ProgressiveState.fresh(cfg, seed)

    device = torch.device(device)
    scene, camera = scene.to(device), camera.to(device)
    if accel is not None:
        accel = accel.to(device)
    key = rng.base_key(seed)
    npix = cfg.num_pixels
    batches_done = 0
    if mode == "mega":
        from ..kernels.megakernel import pack_scene_mega, render_pixels_mega
        pack = pack_scene_mega(scene, device)
    while state.samples_done < cfg.spp:
        n_s = min(samples_per_batch, cfg.spp - state.samples_done)
        if mode == "mega":
            rad_sum, _ = render_pixels_mega(
                pack, camera, dataclasses.replace(cfg, spp=n_s), key,
                spp0=state.samples_done, spp_total=cfg.spp)
            state.radiance_sum += rad_sum.cpu().numpy().astype(np.float64)
        else:
            # Global ray ids of samples [done, done + n_s) of every pixel.
            pix = torch.arange(npix, dtype=torch.int64, device=device)
            smp = torch.arange(state.samples_done, state.samples_done + n_s,
                               dtype=torch.int64, device=device)
            ids = (pix[:, None] * cfg.spp + smp[None, :]).reshape(-1)
            rad = render_ray_batch(scene, camera, cfg, key, ids, accel)
            state.radiance_sum += rad.cpu().numpy().reshape(
                npix, n_s, 3).sum(axis=1)
        state.samples_done += n_s
        batches_done += 1
        if on_batch is not None:
            on_batch(state)
        if checkpoint_path and (batches_done % checkpoint_every == 0
                                or state.samples_done >= cfg.spp):
            state.save(checkpoint_path)
    return state.image(cfg)
