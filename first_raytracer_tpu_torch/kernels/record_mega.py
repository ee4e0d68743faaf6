"""Tape recorders of the differentiable pass: K2 and its standalone variant
K2b.

Port of ``first_raytracer_tpu.kernels.record_mega`` (dense recorders).  The
record->replay pass (``diff/replay.py``) records, outside the autograd
graph, which primitive each ray hit at each bounce: a ``(max_depth + 1, R)``
int32 tape, -1 for a miss or a dead path, else the original scene id
(spheres ``0..Ns-1``, triangles ``Ns + j``).  ``record_paths_mega`` produces
that tape for a contiguous range of ray ids ``[ray0, ray0 + R)``:

- ``impl="mega"`` (default): K2, the megakernel with its tape on
  (``kernels/megakernel.render_pixels_mega(emit_tape=True)``), over the
  pixels that hold the range, then the range's columns;
- ``impl="legacy"`` or ``return_iters=True``: K2b, the standalone recorder
  (``record_kernel`` in ``csrc/megakernel.cu``, built into K1's library),
  one thread per ray id, no radiance, which also returns each ray's
  bounce-loop trip count.

Both kernels trace through the same device routine as K1, so their tapes
agree with each other and with the render.  On the CPU each runs its plain
version; a tensor on any other device is refused; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..core import rng
from .megakernel import (MegaScenePack, camera_table, check_guards,
                         check_pack, default_rays_per_chunk,
                         load_mega_library, pack_scene_mega,
                         render_pixels_mega, trace_reference)

__all__ = ["record_paths_mega", "record_paths_mega_reference",
           "pack_scene_mega", "MegaScenePack"]

REPLACES = "first_raytracer_tpu/kernels/record_mega.py:62"
# Ray ids stay below 2^24, the JAX recorder's f32-exact decode bound, so
# both packages accept the same inputs.
MAX_RAY_ID = 1 << 24


def _launch_record(pack, cam, cfg, key, ray0, num_rays, spp_total):
    """Launch K2b on the current stream; returns (tape (D, R), its (R,))."""
    dev = pack.device
    check_pack(pack, cam)
    lib, _ = load_mega_library()
    # K2b writes every entry of both outputs: no fill needed.
    tape = torch.empty((cfg.max_depth + 1, num_rays), dtype=torch.int32,
                       device=dev)
    its = torch.empty((num_rays,), dtype=torch.int32, device=dev)
    groups = (ctypes.c_int * 14)(*pack.sph_groups, *pack.tri_groups)
    k0, k1 = rng.key_words(key)
    with torch.cuda.device(dev):  # the launch goes to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.frt_record_paths(
            cam.data_ptr(), pack.spheres.data_ptr(), pack.sph_mx.data_ptr(),
            pack.tris.data_ptr(), pack.sphere_rows, pack.tri_rows,
            pack.spheres.shape[1], pack.tris.shape[1], groups, k0, k1,
            cfg.nx, cfg.ny, spp_total, ray0, num_rays, cfg.max_depth,
            float(cfg.t_min), tape.data_ptr(), its.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("recorder launch failed: "
                           f"{lib.frt_error_string(err).decode()} ({err})")
    record_paths_mega.legacy_launches += 1
    return tape, its


def record_paths_mega(pack: MegaScenePack, camera, cfg, key, ray0: int = 0,
                      num_rays: int = None, spp_total: int = None,
                      return_iters: bool = False, impl: str = "mega",
                      spp_sizes=None):
    """(max_depth + 1, R) int32 primitive tape for rays ``[ray0, ray0 + R)``.

    Entry ``tape[d, i]`` is the original scene id of the primitive that ray
    ``ray0 + i`` hit at bounce ``d``, or -1 on a miss or after its path
    ended: the contract of ``diff.replay.record_paths``, so
    ``trace_rays_replay`` consumes it unchanged.  Ray id ``rid`` is sample
    ``rid % spp_total`` of pixel ``rid // spp_total``.

    ``impl="mega"`` runs K2 over the pixels holding the range; ``"legacy"``
    runs K2b.  ``return_iters=True`` (K2b) also returns the (R,) int32
    bounce-loop trip count of each ray, i.e. its segment count; the JAX
    recorder's count is per tile of TPU lanes instead, which depends on its
    schedule.  ``spp_sizes`` is accepted for the JAX package's signature and
    ignored: the TPU recorder splits the samples into batches that fit its
    VMEM, while one launch covers all of them here.
    """
    del spp_sizes
    if num_rays is None:
        num_rays = cfg.num_rays
    if spp_total is None:
        spp_total = cfg.spp
    if ray0 < 0 or num_rays < 0:
        raise ValueError(f"bad ray range ray0={ray0} num_rays={num_rays}")
    if ray0 + num_rays > MAX_RAY_ID:
        raise ValueError("ray ids must stay below 2^24 (the JAX recorder's "
                         "f32-exact decode bound)")
    if impl not in ("mega", "legacy"):
        raise ValueError(f"unknown recorder impl {impl!r}")
    if impl == "mega" and not return_iters:
        p0 = ray0 // spp_total
        p1 = -(-(ray0 + num_rays) // spp_total)
        off = ray0 - p0 * spp_total
        _, _, tape = render_pixels_mega(
            pack, camera, dataclasses.replace(cfg, spp=spp_total), key,
            pix0=p0, num_pixels=p1 - p0, emit_tape=True)
        return tape[:, off:off + num_rays]
    check_guards(pack, cfg)
    dev = pack.device
    if dev.type == "cpu":
        tape, its = record_paths_mega_reference(pack, camera, cfg, key, ray0,
                                                num_rays, spp_total)
    elif dev.type == "cuda":
        tape, its = _launch_record(pack, camera_table(camera).to(dev), cfg,
                                   key, ray0, num_rays, spp_total)
    else:
        raise ValueError(f"no recorder kernel for device {dev}")
    return (tape, its) if return_iters else tape


record_paths_mega.legacy_launches = 0  # K2b launches (CUDA path only)


def record_paths_mega_reference(pack: MegaScenePack, camera, cfg, key,
                                ray0: int = 0, num_rays: int = None,
                                spp_total: int = None):
    """K2b's plain version: ``(tape (D, R), its (R,))`` for rays
    ``[ray0, ray0 + R)`` in plain PyTorch, on the pack's device, chunked
    over rays."""
    if num_rays is None:
        num_rays = cfg.num_rays
    if spp_total is None:
        spp_total = cfg.spp
    check_guards(pack, cfg)
    dev = pack.device
    camera = camera.to(dev)
    tape = torch.empty((cfg.max_depth + 1, num_rays), dtype=torch.int32,
                       device=dev)
    its = torch.empty((num_rays,), dtype=torch.int32, device=dev)
    chunk = default_rays_per_chunk(pack)
    for lo in range(0, num_rays, chunk):
        hi = min(lo + chunk, num_rays)
        rid = torch.arange(ray0 + lo, ray0 + hi, dtype=torch.int64,
                           device=dev)
        pix = torch.div(rid, spp_total, rounding_mode="floor")
        _, its[lo:hi], tape[:, lo:hi] = trace_reference(pack, camera, cfg,
                                                        key, pix, rid)
    return tape, its
