"""Tape recorders of the differentiable pass: K2b for dense packs and K3t
for clustered ones.

Port of ``first_raytracer_tpu.kernels.record_mega``.  The record->replay
pass (``diff/replay.py``) records, outside the autograd graph, which
primitive each ray hit at each bounce: a ``(max_depth + 1, R)`` int32 tape,
-1 for a miss or a dead path, else the original scene id (spheres
``0..Ns-1``, triangles ``Ns + j``).  The recorders here produce that tape
for a contiguous range of ray ids ``[ray0, ray0 + R)``.  Both kernels run
persistent warps that take windows of consecutive ray ids from a
launch-wide counter, each lane taking the next unstarted id as its path
ends, and every ray writes its own tape column, so the outputs do not
depend on the schedule:

- ``record_paths_mega``: K2b (``record_kernel`` in ``csrc/megakernel.cu``)
  on a dense pack.  K2, the megakernel with its tape on, stays reachable
  through ``megakernel.render_pixels_mega(emit_tape=True)``; K2b is the
  faster of the two at every size measured (PERF.md), so it records every
  dense tape;
- ``record_paths_mega_clustered``: K3t (``record_clustered_kernel`` in
  ``csrc/megakernel_clustered.cu``) on a clustered pack, with no bound on
  the scene's size below 2^24 primitives.

Every kernel traces through the same device routine as K1 and K3, so the
tapes are the rendered paths.  On the CPU each runs its plain version; a
tensor on any other device is refused; nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import rng
from . import megakernel
from .megakernel import (MegaScenePack, camera_table, check_guards,
                         check_pack, default_rays_per_chunk,
                         pack_scene_mega, trace_reference)
from .megakernel_clustered import (MegaClusteredPack, SWEEP_COLUMNS,
                                   check_clustered_guards,
                                   check_clustered_pack, table_args,
                                   ungated_sweeps)

__all__ = ["record_paths_mega", "record_paths_mega_reference",
           "record_paths_mega_clustered",
           "record_paths_mega_clustered_reference", "pack_scene_mega",
           "MegaScenePack"]

REPLACES = "first_raytracer_tpu/kernels/record_mega.py:62"
# Ray ids stay below 2^24, the JAX recorder's f32-exact decode bound, so
# both packages accept the same inputs.
MAX_RAY_ID = 1 << 24


def _launch_record(pack, cam, cfg, key, ray0, num_rays, spp_total,
                   return_steps=False):
    """Launch K2b on the current stream; returns (tape (D, R), its (R,)),
    then with ``return_steps`` the warps' segment steps (R,): each warp's
    at the first ray of its first window, 0 elsewhere."""
    dev = pack.device
    check_pack(pack, cam)
    # K2b writes every entry of its outputs: no fill needed.
    tape = torch.empty((cfg.max_depth + 1, num_rays), dtype=torch.int32,
                       device=dev)
    its = torch.empty((num_rays,), dtype=torch.int32, device=dev)
    steps = (torch.empty((num_rays,), dtype=torch.int32, device=dev)
             if return_steps else None)
    work = torch.empty((1,), dtype=torch.int32, device=dev)  # its counter
    groups = (ctypes.c_int * 14)(*pack.sph_groups, *pack.tri_groups)
    k0, k1 = rng.key_words(key)
    megakernel.launch_entry(
        dev, "frt_record_paths", cam.data_ptr(), pack.spheres.data_ptr(),
        pack.sph_mx.data_ptr(), pack.tris.data_ptr(), pack.sphere_rows,
        pack.tri_rows, pack.spheres.shape[1], pack.tris.shape[1], groups, k0,
        k1, cfg.nx, cfg.ny, spp_total, ray0, num_rays, cfg.max_depth,
        float(cfg.t_min), tape.data_ptr(), its.data_ptr(),
        steps.data_ptr() if return_steps else None, work.data_ptr())
    record_paths_mega.launches += 1
    return (tape, its, steps) if return_steps else (tape, its)


def _ray_range(cfg, ray0, num_rays, spp_total):
    if num_rays is None:
        num_rays = cfg.num_rays
    if spp_total is None:
        spp_total = cfg.spp
    if ray0 < 0 or num_rays < 0:
        raise ValueError(f"bad ray range ray0={ray0} num_rays={num_rays}")
    if ray0 + num_rays > MAX_RAY_ID:
        raise ValueError("ray ids must stay below 2^24 (the JAX recorder's "
                         "f32-exact decode bound)")
    return num_rays, spp_total


def record_paths_mega(pack: MegaScenePack, camera, cfg, key, ray0: int = 0,
                      num_rays: int = None, spp_total: int = None,
                      return_iters: bool = False, spp_sizes=None):
    """(max_depth + 1, R) int32 primitive tape for rays ``[ray0, ray0 + R)``.

    Entry ``tape[d, i]`` is the original scene id of the primitive that ray
    ``ray0 + i`` hit at bounce ``d``, or -1 on a miss or after its path
    ended: the contract of ``diff.replay.record_paths``, so
    ``trace_rays_replay`` consumes it unchanged.  Ray id ``rid`` is sample
    ``rid % spp_total`` of pixel ``rid // spp_total``.

    Runs K2b.  ``return_iters=True`` also returns the (R,) int32
    bounce-loop trip count of each ray, i.e. its segment count; the JAX
    recorder's count is per tile of TPU lanes instead, which depends on its
    schedule.  ``spp_sizes`` is accepted for the JAX package's signature and
    ignored: the TPU recorder splits the samples into batches that fit its
    VMEM, while one launch covers all of them here.
    """
    del spp_sizes
    num_rays, spp_total = _ray_range(cfg, ray0, num_rays, spp_total)
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


record_paths_mega.launches = 0  # K2b launches (CUDA path only)


def _record_reference(pack, camera, cfg, key, ray0, num_rays, spp_total):
    """``(tape (D, R), its (R,))`` of ``trace_reference``'s paths for rays
    ``[ray0, ray0 + R)`` on a dense or a clustered pack, chunked."""
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


def record_paths_mega_reference(pack: MegaScenePack, camera, cfg, key,
                                ray0: int = 0, num_rays: int = None,
                                spp_total: int = None):
    """K2b's plain version: ``(tape (D, R), its (R,))`` for rays
    ``[ray0, ray0 + R)`` in plain PyTorch, on the pack's device, chunked
    over rays."""
    num_rays, spp_total = _ray_range(cfg, ray0, num_rays, spp_total)
    check_guards(pack, cfg)
    return _record_reference(pack, camera, cfg, key, ray0, num_rays,
                             spp_total)


def _launch_record_clustered(pack, cam, cfg, key, ray0, num_rays,
                             spp_total):
    """Launch K3t on the current stream; returns (tape (D, R), its (R,),
    sweeps (R, 6))."""
    dev = pack.device
    check_clustered_pack(pack, cam)
    # K3t writes every entry of its outputs: no fill needed.
    tape = torch.empty((cfg.max_depth + 1, num_rays), dtype=torch.int32,
                       device=dev)
    its = torch.empty((num_rays,), dtype=torch.int32, device=dev)
    sweeps = torch.empty((num_rays, len(SWEEP_COLUMNS)), dtype=torch.int32,
                         device=dev)
    work = torch.empty((1,), dtype=torch.int32, device=dev)  # its counter
    k0, k1 = rng.key_words(key)
    megakernel.launch_entry(
        dev, "frt_record_clustered", *table_args(pack, cam), k0, k1, cfg.nx,
        cfg.ny, spp_total, ray0, num_rays, cfg.max_depth, float(cfg.t_min),
        tape.data_ptr(), its.data_ptr(), sweeps.data_ptr(), work.data_ptr())
    record_paths_mega_clustered.launches += 1
    return tape, its, sweeps


def record_paths_mega_clustered(pack: MegaClusteredPack, camera, cfg, key,
                                ray0: int = 0, num_rays: int = None,
                                spp_total: int = None,
                                return_iters: bool = False):
    """``record_paths_mega``'s tape on a clustered pack
    (``megakernel_clustered.pack_scene_mega_clustered``): K3t for CUDA
    tensors, its plain version for CPU tensors.

    Same contract: -1 for a miss or a dead path, else the original scene id,
    spheres then triangles, for the contiguous ray range ``[ray0, ray0 +
    R)``; ray ids and ``Ns + Nt`` stay below 2^24.  ``return_iters=True``
    also returns each ray's trip count (R,) and its ``SWEEP_COLUMNS``
    counters (R, 4) int32, ungated ones for the plain version.
    """
    num_rays, spp_total = _ray_range(cfg, ray0, num_rays, spp_total)
    check_clustered_guards(pack, cfg)
    dev = pack.device
    if dev.type == "cpu":
        tape, its = record_paths_mega_clustered_reference(
            pack, camera, cfg, key, ray0, num_rays, spp_total)
        sweeps = ungated_sweeps(pack, its) if return_iters else None
    elif dev.type == "cuda":
        tape, its, sweeps = _launch_record_clustered(
            pack, camera_table(camera).to(dev), cfg, key, ray0, num_rays,
            spp_total)
    else:
        raise ValueError(f"no clustered recorder kernel for device {dev}")
    return (tape, its, sweeps) if return_iters else tape


record_paths_mega_clustered.launches = 0  # K3t launches (CUDA path only)


def record_paths_mega_clustered_reference(pack: MegaClusteredPack, camera,
                                          cfg, key, ray0: int = 0,
                                          num_rays: int = None,
                                          spp_total: int = None):
    """K3t's plain version: ``(tape (D, R), its (R,))`` in plain PyTorch,
    every column of the clustered pack swept with no gates."""
    num_rays, spp_total = _ray_range(cfg, ray0, num_rays, spp_total)
    check_clustered_guards(pack, cfg)
    return _record_reference(pack, camera, cfg, key, ray0, num_rays,
                             spp_total)
