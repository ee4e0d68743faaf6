"""Render meshes over ``torch.distributed``, and the collectives the port
uses.

Port of ``first_raytracer_tpu.parallel.mesh``.  The scaling axes are the
JAX package's: data-parallel **tiles** (blocks of pixels) and **spp**
(blocks of samples per pixel).  There a ``jax.sharding.Mesh`` lays devices
out as a (tiles, spp) grid; here each rank of a ``torch.distributed``
process group is one cell of that grid, rank ``r`` at tile ``r // spp``
and spp ``r % spp`` (the JAX mesh's row-major layout of its device list).
Scene and camera are replicated: every rank builds them from the same
inputs.

Every collective of the port goes through a ``MeshAxis`` of a
``RenderMesh``: ``all_reduce`` (a sum), ``all_gather`` (concatenated along
the first dimension in axis order) and ``ring_shift`` (send to the
previous rank of the axis, receive from the next).  A mesh made without a
process group has one rank and runs no collective; with a group of any
size, 1 included, every collective goes through it.

Transport: NCCL for CUDA tensors, gloo for CPU tensors.  gloo takes few
collectives on CUDA tensors and no point-to-point transfer of them, so when
an axis's backend is gloo and the tensor lies on a GPU (several processes
sharing one card, where NCCL refuses duplicate GPUs) the transfer is staged
through host tensors; the compute stays on the card.  Each axis logs the
transport it takes the first time it takes it, and keeps the names in
``MeshAxis.transports``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["TILE_AXIS", "SPP_AXIS", "MeshAxis", "RenderMesh",
           "make_render_mesh", "initialize_distributed", "local_device"]

TILE_AXIS = "tiles"
SPP_AXIS = "spp"

logger = logging.getLogger("first_raytracer_tpu_torch")


class MeshAxis:
    """One axis of a mesh as seen from this rank: its process group (None
    without one), its size and this rank's index along it."""

    def __init__(self, name: str, group, ranks):
        self.name = name
        self.group = group
        self.ranks = tuple(ranks)      # global ranks, in axis order
        self.size = len(self.ranks)
        self.index = (self.ranks.index(dist.get_rank()) if group is not None
                      else 0)
        self.transports = set()

    def __repr__(self):
        return (f"MeshAxis({self.name!r}, size={self.size}, "
                f"index={self.index})")

    def _staged(self, t):
        """Whether ``t`` goes through a host copy (gloo and a GPU tensor);
        logs the transport the first time this axis takes it."""
        backend = dist.get_backend(self.group)
        staged = backend == "gloo" and t.device.type != "cpu"
        transport = (f"{backend} via host tensors" if staged else
                     f"{backend} on {t.device.type} tensors")
        if transport not in self.transports:
            self.transports.add(transport)
            logger.info("mesh axis %s (%d ranks): collectives over %s",
                        self.name, self.size, transport)
        return staged

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis, written into ``t`` and
        returned."""
        if self.group is None:
            return t
        # The collective needs a dense buffer (a gradient may be a strided
        # view of a larger storage).
        buf = (t.cpu() if self._staged(t) else
               t if t.is_contiguous() else t.contiguous())
        dist.all_reduce(buf, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The axis's ``t``s concatenated along dimension 0, in axis
        order; each rank's ``t`` must have the same shape."""
        if self.group is None:
            return t
        staged = self._staged(t)
        src = t.cpu() if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts).to(t.device)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` sent to the previous rank of the axis (index - 1, mod its
        size); returns what the next rank (index + 1) sent."""
        if self.group is None or self.size == 1:
            return t
        staged = self._staged(t)
        src = t.cpu() if staged else t.contiguous()
        out = torch.empty_like(src)
        prev = self.ranks[(self.index - 1) % self.size]
        nxt = self.ranks[(self.index + 1) % self.size]
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, prev, group=self.group),
            dist.P2POp(dist.irecv, out, nxt, group=self.group)])
        for req in reqs:
            req.wait()
        return out.to(t.device)


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """A (tiles, spp) grid of ranks and this rank's place in it.

    ``tiles_axis`` joins the ranks of this rank's spp index (the pixel
    blocks), ``spp_axis`` those of its tile index (the sample blocks) and
    ``world`` all ranks of the mesh."""

    tiles: int
    spp: int
    rank: int
    tiles_axis: MeshAxis
    spp_axis: MeshAxis
    world: MeshAxis

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: self.tiles, SPP_AXIS: self.spp}

    @property
    def size(self) -> int:
        return self.tiles * self.spp

    @property
    def tile_index(self) -> int:
        return self.rank // self.spp

    @property
    def spp_index(self) -> int:
        return self.rank % self.spp

    def axis(self, name: str) -> MeshAxis:
        return {TILE_AXIS: self.tiles_axis, SPP_AXIS: self.spp_axis}[name]

    def ray_block(self, n: int):
        """This rank's contiguous block ``(lo, hi)`` of ``n`` rays split
        over all the mesh's ranks; ``ValueError`` unless they divide."""
        if n % self.size:
            raise ValueError(f"{n} rays not divisible by {self.size} ranks")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def sum_over_ranks(self, loss, grads):
        """The loss and every gradient (a dict) summed over all the mesh's
        ranks: one all-reduce of them laid end to end."""
        flat = self.world.all_reduce(torch.cat(
            [loss.reshape(1)] + [g.reshape(-1) for g in grads.values()]))
        parts = flat[1:].split([g.numel() for g in grads.values()])
        return flat[0], {k: p.reshape(g.shape)
                         for (k, g), p in zip(grads.items(), parts)}

    def tiles_only(self) -> "RenderMesh":
        """The same ranks laid out as (size, 1): every rank a pixel
        block."""
        return dataclasses.replace(
            self, tiles=self.size, spp=1, tiles_axis=self.world,
            spp_axis=MeshAxis(SPP_AXIS, None, (self.rank,)))


def make_render_mesh(num_tile_shards: Optional[int] = None,
                     num_spp_shards: int = 1) -> RenderMesh:
    """A (tiles, spp) mesh over the default process group's ranks (one
    rank without a group); by default every rank on the tile axis.

    Raises ``ValueError`` when ``num_tile_shards * num_spp_shards`` is not
    the world size.  With a group, every rank must make the same meshes in
    the same order: each mesh makes its axes' process groups.
    """
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if grouped else 1
    if num_tile_shards is None:
        num_tile_shards = n // num_spp_shards
    if num_tile_shards * num_spp_shards != n:
        raise ValueError(f"mesh {num_tile_shards}x{num_spp_shards} != {n} "
                         "ranks")
    tiles, spp = num_tile_shards, num_spp_shards
    if not grouped:
        return RenderMesh(tiles, spp, 0, MeshAxis(TILE_AXIS, None, (0,)),
                          MeshAxis(SPP_AXIS, None, (0,)),
                          MeshAxis("world", None, (0,)))
    rank = dist.get_rank()
    axes = {}
    # new_group is collective: every rank creates every group, in order.
    for t in range(tiles):
        ranks = [t * spp + s for s in range(spp)]
        group = dist.new_group(ranks)
        if rank in ranks:
            axes[SPP_AXIS] = MeshAxis(SPP_AXIS, group, ranks)
    for s in range(spp):
        ranks = [t * spp + s for t in range(tiles)]
        group = dist.new_group(ranks)
        if rank in ranks:
            axes[TILE_AXIS] = MeshAxis(TILE_AXIS, group, ranks)
    world = MeshAxis("world", dist.group.WORLD, range(n))
    return RenderMesh(tiles, spp, rank, axes[TILE_AXIS], axes[SPP_AXIS],
                      world)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Joins this process to a process group of ``num_processes``; a no-op
    for one process, as in the JAX package.

    ``coordinator`` is ``host:port`` of rank 0's store (``tcp://`` may be
    given), or None to read ``MASTER_ADDR`` and ``MASTER_PORT`` as
    ``torchrun`` sets them.  ``backend`` defaults to NCCL where every
    process of this host has a GPU of its own (``LOCAL_WORLD_SIZE``, or
    ``num_processes``, at most the GPU count), else gloo: NCCL refuses two
    ranks on one GPU.
    """
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        backend = ("nccl" if torch.cuda.is_available()
                   and local <= torch.cuda.device_count() else "gloo")
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def local_device(device="cuda") -> torch.device:
    """``device``, with a bare ``"cuda"`` resolved to this process's GPU:
    ``LOCAL_RANK`` modulo the GPU count (0 in a single process)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % count if count else 0)
    return device
