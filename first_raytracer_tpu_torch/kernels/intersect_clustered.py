"""Two-level clustered closest hit of a ray batch (K5): the wavefront
integrator's intersector for large scenes, and the host's SAH clustering.

Port of ``first_raytracer_tpu.kernels.intersect_clustered``.  The host
(``pack_scene_clustered``, NumPy copied from the JAX package) cuts each
primitive type into SAH clusters of at most ``max_leaf`` (<= 128) slots,
each with a box; ``_cluster_type`` also decides the clusters of the
clustered megakernel's pack (``megakernel_clustered.py``).  On a CUDA
device ``intersect_clustered`` launches the hand-written kernel in
``csrc/intersect.cu``: one thread per ray runs the sphere pass over the
sphere clusters in pack order, then the triangle pass seeded with its
winner, slab-tests each cluster's box against the ray's current best t and
sweeps the clusters that pass; the winner is the lexicographic minimum of
(t, global id), so it does not depend on which gates fire, and a sphere
wins a sphere/triangle tie.  On the CPU it runs
``intersect_clustered_reference``, which sweeps every column of the pack
with no gates and takes the same minimum.  A tensor on any other device is
refused; nothing falls back.

Not carried over: the JAX pack's 8 MiB ``vmem_budget_bytes`` guard, which
bounds the TPU kernel's VMEM (the card reads the planes from device
memory, where a 20,000-primitive scene takes 10 MB); the TPU's ray tiles,
``C_BLK`` blocks and per-tile gates.  The pack keeps JAX's arrays, f32 gid
rows included, and adds int32 gids and member counts for the kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import sys

import numpy as np
import torch

from ..geometry.sphere import BIG
from .intersect_pallas import (check_rays, ray_chunks, sphere_oc_t,
                               triangle_mt_t)

__all__ = ["ClusteredScenePack", "pack_scene_clustered",
           "intersect_clustered", "intersect_clustered_reference"]

REPLACES = "first_raytracer_tpu/kernels/intersect_clustered.py:272"
_BIG = 1e30
_LANE = 128          # cluster slot capacity
C_BLK = 16           # the JAX pack pads the cluster count to a multiple
# Per-ray counters of ``return_iters``: clusters swept (spheres and
# triangles), sphere and triangle slots tested, cluster boxes slab-tested.
SWEEP_COLUMNS = ("clusters", "sphere_slots", "triangle_slots", "box_tests")


def _round_up(x, m):
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ClusteredScenePack:
    """SAH-clustered scene SoA, tensors on one device.

    The first six fields are the JAX pack's.  ``sph_gid``/``tri_gid``
    (K_pad, 128) int32 hold each slot's global id (triangles offset by Ns,
    0 in empty slots), ``sph_count``/``tri_count`` (K_pad,) int32 the
    members of each cluster, which fill its first slots.
    """

    sph: torch.Tensor      # (Ks_pad*8, 128) f32: per cluster cx cy cz r gid
    tri: torch.Tensor      # (Kt_pad*16, 128) f32: v0 v1 v2 (9 rows) + gid
    sph_box: torch.Tensor  # (Ks_pad, 8) f32: mnx mny mnz mxx mxy mxz pad pad
    tri_box: torch.Tensor  # (Kt_pad, 8) f32
    sph_clusters: int      # true Ks (arrays are padded up)
    tri_clusters: int
    sph_gid: torch.Tensor
    tri_gid: torch.Tensor
    sph_count: torch.Tensor
    tri_count: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.sph.device

    def to(self, device) -> "ClusteredScenePack":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _cluster_type(bmin, bmax, gids, max_leaf):
    """SAH-cluster one primitive type; returns (boxes (K, 8), slot ids list).

    A sweep-SAH recursion over centroids: split along the widest centroid
    axis at the SAH-cheapest position until a run holds at most
    ``max_leaf`` primitives.  The leaves, in preorder, are the clusters;
    ``boxes[k, 0:3]`` and ``boxes[k, 3:6]`` bound cluster ``k``, and entry
    ``k`` of the list holds its members' ``gids``.
    """
    n = bmin.shape[0]
    clusters = []

    centroid = 0.5 * (bmin + bmax)

    def area(mn, mx):
        e = np.maximum(mx - mn, 0.0)
        return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

    def split_sah(order, axis):
        k = len(order)
        lmn = np.minimum.accumulate(bmin[order], axis=0)
        lmx = np.maximum.accumulate(bmax[order], axis=0)
        rmn = np.minimum.accumulate(bmin[order][::-1], axis=0)[::-1]
        rmx = np.maximum.accumulate(bmax[order][::-1], axis=0)[::-1]
        i = np.arange(1, k)
        cost = area(lmn, lmx)[:-1] * i + area(rmn, rmx)[1:] * (k - i)
        return int(np.argmin(cost)) + 1

    def rec(ids):
        if len(ids) <= max_leaf:
            clusters.append(ids)
            return
        ext = centroid[ids].max(axis=0) - centroid[ids].min(axis=0)
        axis = int(np.argmax(ext))
        order = ids[np.argsort(centroid[ids, axis], kind="stable")]
        s = min(max(split_sah(order, axis), 1), len(order) - 1)
        rec(order[:s])
        rec(order[s:])

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 4 * n + 64))
    try:
        rec(np.arange(n, dtype=np.int64))
    finally:
        sys.setrecursionlimit(old)

    boxes = np.zeros((len(clusters), 8), np.float32)
    for k, ids in enumerate(clusters):
        boxes[k, 0:3] = bmin[ids].min(axis=0)
        boxes[k, 3:6] = bmax[ids].max(axis=0)
    return boxes, [gids[ids] for ids in clusters]


def pack_scene_clustered(scene, max_leaf: int = _LANE
                         ) -> ClusteredScenePack:
    """Host-side clustering and repack (once per scene); the tables land on
    the scene's device.  ``max_leaf`` is in (0, 128]."""
    if not 0 < max_leaf <= _LANE:
        raise ValueError(f"max_leaf must be in (0, {_LANE}]")
    from ..geometry.aabb import sphere_aabb_np, triangle_aabb_np

    scene_np = scene.as_numpy()
    ns, nt = scene.num_spheres, scene.num_triangles
    if ns + nt >= 1 << 24:
        raise ValueError("global ids must stay exact in f32 (< 2^24)")

    def pack_type(boxes, cluster_gids, rows, fill, gid0):
        # Plane-major: cluster k's plane r is row k * rows + r.
        k = len(cluster_gids)
        k_pad = max(_round_up(k, C_BLK), C_BLK)
        geo = np.full((k_pad * rows, _LANE), 0.0, np.float32)
        box = _inverted_boxes(k_pad)
        box[:k] = boxes
        gid = np.zeros((k_pad, _LANE), np.int32)
        count = np.zeros(k_pad, np.int32)
        for kk, gids in enumerate(cluster_gids):
            fill(geo[kk * rows:(kk + 1) * rows], gids)
            gid[kk, :len(gids)] = gids + gid0
            count[kk] = len(gids)
        return geo, box, k, gid, count

    def _inverted_boxes(k):
        box = np.zeros((k, 8), np.float32)
        box[:, 0:3] = _BIG          # inverted box: slab test never passes
        box[:, 3:6] = -_BIG
        return box

    def empty(rows):
        return (np.zeros((C_BLK * rows, _LANE), np.float32),
                _inverted_boxes(C_BLK), 0,
                np.zeros((C_BLK, _LANE), np.int32), np.zeros(C_BLK, np.int32))

    sph_parts = empty(8)
    if ns:
        bmin, bmax = sphere_aabb_np(scene_np.sphere_center,
                                    scene_np.sphere_radius)
        boxes, cl = _cluster_type(bmin, bmax, np.arange(ns), max_leaf)

        def fill_s(blk, gids):
            # sentinel: centre at 1e30, radius 0 -> disc < 0 -> miss
            blk[0, :] = _BIG
            m = len(gids)
            c = scene_np.sphere_center[gids]
            blk[0, :m] = c[:, 0]
            blk[1, :m] = c[:, 1]
            blk[2, :m] = c[:, 2]
            blk[3, :m] = scene_np.sphere_radius[gids]
            blk[4, :m] = gids.astype(np.float32)

        sph_parts = pack_type(boxes, cl, 8, fill_s, 0)

    tri_parts = empty(16)
    if nt:
        bmin, bmax = triangle_aabb_np(scene_np.tri_v0, scene_np.tri_v1,
                                      scene_np.tri_v2)
        boxes, cl = _cluster_type(bmin, bmax, np.arange(nt), max_leaf)

        def fill_t(blk, gids):
            # sentinel: zero triangle -> zero determinant -> miss
            m = len(gids)
            for row, (arr, j) in enumerate(
                    (getattr(scene_np, f"tri_v{i}"), j)
                    for i in range(3) for j in range(3)):
                blk[row, :m] = arr[gids, j]
            blk[9, :m] = (gids + ns).astype(np.float32)

        tri_parts = pack_type(boxes, cl, 16, fill_t, ns)

    def dev(a):
        return torch.from_numpy(a).to(scene.device)

    sph, sph_box, ks, sph_gid, sph_count = sph_parts
    tri, tri_box, kt, tri_gid, tri_count = tri_parts
    return ClusteredScenePack(
        sph=dev(sph), tri=dev(tri), sph_box=dev(sph_box),
        tri_box=dev(tri_box), sph_clusters=ks, tri_clusters=kt,
        sph_gid=dev(sph_gid), tri_gid=dev(tri_gid),
        sph_count=dev(sph_count), tri_count=dev(tri_count))


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def _check_pack(pack):
    from .megakernel import _check

    dev = pack.device
    f32, i32 = torch.float32, torch.int32
    for name, rows in (("sph", 8), ("tri", 16)):
        k_pad = getattr(pack, f"{name}_box").shape[0]
        _check(name, getattr(pack, name), f32, (k_pad * rows, _LANE), dev)
        box = getattr(pack, f"{name}_box")
        _check(f"{name}_box", box, f32, (k_pad, 8), dev)
        if box.data_ptr() % 16:
            raise ValueError(f"{name}_box is not 16-byte aligned")
        _check(f"{name}_gid", getattr(pack, f"{name}_gid"), i32,
               (k_pad, _LANE), dev)
        _check(f"{name}_count", getattr(pack, f"{name}_count"), i32,
               (k_pad,), dev)
        if getattr(pack, f"{name}_clusters") > k_pad:
            raise ValueError(f"{name}: more clusters than rows")


def _launch_cuda(pack, o, d, t_min, return_iters):
    from .megakernel import load_mega_library

    dev = pack.device
    _check_pack(pack)
    lib, _ = load_mega_library()
    R = o.shape[0]
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    prim = torch.empty((R,), dtype=torch.int32, device=dev)
    sweeps = (torch.empty((R, len(SWEEP_COLUMNS)), dtype=torch.int32,
                          device=dev) if return_iters else None)
    with torch.cuda.device(dev):  # the launch goes to the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.frt_intersect_clustered(
            o.data_ptr(), d.data_ptr(), pack.sph.data_ptr(),
            pack.sph_box.data_ptr(), pack.sph_gid.data_ptr(),
            pack.sph_count.data_ptr(), pack.sph_clusters,
            pack.tri.data_ptr(), pack.tri_box.data_ptr(),
            pack.tri_gid.data_ptr(), pack.tri_count.data_ptr(),
            pack.tri_clusters, R, ctypes.c_float(t_min), t.data_ptr(),
            prim.data_ptr(), None if sweeps is None else sweeps.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("clustered intersect launch failed: "
                           f"{lib.frt_error_string(err).decode()} ({err})")
    if R:
        intersect_clustered.launches += 1
    return prim, t, sweeps


def intersect_clustered(scene, accel, origin, direction, t_min,
                        return_iters: bool = False):
    """Closest hit of rays ``origin + t direction`` (R, 3) against the
    clustered pack ``accel`` (a ``ClusteredScenePack``): ``(prim, t,
    hit)``, the contract of ``render.integrator.intersect_brute``; prim is
    the lexicographic-(t, global id) winner, 0 on a miss.

    Launches K5 for CUDA tensors and runs the plain version for CPU
    tensors; the device is the pack's.  With ``return_iters=True`` also
    the per-ray (R, 4) int32 counters of ``SWEEP_COLUMNS``: what K5's
    gated sweep did, or, for the plain version, what an ungated sweep does
    (every cluster of each present type, no box tests).  ``scene`` is not
    read.
    """
    dev = accel.device
    o, d = check_rays(origin, direction, dev)
    if dev.type == "cpu":
        out = intersect_clustered_reference(scene, accel, o, d, t_min)
        if not return_iters:
            return out
        per_ray = torch.tensor(
            [accel.sph_clusters + accel.tri_clusters,
             int(accel.sph_count.sum()), int(accel.tri_count.sum()), 0],
            dtype=torch.int32)
        return (*out, per_ray.expand(o.shape[0], 4).clone())
    if dev.type != "cuda":
        raise ValueError(f"no clustered intersect kernel for device {dev}")
    prim, t, sweeps = _launch_cuda(accel, o, d, float(t_min), return_iters)
    if return_iters:
        return prim, t, t < BIG, sweeps
    return prim, t, t < BIG


intersect_clustered.launches = 0  # K5 launches (CUDA path only)


def _lex_min(t_all, gid):
    """Row-wise lexicographic minimum of (t, gid) over (R, N) ``t_all``
    and (N,) ``gid``."""
    t = t_all.amin(dim=1)
    g = torch.where(t_all == t[:, None], gid[None, :],
                    torch.iinfo(torch.int32).max).amin(dim=1)
    return t, g


def intersect_clustered_reference(scene, accel, origin, direction, t_min):
    """K5's plain version: every column of the pack's clusters, no gates,
    the lexicographic (t, global id) minimum of the sphere pass folded with
    the triangle pass's as the kernel folds them.  The sentinel columns of
    a cluster's empty slots never hit."""
    pack = accel
    o = origin.to(torch.float32)
    d = direction.to(torch.float32)
    R = o.shape[0]
    ks, kt = pack.sph_clusters, pack.tri_clusters

    def columns(planes, rows, k):
        # Slot j of cluster k becomes column 128 k + j.  The padding
        # clusters past k hold zeros, not sentinels: they are left out.
        return planes[:k * rows].reshape(k, rows, _LANE).transpose(
            0, 1).reshape(rows, k * _LANE)

    sph, tri = columns(pack.sph, 8, ks), columns(pack.tri, 16, kt)
    sph_gid, tri_gid = pack.sph_gid[:ks].reshape(-1), \
        pack.tri_gid[:kt].reshape(-1)
    imax = torch.iinfo(torch.int32).max
    t = torch.full((R,), BIG, dtype=torch.float32, device=o.device)
    prim = torch.zeros((R,), dtype=torch.int32, device=o.device)
    for lo, ray in ray_chunks(o, d, (ks + kt) * _LANE):
        hi = lo + ray[0].shape[0]
        t_best = torch.full((hi - lo,), BIG, dtype=torch.float32,
                            device=o.device)
        g_best = torch.full((hi - lo,), imax, dtype=torch.int32,
                            device=o.device)
        for n_k, t_fn, gid in (
                (ks, lambda: sphere_oc_t(*ray, *sph[:4], t_min), sph_gid),
                (kt, lambda: triangle_mt_t(*ray, tri[:9], t_min), tri_gid)):
            if not n_k:
                continue
            t_cl, g_cl = _lex_min(t_fn(), gid)
            better = (t_cl < t_best) | ((t_cl == t_best) & (t_cl < BIG)
                                        & (g_cl < g_best))
            t_best = torch.where(better, t_cl, t_best)
            g_best = torch.where(better, g_cl, g_best)
        t[lo:hi] = t_best
        prim[lo:hi] = torch.where(t_best < BIG, g_best, 0)
    return prim, t, t < BIG
