"""Stackless flat-BVH walk (K6 on the card, plain PyTorch on the CPU).

Port of ``first_raytracer_tpu.accel.traverse``.  A ray walks the preorder
node array: a box hit on an inner node steps to ``node + 1`` (the left
child), a box miss or a finished leaf jumps to ``skip[node]``; ``t_best``
shrinks the slab interval as hits accumulate.  Leaf slots are tested up to
``max_leaf``; a mixed scene picks the primitive's test by its id.  A slot
replaces the winner only at a strictly smaller t, in walk order.

``intersect_bvh`` dispatches by the BVH's device.  On a CUDA device it
launches K6 (``kernels/csrc/bvh_walk.cu``): one thread walks one ray to its
end, with no host read, so the wavefront loops around it replay as CUDA
graphs (``render/graphed.py``).  On the CPU it runs
``intersect_bvh_plain``, the JAX package's ``lax.while_loop`` in plain
PyTorch: every ray steps in lockstep, and the host reads "any ray still
walking" once a step.  K6 is bit-equal to it (prim and t) on the card.  A
failed build or launch raises; nothing falls back to the plain walk.  Both
return ``(prim, t, hit)`` only; the integrator recomputes the hit record
from the id.
"""
from __future__ import annotations

import ctypes

import torch

from ..geometry.aabb import aabb_hit
from ..geometry.sphere import BIG, sphere_hit_one
from ..geometry.triangle import triangle_hit_one

__all__ = ["WALK_COLUMNS", "prim_hit_one", "intersect_bvh",
           "intersect_bvh_plain"]

REPLACES = "first_raytracer_tpu/accel/traverse.py:64"
# K6's per-ray counters (``return_counters=True``): nodes whose box it
# tested, sphere slots and triangle slots it tested.
WALK_COLUMNS = ("nodes", "sphere_slots", "triangle_slots")


def prim_hit_one(scene, pid, origin, direction, t_min):
    """Hit distance of R rays against R global primitive ids."""
    ns, nt = scene.num_spheres, scene.num_triangles
    pid = pid.long()
    if nt == 0:
        si = torch.clamp(pid, 0, ns - 1)
        return sphere_hit_one(origin, direction, scene.sphere_center[si],
                              scene.sphere_radius[si], t_min, BIG)
    if ns == 0:
        ti = torch.clamp(pid, 0, nt - 1)
        return triangle_hit_one(origin, direction, scene.tri_v0[ti],
                                scene.tri_v1[ti], scene.tri_v2[ti],
                                t_min, BIG)
    si = torch.clamp(pid, 0, ns - 1)
    ti = torch.clamp(pid - ns, 0, nt - 1)
    t_s = sphere_hit_one(origin, direction, scene.sphere_center[si],
                         scene.sphere_radius[si], t_min, BIG)
    t_t = triangle_hit_one(origin, direction, scene.tri_v0[ti],
                           scene.tri_v1[ti], scene.tri_v2[ti], t_min, BIG)
    return torch.where(pid < ns, t_s, t_t)


@torch.no_grad()
def intersect_bvh_plain(scene, bvh, origin, direction, t_min,
                        max_leaf: int = 4):
    """K6's plain version: the lockstep walk, one host read a step.

    ``max_leaf`` is the number of leaf slots tested per step (at least the
    builder's ``max_leaf``).  Returns ``(prim (R,) i32, t (R,) f32, hit
    (R,) bool)``, on the rays' device.
    """
    n_nodes = bvh.num_nodes
    np_total = bvh.prim_ids.shape[0]
    R = origin.shape[0]
    dev = origin.device
    inv_d = 1.0 / direction
    node = torch.zeros((R,), dtype=torch.int64, device=dev)
    t_best = torch.full((R,), BIG, dtype=torch.float32, device=dev)
    prim_best = torch.zeros((R,), dtype=torch.int32, device=dev)
    node_skip = bvh.node_skip.long()
    while bool((node < n_nodes).any()):
        active = node < n_nodes
        nidx = torch.clamp(node, max=n_nodes - 1)
        box_ok = active & aabb_hit(origin, inv_d, bvh.node_min[nidx],
                                   bvh.node_max[nidx], t_min, t_best)
        count = bvh.node_count[nidx]
        is_leaf = count > 0
        first = bvh.node_first[nidx].long()
        test_leaf = box_ok & is_leaf
        for k in range(max_leaf):
            slot_ok = test_leaf & (k < count)
            pid = bvh.prim_ids[torch.clamp(first + k, max=np_total - 1)]
            t_k = prim_hit_one(scene, pid, origin, direction, t_min)
            better = slot_ok & (t_k < t_best)
            t_best = torch.where(better, t_k, t_best)
            prim_best = torch.where(better, pid, prim_best)
        descend = box_ok & ~is_leaf
        nxt = torch.where(descend, nidx + 1, node_skip[nidx])
        node = torch.where(active, nxt, n_nodes)
    return prim_best, t_best, t_best < BIG


def _launch_cuda(scene, bvh, o, d, t_min, max_leaf, return_counters):
    """K6 over the rays ``o``, ``d`` ((R, 3) f32, contiguous): (prim, t,
    hit, counters or None).  Makes no host read and allocates through
    torch, so a CUDA graph can capture it."""
    from ..kernels import megakernel
    from ..kernels.megakernel import _check

    dev = bvh.device
    n, np_total = bvh.num_nodes, bvh.prim_ids.shape[0]
    ns, nt = scene.num_spheres, scene.num_triangles
    f32, i32 = torch.float32, torch.int32
    for name, shape, dtype in (
            ("node_min", (n, 3), f32), ("node_max", (n, 3), f32),
            ("node_first", (n,), i32), ("node_count", (n,), i32),
            ("node_skip", (n,), i32), ("prim_ids", (np_total,), i32)):
        _check(name, getattr(bvh, name), dtype, shape, dev)
    for name, shape in (("sphere_center", (ns, 3)), ("sphere_radius", (ns,)),
                        ("tri_v0", (nt, 3)), ("tri_v1", (nt, 3)),
                        ("tri_v2", (nt, 3))):
        _check(name, getattr(scene, name), f32, shape, dev)
    if max_leaf < 1:
        raise ValueError(f"max_leaf must be at least 1, not {max_leaf}")
    R = o.shape[0]
    prim = torch.empty((R,), dtype=i32, device=dev)
    t = torch.empty((R,), dtype=f32, device=dev)
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    counters = (torch.empty((R, len(WALK_COLUMNS)), dtype=i32, device=dev)
                if return_counters else None)
    megakernel.launch_entry(
        dev, "frt_bvh_walk", o.data_ptr(), d.data_ptr(),
        bvh.node_min.data_ptr(), bvh.node_max.data_ptr(),
        bvh.node_first.data_ptr(), bvh.node_count.data_ptr(),
        bvh.node_skip.data_ptr(), bvh.prim_ids.data_ptr(), n, np_total,
        scene.sphere_center.data_ptr(), scene.sphere_radius.data_ptr(), ns,
        scene.tri_v0.data_ptr(), scene.tri_v1.data_ptr(),
        scene.tri_v2.data_ptr(), nt, max_leaf, R, ctypes.c_float(t_min),
        prim.data_ptr(), t.data_ptr(), hit.data_ptr(),
        None if counters is None else counters.data_ptr())
    if R:
        intersect_bvh.launches += 1
    return prim, t, hit, counters


def intersect_bvh(scene, bvh, origin, direction, t_min, max_leaf: int = 4,
                  return_counters: bool = False):
    """Closest hit via the flat BVH; the contract of ``intersect_brute``:
    ``(prim (R,) i32, t (R,) f32, hit (R,) bool)``.

    Launches K6 for CUDA tensors and runs ``intersect_bvh_plain`` for CPU
    tensors; the device is the BVH's.  ``max_leaf`` is the number of leaf
    slots tested per node (at least the builder's ``max_leaf``).  With
    ``return_counters=True`` (K6 only) also K6's per-ray (R, 3) int32
    counters of ``WALK_COLUMNS``.
    """
    from ..kernels.intersect_pallas import check_rays

    dev = bvh.device
    if dev.type == "cpu":
        if return_counters:
            raise ValueError("the plain walk keeps no counters")
        return intersect_bvh_plain(scene, bvh, origin, direction, t_min,
                                   max_leaf)
    if dev.type != "cuda":
        raise ValueError(f"no BVH walk kernel for device {dev}")
    o, d = check_rays(origin, direction, dev)
    prim, t, hit, counters = _launch_cuda(scene, bvh, o, d, float(t_min),
                                          max_leaf, return_counters)
    return (prim, t, hit, counters) if return_counters else (prim, t, hit)


intersect_bvh.launches = 0  # K6 launches (CUDA path only)
