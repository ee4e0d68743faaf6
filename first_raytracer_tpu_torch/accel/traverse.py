"""Stackless flat-BVH walk (K6 on the card, plain PyTorch on the CPU).

Port of ``first_raytracer_tpu.accel.traverse``.  A ray walks the preorder
node array: a box hit on an inner node steps to ``node + 1`` (the left
child), a box miss or a finished leaf jumps to ``skip[node]``; ``t_best``
shrinks the slab interval as hits accumulate.  Leaf slots are tested up to
``max_leaf``; a mixed scene picks the primitive's test by its id.  A slot
replaces the winner only at a strictly smaller t, in walk order.

``intersect_bvh`` dispatches by the BVH's device.  On a CUDA device it
launches K6 (``kernels/csrc/bvh_walk.cu``): each lane of a warp walks one
ray to its end over the BVH's 32-byte node records (``FlatBVH.nodes``),
with no host read, so the wavefront loops around it replay as CUDA graphs
(``render/graphed.py``).  K6 has two paths, chosen by size: when the
records and the leaf slots' primitives fit ``SHARED_BUDGET`` bytes
(``shared_bytes``) each block stages them in shared memory and walks from
there, else it walks from global memory.  On the CPU it runs
``intersect_bvh_plain``, the JAX package's ``lax.while_loop`` in plain
PyTorch: every ray steps in lockstep, and the host reads "any ray still
walking" once a step.  K6 is bit-equal to it (prim and t) and visits the
same nodes and leaf slots (``return_counters``).  A failed build or launch
raises; nothing falls back to the plain walk.  Both return ``(prim, t,
hit)`` only; the integrator recomputes the hit record from the id.
"""
from __future__ import annotations

import ctypes

import torch

from ..geometry.aabb import aabb_hit
from ..geometry.sphere import BIG, sphere_hit_one
from ..geometry.triangle import triangle_hit_one

__all__ = ["SHARED_BUDGET", "WALK_COLUMNS", "prim_hit_one", "intersect_bvh",
           "intersect_bvh_plain", "shared_bytes", "walk_path"]

REPLACES = "first_raytracer_tpu/accel/traverse.py:64"
# The per-ray counters of K6 and of the plain walk (``return_counters=
# True``): nodes whose box the walk tested, sphere slots and triangle slots
# it tested.
WALK_COLUMNS = ("nodes", "sphere_slots", "triangle_slots")
# K6 walks from shared memory when a BVH's records and leaf slots
# (``shared_bytes``) take at most this many bytes, else from global memory.
# On an H100 (probes/k6_grid.py, PERF.md) the shared path led by 9-14% at
# the final scene's 18 KB and tied at sphere_field(500)'s; from
# sphere_field(1000)'s 36 KB up the global path led (by 2% there, 22% at
# field5000's 180 KB): a block stages everything before it walks, and
# K6's walk is bound by its instructions, not its loads.  Passed to each
# launch, so the tests can force either path.
SHARED_BUDGET = 32768


def shared_bytes(scene, bvh) -> int:
    """Bytes of shared memory K6's shared path stages for ``bvh`` over
    ``scene``: 32 a node, and a leaf slot 16 (a scene without triangles)
    or 48 (with); ``frt_bvh_walk_shared_bytes`` in the kernel's source."""
    per_slot = 16 if scene.num_triangles == 0 else 48
    return 32 * bvh.num_nodes + per_slot * bvh.prim_ids.shape[0]


def walk_path(scene, bvh, budget=None) -> str:
    """The path K6 takes for ``bvh`` over ``scene`` under ``budget`` (by
    default ``SHARED_BUDGET``): ``"shared"`` or ``"global"``."""
    budget = SHARED_BUDGET if budget is None else budget
    return "shared" if shared_bytes(scene, bvh) <= budget else "global"


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
                        max_leaf: int = 4, return_counters: bool = False):
    """K6's plain version: the lockstep walk, one host read a step.

    ``max_leaf`` is the number of leaf slots tested per step (at least the
    builder's ``max_leaf``).  Returns ``(prim (R,) i32, t (R,) f32, hit
    (R,) bool)``, on the rays' device, and with ``return_counters=True``
    also the per-ray (R, 3) int32 counters of ``WALK_COLUMNS``: the steps
    a ray took while walking, and the sphere and triangle slots it tested.
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
    counts = torch.zeros((R, len(WALK_COLUMNS)), dtype=torch.int32,
                         device=dev)
    ns, nt = scene.num_spheres, scene.num_triangles
    while bool((node < n_nodes).any()):
        active = node < n_nodes
        counts[:, 0] += active
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
            sphere = (pid < ns) if ns and nt else torch.full_like(
                slot_ok, nt == 0)
            counts[:, 1] += slot_ok & sphere
            counts[:, 2] += slot_ok & ~sphere
            better = slot_ok & (t_k < t_best)
            t_best = torch.where(better, t_k, t_best)
            prim_best = torch.where(better, pid, prim_best)
        descend = box_ok & ~is_leaf
        nxt = torch.where(descend, nidx + 1, node_skip[nidx])
        node = torch.where(active, nxt, n_nodes)
    if return_counters:
        return prim_best, t_best, t_best < BIG, counts
    return prim_best, t_best, t_best < BIG


def _launch_cuda(scene, bvh, o, d, t_min, max_leaf, return_counters,
                 budget=None):
    """K6 over the rays ``o``, ``d`` ((R, 3) f32, contiguous): (prim, t,
    hit, counters or None), through the shared-memory path when
    ``walk_path`` says so under ``budget`` (by default ``SHARED_BUDGET``).
    Makes no host read and allocates through torch, so a CUDA graph can
    capture it."""
    from ..kernels import megakernel
    from ..kernels.megakernel import _check

    dev = bvh.device
    n, np_total = bvh.num_nodes, bvh.prim_ids.shape[0]
    ns, nt = scene.num_spheres, scene.num_triangles
    f32, i32 = torch.float32, torch.int32
    # Every array of the BVH, though K6 reads only its records and slots.
    for name, shape, dtype in (
            ("node_min", (n, 3), f32), ("node_max", (n, 3), f32),
            ("node_first", (n,), i32), ("node_count", (n,), i32),
            ("node_skip", (n,), i32), ("prim_ids", (np_total,), i32),
            ("nodes", (n, 8), i32)):
        _check(name, getattr(bvh, name), dtype, shape, dev)
    if bvh.nodes.data_ptr() % 16:
        raise ValueError("nodes is not 16-byte aligned")
    for name, shape in (("sphere_center", (ns, 3)), ("sphere_radius", (ns,)),
                        ("tri_v0", (nt, 3)), ("tri_v1", (nt, 3)),
                        ("tri_v2", (nt, 3))):
        _check(name, getattr(scene, name), f32, shape, dev)
    if max_leaf < 1:
        raise ValueError(f"max_leaf must be at least 1, not {max_leaf}")
    budget = SHARED_BUDGET if budget is None else budget
    R = o.shape[0]
    prim = torch.empty((R,), dtype=i32, device=dev)
    t = torch.empty((R,), dtype=f32, device=dev)
    hit = torch.empty((R,), dtype=torch.bool, device=dev)
    counters = (torch.empty((R, len(WALK_COLUMNS)), dtype=i32, device=dev)
                if return_counters else None)
    megakernel.launch_entry(
        dev, "frt_bvh_walk", o.data_ptr(), d.data_ptr(),
        bvh.nodes.data_ptr(), bvh.prim_ids.data_ptr(), n, np_total,
        scene.sphere_center.data_ptr(), scene.sphere_radius.data_ptr(), ns,
        scene.tri_v0.data_ptr(), scene.tri_v1.data_ptr(),
        scene.tri_v2.data_ptr(), nt, max_leaf, R, ctypes.c_float(t_min),
        min(budget, 2 ** 31 - 1), prim.data_ptr(), t.data_ptr(),
        hit.data_ptr(), None if counters is None else counters.data_ptr())
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
    ``return_counters=True`` (K6 only; ``intersect_bvh_plain`` counts on
    the CPU) also K6's per-ray (R, 3) int32 counters of ``WALK_COLUMNS``.
    """
    from ..kernels.intersect_pallas import check_rays

    dev = bvh.device
    if dev.type == "cpu":
        if return_counters:
            raise ValueError("intersect_bvh returns counters from K6 only: "
                             "call intersect_bvh_plain(..., "
                             "return_counters=True) on the CPU")
        return intersect_bvh_plain(scene, bvh, origin, direction, t_min,
                                   max_leaf)
    if dev.type != "cuda":
        raise ValueError(f"no BVH walk kernel for device {dev}")
    o, d = check_rays(origin, direction, dev)
    prim, t, hit, counters = _launch_cuda(scene, bvh, o, d, float(t_min),
                                          max_leaf, return_counters)
    return (prim, t, hit, counters) if return_counters else (prim, t, hit)


intersect_bvh.launches = 0  # K6 launches (CUDA path only)
