"""Stackless flat-BVH walk in plain PyTorch.

Port of ``first_raytracer_tpu.accel.traverse``.  Every ray walks the
preorder node array in lockstep: a box hit on an inner node steps to
``node + 1`` (the left child), a box miss or a finished leaf jumps to
``skip[node]``; ``t_best`` shrinks the slab interval as hits accumulate.
Leaf slots are tested one per step up to ``max_leaf``; a mixed scene tests
both primitive types per slot and selects.  A slot replaces the winner only
at a strictly smaller t, in walk order.

It was never a TPU kernel and is no performance path here either (one host
sync and a dozen small launches per step of the walk): it is the
traversal-correctness oracle, held against the brute-force sweep and
against JAX's walk.  It returns ``(prim, t, hit)`` only; the integrator
recomputes the hit record from the id.
"""
from __future__ import annotations

import torch

from ..geometry.aabb import aabb_hit
from ..geometry.sphere import BIG, sphere_hit_one
from ..geometry.triangle import triangle_hit_one

__all__ = ["prim_hit_one", "intersect_bvh"]


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
def intersect_bvh(scene, bvh, origin, direction, t_min, max_leaf: int = 4):
    """Closest hit via the flat BVH; the contract of ``intersect_brute``.

    ``max_leaf`` is the number of leaf slots tested per step (at least the
    builder's ``max_leaf``).  Returns ``(prim (R,) i32, t (R,) f32, hit
    (R,) bool)``.
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
