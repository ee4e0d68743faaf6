"""Host-side BVH construction into flat index arrays.

Port of ``first_raytracer_tpu.accel.build``; the NumPy builder is copied as
it is, so its arrays equal JAX's.  The tree becomes flat arrays in
depth-first preorder with skip links, so the walk (``accel/traverse.py``)
needs no stack:

- preorder: an inner node's left child is ``node + 1``;
- ``skip[node]``: the next preorder index after the node's whole subtree,
  where the walk jumps when the node's box is missed or a leaf is done;
- leaves own up to ``max_leaf`` primitives, contiguous in ``prim_ids``.

Split: the largest-extent centroid axis, at the sweep-SAH position (or the
median with ``use_sah=False``).  ``backend="native"`` builds the same
arrays with the C++ builder (``accel/native.py``).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..geometry.aabb import sphere_aabb_np, triangle_aabb_np

__all__ = ["FlatBVH", "build_bvh", "scene_prim_bounds"]


@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Flattened BVH, tensors on one device."""

    node_min: torch.Tensor    # (N, 3) f32 box min
    node_max: torch.Tensor    # (N, 3) f32 box max
    node_first: torch.Tensor  # (N,) i32: leaf: first slot in prim_ids; else 0
    node_count: torch.Tensor  # (N,) i32: leaf: primitives (> 0); else 0
    node_skip: torch.Tensor   # (N,) i32: preorder index after this subtree
    prim_ids: torch.Tensor    # (Np,) i32: permuted global primitive ids

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    @property
    def max_leaf(self) -> int:
        return int(self.node_count.max())

    @property
    def device(self) -> torch.device:
        return self.node_min.device

    def to(self, device) -> "FlatBVH":
        return FlatBVH(*(getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)))


def scene_prim_bounds(scene_np):
    """Per-primitive AABBs in global-id order (spheres then triangles)."""
    mins, maxs = [], []
    if scene_np.sphere_center.shape[0]:
        mn, mx = sphere_aabb_np(scene_np.sphere_center, scene_np.sphere_radius)
        mins.append(mn)
        maxs.append(mx)
    if scene_np.tri_v0.shape[0]:
        mn, mx = triangle_aabb_np(scene_np.tri_v0, scene_np.tri_v1,
                                  scene_np.tri_v2)
        mins.append(mn)
        maxs.append(mx)
    return np.concatenate(mins, 0), np.concatenate(maxs, 0)


def build_bvh(scene, max_leaf: int = 4, use_sah: bool = True,
              backend: str = "auto") -> FlatBVH:
    """Build the flat BVH of a Scene on the host (once per scene); the
    arrays land on the scene's device.

    backend: ``"numpy"``, ``"native"`` (the C++ builder, bit-identical
    output; raises if it cannot be built), or ``"auto"`` (native when it
    builds, else NumPy).
    """
    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    bmin, bmax = scene_prim_bounds(scene.as_numpy())

    def flat(*arrays):
        return FlatBVH(*(torch.from_numpy(np.ascontiguousarray(a)).to(
            scene.device) for a in arrays))

    if backend != "numpy":
        from . import native
        if native.available():
            return flat(*native.build_bvh_native_arrays(bmin, bmax, max_leaf,
                                                        use_sah))
        if backend == "native":
            raise RuntimeError(f"native builder unavailable: {native.error()}")
    return flat(*_build_numpy(bmin, bmax, max_leaf, use_sah))


def _build_numpy(bmin, bmax, max_leaf, use_sah):
    """The six flat arrays of the NumPy builder."""
    n = bmin.shape[0]
    centroid = 0.5 * (bmin + bmax)

    # Recursive build into a temporary node list of
    # (box_min, box_max, leaf_ids | (left, right)) then preorder-flatten.
    class Node:
        __slots__ = ("mn", "mx", "ids", "left", "right", "_index", "_first")

    def make(ids):
        nd = Node()
        nd.mn = bmin[ids].min(axis=0)
        nd.mx = bmax[ids].max(axis=0)
        nd.ids = None
        nd.left = nd.right = None
        if len(ids) <= max_leaf:
            nd.ids = ids
            return nd
        ext = centroid[ids].max(axis=0) - centroid[ids].min(axis=0)
        axis = int(np.argmax(ext))
        order = ids[np.argsort(centroid[ids, axis], kind="stable")]
        split = _sah_split(order) if use_sah else len(order) // 2
        split = min(max(split, 1), len(order) - 1)
        nd.left = make(order[:split])
        nd.right = make(order[split:])
        return nd

    def _sah_split(order):
        """Sweep-SAH over the sorted order; O(k) with prefix boxes."""
        k = len(order)
        lmn = np.minimum.accumulate(bmin[order], axis=0)
        lmx = np.maximum.accumulate(bmax[order], axis=0)
        rmn = np.minimum.accumulate(bmin[order][::-1], axis=0)[::-1]
        rmx = np.maximum.accumulate(bmax[order][::-1], axis=0)[::-1]

        def area(mn, mx):
            e = np.maximum(mx - mn, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        i = np.arange(1, k)
        cost = area(lmn, lmx)[:-1] * i + area(rmn, rmx)[1:] * (k - i)
        return int(np.argmin(cost)) + 1

    nodes = []
    prim_perm = []

    def emit(nd):
        nd._index = len(nodes)
        nodes.append(nd)
        if nd.ids is not None:
            nd._first = len(prim_perm)
            prim_perm.extend(nd.ids.tolist())
        else:
            emit(nd.left)
            emit(nd.right)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 64))
    try:
        root = make(np.arange(n, dtype=np.int64))
        emit(root)

        n_nodes = len(nodes)
        node_min = np.stack([nd.mn for nd in nodes]).astype(np.float32)
        node_max = np.stack([nd.mx for nd in nodes]).astype(np.float32)
        node_first = np.zeros(n_nodes, np.int32)
        node_count = np.zeros(n_nodes, np.int32)
        node_skip = np.zeros(n_nodes, np.int32)

        def fill_skip(nd, skip):
            node_skip[nd._index] = skip
            if nd.ids is not None:
                node_first[nd._index] = nd._first
                node_count[nd._index] = len(nd.ids)
            else:
                fill_skip(nd.left, nd.right._index)
                fill_skip(nd.right, skip)

        fill_skip(root, n_nodes)
    finally:
        sys.setrecursionlimit(old_limit)
    return (node_min, node_max, node_first, node_count, node_skip,
            np.asarray(prim_perm, np.int32))
