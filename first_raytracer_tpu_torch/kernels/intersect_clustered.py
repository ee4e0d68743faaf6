"""SAH clustering of one primitive type, on the host.

Port of the host side of ``first_raytracer_tpu.kernels.intersect_clustered``
(``_cluster_type``), copied as it is: its NumPy decides
which primitives share a cluster and in which order, so it also decides the
column order of the clustered pack and, through it, which primitive wins an
exact tie.  The clustered megakernel's pack (``megakernel_clustered.py``)
builds on it.  The wavefront intersector over these clusters (the JAX
package's two-level Pallas kernel) is not part of this module.
"""
from __future__ import annotations

import sys

import numpy as np

__all__ = []


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
