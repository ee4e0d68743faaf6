"""Clustered megakernel render (K3): the whole forward path tracer for large
scenes, culling clusters of primitives inside the bounce loop.

Port of ``first_raytracer_tpu.kernels.megakernel_clustered``.  The host
(``pack_scene_mega_clustered``, NumPy copied from the JAX package)
SAH-partitions each primitive type into clusters of at most 128 slots,
groups up to 8 clusters under a supergroup box, and lays the payload out
cluster-major, so a cluster's primitives are one run of 128 columns.  On a
CUDA device ``render_pixels_mega_clustered`` launches the hand-written
kernel in ``csrc/megakernel_clustered.cu``: its warps trace the pixels'
samples to termination as K1's do, but each segment walks the supergroups
in pack order, every lane slab-tests each box against its ray's current
best t, and the warp sweeps together each cluster that any of its lanes
may hit.  The winner is the
lexicographic minimum of (t, column in the pack) per type, and a sphere
wins a sphere/triangle tie, so the result does not depend on which gates
fire.  On the CPU it runs ``render_pixels_mega_clustered_reference``, which
sweeps every column with no gates and shades with K1's plain code; a tensor
on any other device is refused and nothing falls back.

Left out on purpose: the JAX kernel's TPU schedule (band, stride and rect
pixel mappings, flush blocks, gate words and their two rounds, one-hot
extraction), its ``adj`` gate (a recorded negative result) and the
``grid_*`` and ``phase1_margin`` pack fields that only those use.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng
from ..geometry.aabb import sphere_aabb_np
from .intersect_clustered import _SUPER_FANOUT, _cluster_type, _span_boxes
from .megakernel import (BIG, TRI_ROWS, _check, _extent, _merge_surface,
                         _sharded_image, _sweep, camera_table,
                         render_reference)

__all__ = ["MegaClusteredPack", "ClusterLayout", "pack_scene_mega_clustered",
           "render_pixels_mega_clustered",
           "render_pixels_mega_clustered_reference",
           "render_image_mega_clustered",
           "render_image_mega_clustered_sharded", "SWEEP_COLUMNS"]

REPLACES = "first_raytracer_tpu/kernels/megakernel_clustered.py:532"
_LANE = 128           # cluster slot capacity
_SPH_ROWS = 16
# Sphere payload rows (cluster-major columns): 0-2 center, 3 radius, 4 param
# (fuzz | ref_idx), 5-7 albedo, 8-10 albedo2, 11 tex_scale, 12 original
# scene index, 13 material type (0/1/2), 14 texture type (0/1), 15
# 1/radius.  Triangle rows are the dense pack's (0-20) plus 21 material
# type and 22 texture type: SAH order destroys the dense pack's group sort.
# Per-pixel (or per-ray) counters of ``return_iters``: clusters swept
# (spheres and triangles), sphere slots and triangle slots tested, and
# supergroup and cluster boxes slab-tested, each counted per ray; then, for
# each warp (K3: at the first pixel of the first group of 32 pixels it
# took; K3t: at its first ray) and 0 elsewhere, the clusters the warp
# swept (each once, however many of its rays needed it) and the warp's
# segment steps.
SWEEP_COLUMNS = ("clusters", "sphere_slots", "triangle_slots", "box_tests",
                 "warp_clusters", "warp_steps")


@dataclasses.dataclass(frozen=True)
class MegaClusteredPack:
    """Host-packed clustered scene, tensors on one device.

    The first fourteen fields are the JAX pack's.  ``sph_starts`` and
    ``tri_starts`` (supergroups + 1,) int32 hold each supergroup's first
    cluster and then the cluster count (the spans as the kernel reads
    them); ``sph_counts`` and ``tri_counts`` (clusters,) int32 the members
    of each cluster, which fill its first columns.
    """

    sph: torch.Tensor          # (16, KC*128) f32 payload, cluster-major
    sph_mx: torch.Tensor       # (KC*128, 8) f32: cx cy cz c0, cx cy cz r
    boxes: torch.Tensor        # (KC, 8) f32: mnx mny mnz mxx mxy mxz pad
    super_boxes: torch.Tensor  # (KS, 8) f32
    super_spans: tuple         # (start, end) cluster spans per supergroup
    tris: torch.Tensor         # (24, KT*128) f32
    tri_boxes: torch.Tensor    # (KT, 8) f32
    tri_super_boxes: torch.Tensor  # (KTS, 8) f32
    tri_super_spans: tuple
    clusters: int              # KC
    tri_clusters: int          # KT
    sphere_rows: int           # true Ns
    tri_rows: int              # true Nt
    has_checker: bool
    sph_starts: torch.Tensor   # (KS + 1,) i32
    sph_counts: torch.Tensor   # (KC,) i32
    tri_starts: torch.Tensor   # (KTS + 1,) i32
    tri_counts: torch.Tensor   # (KT,) i32

    @property
    def device(self) -> torch.device:
        return self.sph.device

    @property
    def sweep_columns(self) -> int:
        """Columns the plain version's ungated sweep visits per ray."""
        return ((self.sph_mx.shape[0] if self.sphere_rows else 0)
                + (self.tris.shape[1] if self.tri_rows else 0))

    def closest_hit(self, o, d, t_min):
        """Every column of the pack, no gates: the lexicographic minimum of
        (t, column) per type; sentinel columns never hit."""
        return _sweep(self.sph_mx if self.sphere_rows else None,
                      self.tris if self.tri_rows else None, o, d, t_min)

    def winner_ids(self, w_s, w_t, is_tri):
        """Original scene ids of the winners (payload rows 12 and 20)."""
        return torch.where(is_tri, self.tris[20, w_t], self.sph[12, w_s])

    def surface(self, p, w_s, w_t, is_tri):
        """As ``MegaScenePack.surface``; the material and texture types
        come from payload rows (13, 14) and (21, 22)."""
        srow = self.sph[:, w_s]
        trow = self.tris[:, w_t]
        types_s = (srow[13] == 1.0, srow[13] == 2.0, srow[14] == 1.0)
        types_t = (trow[21] == 1.0, trow[21] == 2.0, trow[22] == 1.0)
        return _merge_surface(srow, trow, p, is_tri, types_s, types_t)


@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """Frozen clustering decisions, for repacks of a moving scene.

    ``make_fit_step_replay`` repacks the scene every optimizer step; a
    layout captured at the first pack keeps the cluster memberships and
    supergroup spans, so the column order (and with it the tie rule) stays
    put, while boxes and payload tables are recomputed from the current
    geometry on every repack: a stale box could let a slab gate cull a real
    hit.
    """

    sph_slots: tuple          # tuple of int tuples (cluster memberships)
    super_spans: tuple
    tri_slots: tuple
    tri_super_spans: tuple


def _group_clusters(boxes, slot_ids, sort_from):
    """Spatial supergroups of <= ``_SUPER_FANOUT`` clusters.

    Returns (slot_ids, spans) with clusters reordered supergroup-major:
    supers sorted front-to-back from ``sort_from``, children keeping
    their camera order.  Small cluster counts stay singleton spans.
    """
    kc = len(slot_ids)
    spans = tuple((k, k + 1) for k in range(kc))
    if kc <= 16:
        return slot_ids, spans
    sb, sgroups = _cluster_type(boxes[:, 0:3].astype(np.float64),
                                boxes[:, 3:6].astype(np.float64),
                                np.arange(kc), _SUPER_FANOUT)
    sgroups = [np.sort(g) for g in sgroups]  # keep camera order
    if sort_from is not None:
        scn = 0.5 * (sb[:, 0:3] + sb[:, 3:6])
        sd2 = ((scn - np.asarray(sort_from, np.float32)) ** 2).sum(1)
        sorder = np.argsort(sd2, kind="stable")
        sgroups = [sgroups[i] for i in sorder]
    slot_ids = [slot_ids[i] for i in np.concatenate(sgroups)]
    spans, off = [], 0
    for g in sgroups:
        spans.append((off, off + len(g)))
        off += len(g)
    return slot_ids, tuple(spans)


def _member_boxes(bmin, bmax, slot_ids):
    """Per-cluster AABBs from current member geometry."""
    boxes = np.zeros((len(slot_ids), 8), np.float32)
    for k, gids in enumerate(slot_ids):
        boxes[k, 0:3] = bmin[gids].min(axis=0)
        boxes[k, 3:6] = bmax[gids].max(axis=0)
    return boxes


def _starts(spans, k):
    """(len(spans) + 1,) first cluster of each span, then ``k``; the spans
    must cover clusters 0 .. k-1 in order, as ``_group_clusters`` makes
    them."""
    starts = [a for a, _ in spans] + [k]
    if any(b != starts[i + 1] for i, (_, b) in enumerate(spans)) or \
            starts[0] != 0:
        raise ValueError(f"supergroup spans {spans} do not cover the "
                         f"{k} clusters in order")
    return np.asarray(starts, np.int32)


def _sentinel_rows(cols):
    """(cols, 8) sphere rows that never hit: the JAX kernel's (BIG, BIG,
    BIG, c0 = +inf), then the sphere root's radius NaN."""
    mx = np.zeros((cols, 8), np.float32)
    mx[:, 0:3] = BIG
    mx[:, 3] = np.float32(np.inf)
    mx[:, 7] = np.float32(np.nan)
    return mx


def pack_scene_mega_clustered(scene, camera, layout: ClusterLayout = None,
                              return_layout: bool = False, device=None):
    """SAH-cluster and repack the scene (host), tables on ``device`` (by
    default the scene's).

    Clusters and supergroups are ordered by box-center distance from the
    camera origin, so the kernel visits near clusters first and the best-t
    bound prunes far ones.  ``layout`` (from an earlier
    ``return_layout=True`` call on the same scene topology) reuses the
    frozen clustering decisions; boxes and payload are always recomputed
    from the current geometry.
    """
    return _pack(scene, camera.origin.detach().cpu().numpy(), layout,
                 return_layout, device)


def _pack(scene, sort_from, layout=None, return_layout=False, device=None):
    """``pack_scene_mega_clustered`` with the sort origin as a 3-vector;
    ``sort_from=None`` keeps the SAH preorder (the JAX pack's default)."""
    if device is None:
        device = getattr(scene, "device", "cpu")
    s = scene.as_numpy() if hasattr(scene, "as_numpy") else scene
    ns, nt = s.sphere_center.shape[0], s.tri_v0.shape[0]
    mtype_all = np.asarray(s.mat_type, np.int64)
    textype_all = np.asarray(s.tex_type, np.int64)
    has_checker = bool((textype_all == 1).any())

    def mat_rows(mat_ids):
        m = np.asarray(mat_ids)
        mt = mtype_all[m]
        param = np.where(
            mt == 1, np.asarray(s.fuzz, np.float32)[m],
            np.where(mt == 2, np.asarray(s.ref_idx, np.float32)[m],
                     np.float32(1.0)))
        return np.stack([
            param.astype(np.float32),
            *(np.asarray(s.albedo, np.float32)[m, k] for k in range(3)),
            *(np.asarray(s.albedo2, np.float32)[m, k] for k in range(3)),
            np.asarray(s.tex_scale, np.float32)[m],
        ])  # (8, N)

    # --- spheres: SAH clusters, cluster-major columns ---
    kc = 1
    sph = np.zeros((_SPH_ROWS, _LANE), np.float32)
    sph[0:3] = BIG
    sph[12] = np.float32(BIG)
    mx = _sentinel_rows(_LANE)
    boxes_np = np.zeros((1, 8), np.float32)
    boxes_np[:, 0:3] = BIG
    boxes_np[:, 3:6] = -BIG
    super_spans = ((0, 1),)
    sboxes_np = boxes_np
    slot_ids = []
    if ns:
        bmin, bmax = sphere_aabb_np(s.sphere_center, s.sphere_radius)
        if layout is not None:
            slot_ids = [np.asarray(t, np.int64) for t in layout.sph_slots]
            super_spans = layout.super_spans
        else:
            boxes0, slot_ids = _cluster_type(bmin, bmax, np.arange(ns),
                                             _LANE)
            if sort_from is not None:
                centers = 0.5 * (boxes0[:, 0:3] + boxes0[:, 3:6])
                d2 = ((centers - np.asarray(sort_from, np.float32))
                      ** 2).sum(1)
                order = np.argsort(d2, kind="stable")
                boxes0 = boxes0[order]
                slot_ids = [slot_ids[k] for k in order]
            slot_ids, super_spans = _group_clusters(boxes0, slot_ids,
                                                    sort_from)
        kc = len(slot_ids)
        boxes = _member_boxes(bmin, bmax, slot_ids)
        sboxes_np = _span_boxes(boxes, super_spans)
        cols = kc * _LANE
        sph = np.zeros((_SPH_ROWS, cols), np.float32)
        sph[0:3] = BIG                      # sentinel slots: never hit
        sph[12] = np.float32(BIG)
        mx = _sentinel_rows(cols)
        boxes_np = np.asarray(boxes, np.float32)
        c_all = np.asarray(s.sphere_center, np.float32)
        r_all = np.asarray(s.sphere_radius, np.float32)
        for k, gids in enumerate(slot_ids):
            m = len(gids)
            j0 = k * _LANE
            c = c_all[gids]
            r = r_all[gids]
            sph[0:3, j0:j0 + m] = c.T
            sph[3, j0:j0 + m] = r
            sph[4:12, j0:j0 + m] = mat_rows(np.asarray(s.sphere_mat)[gids])
            # |C|^2 - r^2 in f64: exact for the huge ground sphere.
            c64 = c.astype(np.float64)
            c0 = ((c64 * c64).sum(1)
                  - r.astype(np.float64) ** 2).astype(np.float32)
            sph[12, j0:j0 + m] = np.asarray(gids, np.float32)  # orig ids
            sph[13, j0:j0 + m] = mtype_all[
                np.asarray(s.sphere_mat)[gids]].astype(np.float32)
            sph[14, j0:j0 + m] = textype_all[
                np.asarray(s.sphere_mat)[gids]].astype(np.float32)
            sph[15, j0:j0 + m] = np.where(r != 0, 1.0 / np.where(r != 0, r,
                                                                 1.0), 0.0)
            mx[j0:j0 + m, 0:3] = c
            mx[j0:j0 + m, 3] = c0
            mx[j0:j0 + m, 4:7] = c
            mx[j0:j0 + m, 7] = r

    # --- triangles: SAH clusters, cluster-major columns ---
    # Zero sentinel columns have det == 0: never hit.
    tri = np.zeros((TRI_ROWS, _LANE), np.float32)
    kt = 1
    tboxes_np = np.zeros((1, 8), np.float32)
    tboxes_np[:, 0:3] = BIG
    tboxes_np[:, 3:6] = -BIG
    tri_super_spans = ((0, 1),)
    tsboxes_np = tboxes_np
    t_slots = []
    if nt:
        v0a = np.asarray(s.tri_v0, np.float64)
        v1a = np.asarray(s.tri_v1, np.float64)
        v2a = np.asarray(s.tri_v2, np.float64)
        tbmin = np.minimum(np.minimum(v0a, v1a), v2a)
        tbmax = np.maximum(np.maximum(v0a, v1a), v2a)
        if layout is not None:
            t_slots = [np.asarray(t, np.int64) for t in layout.tri_slots]
            tri_super_spans = layout.tri_super_spans
        else:
            tboxes0, t_slots = _cluster_type(tbmin, tbmax, np.arange(nt),
                                             _LANE)
            if sort_from is not None:
                tcent = 0.5 * (tboxes0[:, 0:3] + tboxes0[:, 3:6])
                td2 = ((tcent - np.asarray(sort_from, np.float32))
                       ** 2).sum(1)
                torder = np.argsort(td2, kind="stable")
                tboxes0 = tboxes0[torder]
                t_slots = [t_slots[i] for i in torder]
            t_slots, tri_super_spans = _group_clusters(tboxes0, t_slots,
                                                       sort_from)
        kt = len(t_slots)
        tboxes_np = _member_boxes(tbmin, tbmax, t_slots)
        tsboxes_np = _span_boxes(tboxes_np, tri_super_spans)
        tri = np.zeros((TRI_ROWS, kt * _LANE), np.float32)
        tm_all = np.asarray(s.tri_mat, np.int64)
        for k, gids in enumerate(t_slots):
            m = len(gids)
            j0 = k * _LANE
            v0 = v0a[gids].astype(np.float32)
            e1 = (v1a[gids] - v0a[gids]).astype(np.float32)
            e2 = (v2a[gids] - v0a[gids]).astype(np.float32)
            n = np.cross(e1, e2)
            nn = np.linalg.norm(n, axis=1, keepdims=True)
            n = n / np.where(nn > 0, nn, 1.0)
            tri[0:3, j0:j0 + m] = v0.T
            tri[3:6, j0:j0 + m] = e1.T
            tri[6:9, j0:j0 + m] = e2.T
            tri[9:12, j0:j0 + m] = n.T
            tri[12:20, j0:j0 + m] = mat_rows(tm_all[gids])
            # Row 20: global original id (ns + triangle index).
            tri[20, j0:j0 + m] = (ns + gids).astype(np.float32)
            tri[21, j0:j0 + m] = mtype_all[tm_all[gids]].astype(
                np.float32)
            tri[22, j0:j0 + m] = textype_all[tm_all[gids]].astype(
                np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def counts(slots, k):
        return np.asarray([len(g) for g in slots] or [0] * k, np.int32)

    pack = MegaClusteredPack(
        sph=dev(sph), sph_mx=dev(mx), boxes=dev(boxes_np),
        super_boxes=dev(sboxes_np), super_spans=super_spans,
        tris=dev(tri), tri_boxes=dev(tboxes_np),
        tri_super_boxes=dev(tsboxes_np), tri_super_spans=tri_super_spans,
        clusters=kc, tri_clusters=kt, sphere_rows=ns, tri_rows=nt,
        has_checker=has_checker,
        sph_starts=dev(_starts(super_spans, kc)),
        sph_counts=dev(counts(slot_ids, kc)),
        tri_starts=dev(_starts(tri_super_spans, kt)),
        tri_counts=dev(counts(t_slots, kt)))
    if not return_layout:
        return pack
    layout_out = layout if layout is not None else ClusterLayout(
        sph_slots=tuple(tuple(int(i) for i in g) for g in slot_ids),
        super_spans=super_spans,
        tri_slots=tuple(tuple(int(i) for i in g) for g in t_slots),
        tri_super_spans=tri_super_spans)
    return pack, layout_out


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def check_clustered_pack(pack, cam):
    """The wrappers' checks of the camera row and the clustered tables."""
    dev = pack.device
    f32, i32 = torch.float32, torch.int32
    kc, kt = pack.clusters, pack.tri_clusters
    ks, kts = len(pack.super_spans), len(pack.tri_super_spans)
    _check("camera", cam, f32, (20,), dev)
    _check("sph", pack.sph, f32, (_SPH_ROWS, kc * _LANE), dev)
    _check("sph_mx", pack.sph_mx, f32, (kc * _LANE, 8), dev)
    _check("boxes", pack.boxes, f32, (kc, 8), dev)
    _check("super_boxes", pack.super_boxes, f32, (ks, 8), dev)
    _check("sph_starts", pack.sph_starts, i32, (ks + 1,), dev)
    _check("sph_counts", pack.sph_counts, i32, (kc,), dev)
    _check("tris", pack.tris, f32, (TRI_ROWS, kt * _LANE), dev)
    _check("tri_boxes", pack.tri_boxes, f32, (kt, 8), dev)
    _check("tri_super_boxes", pack.tri_super_boxes, f32, (kts, 8), dev)
    _check("tri_starts", pack.tri_starts, i32, (kts + 1,), dev)
    _check("tri_counts", pack.tri_counts, i32, (kt,), dev)


def table_args(pack, cam):
    """The tables' part of the C entry points' arguments."""
    return (cam.data_ptr(), pack.sph.data_ptr(), pack.sph_mx.data_ptr(),
            pack.boxes.data_ptr(), pack.super_boxes.data_ptr(),
            pack.sph_starts.data_ptr(), pack.sph_counts.data_ptr(),
            pack.tris.data_ptr(), pack.tri_boxes.data_ptr(),
            pack.tri_super_boxes.data_ptr(), pack.tri_starts.data_ptr(),
            pack.tri_counts.data_ptr(), pack.sphere_rows, pack.tri_rows,
            len(pack.super_spans), len(pack.tri_super_spans),
            pack.sph.shape[1], pack.tris.shape[1])


def _launch_cuda(pack, cam, cfg, key, pix0=0, num_pixels=None):
    """Launch K3 on the current stream over ``num_pixels`` pixels from
    ``pix0`` (the rest of the image by default); returns (rad (P, 3), segs
    (P,), sweeps (P, 6)), P = ``num_pixels``."""
    from . import megakernel

    dev = pack.device
    check_clustered_pack(pack, cam)
    P, _, _ = _extent(cfg, pix0, num_pixels, None)
    rad = torch.empty((P, 3), dtype=torch.float32, device=dev)
    segs = torch.empty((P,), dtype=torch.int32, device=dev)
    sweeps = torch.empty((P, len(SWEEP_COLUMNS)), dtype=torch.int32,
                         device=dev)
    work = torch.empty((1,), dtype=torch.int32, device=dev)  # its counter
    k0, k1 = rng.key_words(key)
    megakernel.launch_entry(
        dev, "frt_mega_clustered_render", *table_args(pack, cam), k0, k1,
        cfg.nx, cfg.ny, cfg.spp, pix0, P, cfg.max_depth, float(cfg.t_min),
        rad.data_ptr(), segs.data_ptr(), sweeps.data_ptr(), work.data_ptr())
    render_pixels_mega_clustered.launches += 1
    return rad, segs, sweeps


def check_clustered_guards(pack, cfg):
    """The JAX kernel's preconditions, kept so both accept the same input."""
    if not cfg.t_min > 0.0:
        raise ValueError("clustered megakernel requires t_min > 0, got "
                         f"{cfg.t_min}")
    if pack.sphere_rows + pack.tri_rows >= (1 << 24):
        raise ValueError("payload id rows are f32: < 2^24 primitives")


def render_pixels_mega_clustered(pack: MegaClusteredPack, camera, cfg, key,
                                 pix0: int = 0, num_pixels: int = None,
                                 return_iters: bool = False):
    """Per-pixel radiance sums and segment counts of a render.

    Returns ``(radiance_sum (P, 3) f32, segments (P,) i32)`` for the ``P =
    num_pixels`` pixels starting at global pixel ``pix0`` (the whole image
    by default, bottom row first); divide by ``cfg.spp`` for the mean.  A
    pixel's value does not depend on the range it is rendered in.  With
    ``return_iters=True`` also the per-pixel counters ``(P, 6)`` i32 of
    ``SWEEP_COLUMNS``: what the gated sweep of K3 did, or, for the plain
    version, what an ungated sweep does (every cluster of each present
    type per segment, no box tests).

    Runs K3 for CUDA tensors and the plain version for CPU tensors; the
    device is the pack's.  ``key`` is ``core.rng.base_key(seed)``.
    """
    num_pixels, _, _ = _extent(cfg, pix0, num_pixels, None)
    check_clustered_guards(pack, cfg)
    dev = pack.device
    if dev.type == "cpu":
        return render_pixels_mega_clustered_reference(
            pack, camera, cfg, key, pix0=pix0, num_pixels=num_pixels,
            return_iters=return_iters)
    if dev.type != "cuda":
        raise ValueError(f"no clustered megakernel for device {dev}")
    rad, segs, sweeps = _launch_cuda(pack, camera_table(camera).to(dev),
                                     cfg, key, pix0, num_pixels)
    return (rad, segs, sweeps) if return_iters else (rad, segs)


render_pixels_mega_clustered.launches = 0  # K3 launches (CUDA path only)


def ungated_sweeps(pack, segs):
    """(N, 6) ``SWEEP_COLUMNS`` counters of an ungated sweep for the
    per-pixel or per-ray segment counts ``segs``; no warps, so the warp
    columns are 0."""
    ns, nt = pack.sphere_rows, pack.tri_rows
    per_segment = torch.tensor(
        [(pack.clusters if ns else 0) + (pack.tri_clusters if nt else 0),
         ns, nt, 0, 0, 0], dtype=torch.int32, device=segs.device)
    return segs[:, None] * per_segment


def render_pixels_mega_clustered_reference(pack: MegaClusteredPack, camera,
                                           cfg, key, pix0: int = 0,
                                           num_pixels: int = None,
                                           return_iters: bool = False,
                                           rays_per_chunk: int = None):
    """K3's plain version: ``render_pixels_mega_clustered`` in plain
    PyTorch, over the same pixel range.  It sweeps every column of the
    clustered pack with no gates and takes the lowest column among equal
    t, so it checks the kernel's gates rather than repeating them; camera
    rays and shading are K1's plain code."""
    check_clustered_guards(pack, cfg)
    rad, segs = render_reference(pack, camera, cfg, key, pix0=pix0,
                                 num_pixels=num_pixels,
                                 rays_per_chunk=rays_per_chunk)
    if return_iters:
        return rad, segs, ungated_sweeps(pack, segs)
    return rad, segs


def render_image_mega_clustered(scene, camera, cfg, seed: int = 0,
                                device="cuda"):
    """Full-image clustered-megakernel render; (ny, nx, 3) linear, top row
    first.  Clusters are sorted front-to-back from the camera.  The scene
    and camera are moved to ``device``: the CUDA kernel runs on ``"cuda"``,
    its plain version on ``"cpu"``."""
    device = torch.device(device)
    pack = pack_scene_mega_clustered(scene, camera, device=device)
    rad, _ = render_pixels_mega_clustered(pack, camera.to(device), cfg,
                                          rng.base_key(seed))
    img = (rad / cfg.spp).reshape(cfg.ny, cfg.nx, 3)
    return img.flip(0)


def render_image_mega_clustered_sharded(scene, camera, cfg, mesh,
                                        seed: int = 0, device="cuda"):
    """Mesh-sharded clustered-megakernel render; (ny, nx, 3) on ``device``,
    top row first, the whole image on every rank.

    Data-parallel over the mesh's tile axis, as
    ``megakernel.render_image_mega_sharded``: each rank launches K3 over a
    contiguous range of ceil(P / tiles) pixels (the last range may run past
    the image; those pixels are not traced) and the ranges are gathered.
    The JAX package distributes its kernel by ranges of 2-D pixel tiles;
    this one has none, so its unit is the pixel range.  Every pixel is
    traced and summed as in the whole-frame launch, so the image is
    bit-identical to ``render_image_mega_clustered``'s.  Cluster tables
    and camera are replicated; the only collective is the all-gather.
    """
    from ..parallel.mesh import local_device

    device = local_device(device)
    return _sharded_image(render_pixels_mega_clustered,
                          pack_scene_mega_clustered(scene, camera,
                                                    device=device),
                          camera.to(device), cfg, mesh, seed)
