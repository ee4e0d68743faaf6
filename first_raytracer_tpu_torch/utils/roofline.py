"""One count of the kernels' work: FP32 operations and bytes, and the
least time an H100 could take for them.

``chip_smoke.py`` prints its bounds from these counts and ``bench.py``
guards its measured rates with them, so the two can never count
differently.  The operations are counted from the CUDA sources:

- K1, K2, K2b (``kernels/csrc/mega_common.cuh``): 20 FP32 operations per
  (segment, sphere) and 46 per (segment, triangle) that every sweep step
  does (``sphere_group``'s float prefilter: 3 + 5 + 5 + 1 + 1 + 2 + 1 + 1
  + 1 for a sphere; ``triangle_hit``: 9 + 5 + 1 + 3 + 6 + 9 + 6 + 6 + 1 for
  a triangle).  The float64 root of the spheres past the prefilter,
  shading and Threefry are left out, so a bound is a lower one.
- K3, K3t: the slots and boxes their ``SWEEP_COLUMNS`` counters say they
  tested, 29 operations per box (``ClusterScene::gate`` in
  ``kernels/csrc/megakernel_clustered.cu``: 6 subtractions and 6
  multiplications, 10 minima and maxima, 4 for the widening, 3 for the
  test).
- K4, K5 (``kernels/csrc/intersect.cu``): 16 per (ray, sphere), the
  oc-form quadratic on (cx, cy, cz, r*r) (3 + 5 + 6 + 2), and the dense
  sweep's 46 per (ray, triangle) on (v0, e1, e2); r*r and the edges are
  computed once per primitive, when K4 stages a tile or the host packs
  K5's rows.  K5 adds 29 per box, supergroup or cluster, its counters say
  it tested.
- K6 (``kernels/csrc/bvh_walk.cu``): the nodes and slots its counters say
  it tested: 25 per node (``box_hit``: 6 subtractions, 6 multiplications,
  6 minima and maxima per axis, 3 maxima for the near end and 3 minima for
  the far end, 1 test), 20 per sphere slot (the oc-form quadratic with r*r
  computed, 3 + 5 + 6 + 1 + 2, then the square root and the two roots, 3)
  and 52 per triangle slot (the 46 above and the two edges, 6).
- K7 (``kernels/csrc/rng_rays.cu``, ``mega_common.cuh::draws4``): 164
  integer operations a ray, two Threefry-2x32-20 calls of 79 (the third
  key word's 2 xors, 2 key additions, 20 rounds of an add, a rotate as one
  funnel shift and an xor, 5 injections of 3 additions), the two counters
  (2) and the four words' shifts (4), counted at the INT32 rate
  (``PEAK_INT32``: 64 lanes an SM); and 8 FP32 operations (the four
  conversions and scalings to floats).  K8 adds 63 FP32 operations a ray
  past the draw: the pixel's floor divisions and modulo (6), the jitter (2
  conversions, 2 additions, 2 divisions), the lens sample (a square root,
  a multiply, a sine, a cosine, 2 multiplies, 2 by the radius, 2
  conversions to the camera's type), 10 a component for the offset, origin
  and direction (30) and the normalization (11); a transcendental or a
  64-bit division counts as one, so the bound is a lower one.  Both are
  bound by their integer operations, by 3% over their bytes (0.00129
  against 0.00125 ms at 2^17 rays; a rotate counted as three operations
  would make it 0.0019): K7 reads an 8-byte id (and an 8-byte domain
  where it has one a ray) and writes 16 bytes, K8 reads the id and writes
  six floats of the camera's type.
- K9 (``kernels/csrc/wavefront_pass.cu``, the pass's shading and, in
  pool mode, its compaction): for each live slot, K7's 164 integer and 8
  FP32 operations of the draw and the 60 FP32 operations of the cheapest
  path through the shading (a sphere's recompute 37, the ball sample 12
  with its power and its sine and cosine one each, a lambertian scatter
  11); a triangle, a metal or a dielectric takes more, so the bound is a
  lower one.  A dead slot needs no operation.  Bytes: every slot's state
  and closest hit read, live or dead (K9 reads them in one step, before
  it knows); a live slot's segment count read and written and, on a miss,
  its output row read and written; pool mode writes a survivor's next
  state to its compacted slot (53 bytes), each tile's status word twice
  and reads it once, takes a ticket and writes the pass record; trip mode
  writes a live ray's liveness and the carry of each ray that goes on
  (36); the scene's tensors read once a launch.  Bound by bytes.
- K10 (the pool's regeneration): a tail slot's camera ray is K8's (164
  integer and 71 FP32 operations); bytes: a tail slot's state written
  (53), the pass record, key, camera and first id read and the cursor
  written once a launch.  Bound by bytes.
- K11 (``kernels/csrc/dense_hit.cu``, the dense closest hit on the
  scene's tensors): K4's 16 per (ray, sphere) and 46 per (ray, triangle)
  of the live rays it sweeps (a dead ray is not swept), r*r and the edges
  computed once per primitive when a block stages its tile (the square
  root and the two roots past a positive discriminant left out: a lower
  bound); bytes: the scene's centres, radii and vertices read once a
  launch, 24 bytes in a live ray, the mask's byte and 9 bytes out every
  ray.  Bound by operations unless almost every ray is dead.
- K12 (the recorders' pass, ``wavefront_pass.cu``): K9's draw and shading
  operations for each ray or slot it shades; bytes counted as the inputs
  need them, not as a kernel might read them: a dead ray or slot needs its
  liveness byte (and, in lockstep mode, its tape entry); lockstep and
  length modes read a live ray's rays, id and closest hit (37) and write
  its liveness (1), write a tape entry a ray (4, lockstep) or read and
  write a live ray's length (16, length mode), and a continuing ray's rays
  (24); pool mode reads a live slot's rays, id, column, depth and closest
  hit (53), writes a hit's tape entry (4) and a survivor's next state
  (49), with the scan's words, ticket and pass record, and refills the
  tail with K13, folded into the same launch: K10's operations for a tail
  slot's camera ray, its id read from the stream (8) and its state written
  (49).  Bound by bytes.
- K14 (``kernels/csrc/replay.cu``, the tape replay's forward): K9's draw
  and shading operations for each bounce it shades (a recorded id whose
  hit re-solves), and the sky's 8 for each miss; bytes as the inputs need
  them: a ray's camera ray, id and radiance (and, for a gradient, its end
  row: 4), a tape entry a row it visits, the scratch row (o, dr,
  throughput) of each visited row for a gradient, the payload tables once.
  Bound by bytes.
- K15 (the tape replay's backward): each bounce a ray sweeps back re-shaded
  as K14 shaded it, plus its adjoint, ``ADJOINT_OPS`` = 120 FP32
  operations on the cheapest path (a lambertian scatter's normalization 30,
  a sphere's recompute 85, the throughput 6); the sky's seed (20) a
  contributing ray.  Bytes: every ray's end row, a contributing ray's
  upstream gradient, id and its miss row's scratch (dr, throughput), each
  swept bounce's scratch row and tape entry, the tables read once and
  their gradients written once, and the float64 sum zeroed, added and
  read once (24 bytes a value).  Bound by bytes on the final scene.
"""
from __future__ import annotations

__all__ = ["PEAK_FP32", "PEAK_BYTES", "FP32_PEAKS", "SPHERE_OPS",
           "TRIANGLE_OPS", "BOX_OPS", "OC_SPHERE_OPS", "MT_TRIANGLE_OPS",
           "WALK_BOX_OPS", "WALK_SPHERE_OPS", "WALK_TRIANGLE_OPS",
           "dense_ops", "clustered_ops", "intersect_ops", "k5_ops",
           "k6_ops", "roofline", "bound", "clustered_bound",
           "intersect_bound", "tensor_bytes", "k4_bound", "k5_bound",
           "k6_bound", "fp32_peak", "PEAK_INT32", "THREEFRY_INT_OPS",
           "THREEFRY_FP32_OPS", "CAMERA_RAY_OPS", "SHADE_OPS", "k7_bound",
           "k8_bound", "k9_bound", "k10_bound", "k11_bound", "k12_bound",
           "ADJOINT_OPS", "k14_bound", "k15_bound"]

# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# INT32 operations a second outside the tensor cores: 132 SMs of 64 INT32
# lanes (half the FP32 lanes; the Hopper architecture white paper) at the
# SXM part's 1.98 GHz boost clock.
PEAK_INT32 = 132 * 64 * 1.98e9
# FP32 peak outside the tensor cores by ``torch.cuda.get_device_name``
# (NVIDIA's data sheets).  ``bench.py``'s plausibility guard reads it; a
# card missing here is an error there, never a guess.
FP32_PEAKS = {
    "NVIDIA H100 80GB HBM3": PEAK_FP32,  # SXM5
    "NVIDIA H100 PCIe": 51e12,
    "NVIDIA H100 NVL": 60e12,
}
SPHERE_OPS, TRIANGLE_OPS = 20, 46
BOX_OPS = 29
OC_SPHERE_OPS, MT_TRIANGLE_OPS = 16, 46
WALK_BOX_OPS, WALK_SPHERE_OPS, WALK_TRIANGLE_OPS = 25, 20, 52
THREEFRY_INT_OPS, THREEFRY_FP32_OPS, CAMERA_RAY_OPS = 164, 8, 63
SHADE_OPS = 60
ADJOINT_OPS = 120


def fp32_peak(name: str) -> float:
    """The FP32 peak of the card named ``name``; KeyError if the table
    does not hold it."""
    try:
        return FP32_PEAKS[name]
    except KeyError:
        raise KeyError(f"no FP32 peak for {name!r} in "
                       "utils/roofline.FP32_PEAKS") from None


def dense_ops(pack, segments):
    """FP32 operations of K1's (K2's, K2b's) sweep over ``segments``
    segments: every segment tests every row of the dense pack."""
    return segments * (pack.sphere_rows * SPHERE_OPS
                       + pack.tri_rows * TRIANGLE_OPS)


def clustered_ops(sweeps_total):
    """FP32 operations of K3's (K3t's) gated sweep from the sums of its
    ``SWEEP_COLUMNS`` counters: slots and boxes tested."""
    tot = [int(x) for x in sweeps_total]
    return tot[1] * SPHERE_OPS + tot[2] * TRIANGLE_OPS + tot[3] * BOX_OPS


def intersect_ops(pack, rays):
    """FP32 operations of K4 over ``rays`` rays of a dense pack."""
    return rays * (pack.sphere_rows * OC_SPHERE_OPS
                   + pack.tri_rows * MT_TRIANGLE_OPS)


def k5_ops(sweeps_total):
    """FP32 operations of K5 from the sums of its four ``SWEEP_COLUMNS``
    counters: slots and boxes tested."""
    tot = [int(x) for x in sweeps_total]
    return (tot[1] * OC_SPHERE_OPS + tot[2] * MT_TRIANGLE_OPS
            + tot[3] * BOX_OPS)


def k6_ops(walk_total):
    """FP32 operations of K6 from the sums of its three ``WALK_COLUMNS``
    counters: nodes, sphere slots and triangle slots tested."""
    nodes, spheres, triangles = (int(x) for x in walk_total)
    return (nodes * WALK_BOX_OPS + spheres * WALK_SPHERE_OPS
            + triangles * WALK_TRIANGLE_OPS)


def roofline(ops, nbytes, int_ops=0):
    """(ms, "operations" | "bytes"): the largest of ``ops`` FP32
    operations over the FP32 peak, ``int_ops`` integer operations over the
    INT32 peak (a pipe of its own) and ``nbytes`` over the memory rate."""
    t_ops = max(ops / PEAK_FP32, int_ops / PEAK_INT32)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(pack, segments, out_bytes):
    """The least time the card could take for a sweep of ``segments``
    segments over the dense pack: its FP32 operations against its bytes
    (tables and camera read once, outputs written once).  Returns (ms,
    "operations" | "bytes")."""
    in_bytes = 4 * (20 + pack.spheres.numel() + pack.sph_mx.numel()
                    + pack.tris.numel())
    return roofline(dense_ops(pack, segments), in_bytes + out_bytes)


def clustered_bound(pack, sweeps, out_bytes):
    """The least time for a clustered sweep that did what ``sweeps`` (N, 4+)
    counts: its FP32 operations (slots and boxes tested) against its bytes
    (tables and camera read once, outputs written once).  Returns (ms,
    "operations" | "bytes")."""
    tables = (pack.sph, pack.sph_mx, pack.boxes, pack.super_boxes,
              pack.sph_starts, pack.sph_counts, pack.tris, pack.tri_boxes,
              pack.tri_super_boxes, pack.tri_starts, pack.tri_counts)
    in_bytes = 4 * 20 + tensor_bytes(*tables)
    return roofline(clustered_ops(sweeps.long().sum(0).tolist()),
                    in_bytes + out_bytes)


def intersect_bound(ops, in_bytes, out_bytes):
    """(ms, "operations" | "bytes") of ``ops`` FP32 operations against the
    bytes read and written."""
    return roofline(ops, in_bytes + out_bytes)


def k4_bound(pack, rays, launches=1):
    """K4's bound over ``launches`` launches of ``rays`` rays in all: the
    table read once a launch, 24 bytes in and 8 out a ray."""
    return intersect_bound(intersect_ops(pack, rays),
                           launches * tensor_bytes(pack.spheres, pack.tris)
                           + 24 * rays, 8 * rays)


def k5_bound(pack, sweeps_total, rays, launches=1):
    """K5's bound from the slots and boxes its counters say it tested
    (``sweeps_total``: the four ``SWEEP_COLUMNS`` sums)."""
    tables = tensor_bytes(pack.sph_vec, pack.tri_vec, pack.sph_box,
                          pack.tri_box, pack.sph_super_box,
                          pack.tri_super_box, pack.sph_gid, pack.tri_gid,
                          pack.sph_count, pack.tri_count)
    return intersect_bound(k5_ops(sweeps_total),
                           launches * tables + 24 * rays, 8 * rays)


def k6_bound(scene, bvh, walk_total, rays, launches=1):
    """K6's bound from the nodes and slots its counters say it tested
    (``walk_total``: the three ``WALK_COLUMNS`` sums): the BVH's node
    records and slots and the scene's primitives read once a launch, 24
    bytes in and 9 out a ray (prim, t, hit)."""
    tables = tensor_bytes(bvh.nodes, bvh.prim_ids,
                          scene.sphere_center, scene.sphere_radius,
                          scene.tri_v0, scene.tri_v1, scene.tri_v2)
    return intersect_bound(k6_ops(walk_total), launches * tables + 24 * rays,
                           9 * rays)


def k7_bound(rays, domain_per_ray=False, launches=1):
    """K7's bound over ``launches`` launches of ``rays`` draws in all: the
    key read once a launch, an 8-byte id (and an 8-byte domain with
    ``domain_per_ray``) in and 16 bytes out a ray."""
    in_bytes = 16 * launches + (16 if domain_per_ray else 8) * rays
    return roofline(THREEFRY_FP32_OPS * rays, in_bytes + 16 * rays,
                    THREEFRY_INT_OPS * rays)


def k8_bound(rays, itemsize=4, launches=1):
    """K8's bound over ``launches`` launches of ``rays`` camera rays in
    all: the key and the camera's 19 values read once a launch, an 8-byte
    id in and the origin and direction (6 values of ``itemsize`` bytes)
    out a ray."""
    in_bytes = (16 + 19 * itemsize) * launches + 8 * rays
    return roofline((THREEFRY_FP32_OPS + CAMERA_RAY_OPS) * rays,
                    in_bytes + 6 * itemsize * rays, THREEFRY_INT_OPS * rays)


def scene_bytes(scene):
    """Bytes of the scene's tensors (K9 reads them once a launch)."""
    return tensor_bytes(scene.sphere_center, scene.sphere_radius,
                        scene.sphere_mat, scene.tri_v0, scene.tri_v1,
                        scene.tri_v2, scene.tri_mat, scene.mat_type,
                        scene.tex_type, scene.albedo, scene.albedo2,
                        scene.tex_scale, scene.fuzz, scene.ref_idx)


def k9_bound(scene, slots, live, cont, misses, pool=True, launches=1):
    """K9's bound over ``launches`` launches of ``slots`` slots in all, of
    which ``live`` were alive, ``cont`` went on and ``misses`` were live
    and missed.  Every slot reads its liveness (1 byte), ray and
    throughput (36), closest hit (5) and id (8); pool mode also its depth
    (8), trip mode its segment count (4).  A live slot reads and writes its
    segment count (8 in pool mode; 4 written in trip mode, with its
    liveness, 1) and, on a miss, its output row (24).  Pool mode writes a
    survivor's next state (53), each tile of 256 slots its status word
    twice and reads it once (24), takes a ticket (16) and writes the pass
    record from the cursor (24); trip mode writes the carry of a ray that
    goes on (36).  The scene is read once a launch, with the key and the
    first id or the depth.  Operations: the draw and the shading of each
    live slot."""
    if pool:
        nbytes = ((1 + 36 + 5 + 8 + 8) * slots + 8 * live + 53 * cont
                  + 24 * -(-slots // 256) + launches * (16 + 24))
    else:
        nbytes = (1 + 36 + 5 + 8 + 4) * slots + 5 * live + 36 * cont
    nbytes += 24 * misses + launches * (scene_bytes(scene) + 16 + 8)
    return roofline((THREEFRY_FP32_OPS + SHADE_OPS) * live, nbytes,
                    THREEFRY_INT_OPS * live)


def k10_bound(slots, survivors, launches=1):
    """K10's bound over ``launches`` launches of ``slots`` slots in all,
    ``survivors`` of them left as K9 compacted them and the rest given
    camera rays: a tail slot writes its state (53 bytes); the pass record
    (16), the key (16), the camera (19 floats) and the first id (8) are
    read and the cursor written (8) once a launch."""
    tail = slots - survivors
    nbytes = 53 * tail + launches * (16 + 16 + 76 + 8 + 8)
    return roofline((THREEFRY_FP32_OPS + CAMERA_RAY_OPS) * tail, nbytes,
                    THREEFRY_INT_OPS * tail)


def k11_bound(scene, rays, live=None, launches=1):
    """K11's bound over ``launches`` launches of ``rays`` rays in all, of
    which ``live`` were live and swept (None: no mask, every ray swept):
    the live rays' (ray, primitive) pairs tested, the scene's geometry read
    once a launch, a live ray's 24 bytes in, every ray's mask byte in (with
    a mask) and 9 bytes out (prim, t, hit)."""
    mask = 0 if live is None else rays
    live = rays if live is None else live
    ops = live * (scene.num_spheres * OC_SPHERE_OPS
                  + scene.num_triangles * MT_TRIANGLE_OPS)
    tables = tensor_bytes(scene.sphere_center, scene.sphere_radius,
                          scene.tri_v0, scene.tri_v1, scene.tri_v2)
    return intersect_bound(ops, launches * tables + 24 * live + mask,
                           9 * rays)


def k12_bound(scene, slots, live, cont, hits, mode="lockstep",
              launches=1, tile=256):
    """K12's bound over ``launches`` launches of ``slots`` rays or slots in
    all, of which ``live`` were shaded (alive, and within the depth cap in
    the lockstep modes), ``cont`` went on and ``hits`` were live and hit.
    ``mode``: "lockstep" (a tape entry a ray), "length" (a live ray's
    length read and written) or "pool" (a status word a ``tile`` of slots,
    and K13's refill of the tail, the slots that did not go on).  A dead
    ray or slot counts its liveness byte only (and its tape entry in
    lockstep mode).  The scene is read once a launch, with the key and the
    bounce counter or cursor.  Operations: the draw and the shading of each
    live ray or slot, and in pool mode a tail slot's draw and camera
    ray."""
    fp32 = (THREEFRY_FP32_OPS + SHADE_OPS) * live
    ints = THREEFRY_INT_OPS * live
    if mode == "pool":
        tail = slots - cont
        nbytes = (slots + 53 * live + 4 * hits + 49 * cont + 57 * tail
                  + 24 * -(-slots // tile) + launches * (16 + 24 + 76))
        fp32 += (THREEFRY_FP32_OPS + CAMERA_RAY_OPS) * tail
        ints += THREEFRY_INT_OPS * tail
    else:
        nbytes = slots + 38 * live + 24 * cont + (
            4 * slots if mode == "lockstep" else 16 * live)
    nbytes += launches * (scene_bytes(scene) + 16 + 8)
    return roofline(fp32, nbytes, ints)


def k14_bound(table_values, rays, visits, shaded, itemsize=4,
              grads=True, launches=1):
    """K14's bound over ``launches`` launches of ``rays`` rays in all that
    visited ``visits`` tape rows and shaded ``shaded`` of them (the rest
    missed), on payload tables of ``table_values`` values, in the rays'
    type of ``itemsize`` bytes: a ray's camera ray (6 values) and radiance
    (3) and its id (8), a tape entry a visit (4) and, with ``grads``, the
    scratch row a visit (9 values) and the ray's end row (4); the tables,
    the key read once a launch.  Operations: the draw and the shading of
    each shaded bounce, the sky of each miss."""
    nbytes = (9 * itemsize + 8) * rays + 4 * visits + launches * (
        itemsize * table_values + 16)
    if grads:
        nbytes += 9 * itemsize * visits + 4 * rays
    misses = visits - shaded
    return roofline((THREEFRY_FP32_OPS + SHADE_OPS) * shaded + 8 * misses,
                    nbytes, THREEFRY_INT_OPS * shaded)


def k15_bound(table_values, rays, contributing, bounces, itemsize=4,
              launches=1):
    """K15's bound over ``launches`` launches of ``rays`` rays in all, of
    which ``contributing`` added radiance, sweeping back ``bounces``
    bounces in all, on payload tables of ``table_values`` values: every
    ray's end row (4), a contributing ray's gradient (3 values), id (8)
    and miss row's scratch (6 values); each bounce's scratch row (9) and
    tape entry (4); the tables read and their gradients written once, in
    the rays' type, and the float64 sum zeroed, added and read once (24
    bytes a value), once a launch.  Operations: each bounce re-shaded
    (K9's draw and shading) and its adjoint, the sky's seed a contributing
    ray."""
    nbytes = (4 * rays + (9 * itemsize + 8) * contributing
              + (9 * itemsize + 4) * bounces
              + launches * (table_values * (2 * itemsize + 24) + 16))
    ops = ((THREEFRY_FP32_OPS + SHADE_OPS + ADJOINT_OPS) * bounces
           + 20 * contributing)
    return roofline(ops, nbytes, THREEFRY_INT_OPS * bounces)
