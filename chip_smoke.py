"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. Device: a CUDA GPU must be present; prints its name and the
   ``nvidia-smi`` name and power limit.
2. Build: compiles K1, K2, K2b, K3, K3t, K4 and K5
   (kernels/csrc/megakernel.cu, megakernel_clustered.cu and intersect.cu,
   one nvcc) for sm_90a.
3. K1 vs plain: K1 and its plain PyTorch version on the same card and
   inputs, on four small presets and at the main path's full size.  Bound:
   ``(|a - b| > 1e-3).mean() < 0.01`` on per-pixel mean radiance, segment
   totals within 0.1%.
4. The render path: ``render_image_mega`` on the final scene (1200x800 @ 10
   spp, depth 50, seed 0), launch counter reset before and read after,
   radiance sum within 1% of ``bench_golden.json``; median of 3 timed runs
   after a warm run; the image goes to ``out/final_torch.png``.
5. K2 and K2b vs plain on the four small presets: K2's radiance and
   segments bit-equal to K1's, K2's and K2b's tapes against the plain
   versions' (agreement above 0.999, 0.99 on the coplanar triangle mesh),
   K2b's tape equal to K2's and its per-ray trip counts summing to K1's
   segments; K2's path, ``render_pixels_mega(emit_tape=True)`` over the full
   frame, with its launch counter reset before and read after; a 512-ray
   slice at ray id 9.5 M of the final scene through K2 and K2b equal to the
   same columns of the full-frame K2 tape, and off the plain K2b's in at
   most one ray; K1, K2 and K2b timed at full frame, in turns.
6. The differentiable path at full width (bench.py's grad configuration):
   the final scene, ray ids [0, 2^17), zero target, mean squared radiance,
   every DIFF_FIELDS leaf.  Counters reset, then one step (record by K2b,
   ``plan_buckets``, ``render_loss_and_grads_bucketed``) and the step's
   segment count (K2b's per-ray trip counts, bench.py's instrumentation
   pass), counters read.  Checks at that size: K2's and K2b's tapes equal,
   each against its plain version (agreement above 0.999), K2's radiance
   and segments against the plain K2's (the image bound, totals within
   0.1%), K2b's trips against the plain K2b's (totals within 0.1%) and, per
   pixel, K2's segments; K2's tape against the plain wavefront
   ``record_paths`` (above 0.999); the replay's radiance per pixel against
   K1 over the 13,107 whole pixels (the image bound); finite loss and
   gradients, a non-zero albedo gradient.  Against the JAX package's golden
   (``first_raytracer_tpu_torch/data/grad_golden_final_2p17.json``, with
   JAX's tape beside it): K2's tape agrees with JAX's above 0.999; in
   float32, on K2's tape and on JAX's, the loss within 1% and the albedo
   gradient's relative L2 error within 5%; in float64, the port's replay of
   JAX's tape against JAX's float64 replay: the loss and every gradient
   within 1e-6, those that rest on near-tangent rays (``TANGENT_FIELDS``)
   within 1e-2.  Times: K2, K2b and their plain versions at 2^17 rays, the
   replay's value and gradient, the whole step (median of 3 after the warm
   step), peak memory.
7. ``python -m first_raytracer_tpu_torch.cli fit ... --fast`` in a
   subprocess on the card: exits 0, the loss falls, K2b launched each step.
8. K3 vs plain on small scenes: three-spheres, random-spheres and
   triangle-mesh at 64x32, sphere_field(600) and triangle_field(2000) at
   64x32 @ 2: the image bound, segment totals within 0.1% (per pixel on
   triangle scenes: their paths are chaotic), and K3's sweep counters at or
   below an ungated sweep's.  K3 against K1 at full size on field5000
   (800x450 @ 4) and on the final scene (1200x800 @ 10): the image bound,
   both kernels timed; the final scene's radiance sum within 1% of its
   golden.
9. The large-scene render path: ``render_image_mega_clustered`` on
   field20000, field5000 and trifield20000 at 800x450 @ 4, seed 0, launch
   counter reset before and read after (one K3 launch per frame), each
   radiance sum within 1% of its ``bench_golden.json`` golden; seconds per
   frame (median of 3 after a warm run), Mpaths/s, Mrays/s, the host pack's
   seconds, K3's CUDA-event ms and the clusters swept per segment.  At that
   shape K3's output is held against its plain version on the middle
   quarter of the frame's pixels (the image bound; segment totals within
   0.1%, per pixel on trifield20000), and the plain version is timed
   there.
10. K3t and the clustered fit step: K3t's tape against the plain version
   on the small presets of phase 8 (agreement above 0.999, 0.99 on
   triangle scenes); on ray ids [0, 2^17) of field5000 against K2b's tape
   (above 0.999, rays that differ counted) and its plain version, and on
   field20000 against its plain version (above 0.999); on both against the
   plain wavefront ``record_paths``, no more than 1e-4 below its plain
   version's agreement with it: the expanded sphere quadratic that the
   megakernels share with the JAX kernels re-hits its own sphere in the far
   field, so no megakernel tape reaches 0.999 there
   (``wavefront_agreement``).  One
   ``make_fit_step_replay`` step on field5000 at 2^17 rays, every
   DIFF_FIELDS leaf, zero target, counters reset before and read after: it
   launches K3t, its loss and gradients are finite, its loss is within
   1e-3 of the loss on K2b's tape and each ray's replayed radiance is
   bit-equal where the two tapes are; K3t's ms, the step's seconds (median
   of 3 after the first) and gradient Mpaths/s.

11. K4 and K5 against their plain versions: the small scenes of phase 8,
   each on its camera rays and on 4096 random rays (uniform origins in
   [-8, 8]^3, normal directions), K5 on ``pack_scene_clustered`` with
   max_leaf 1, 7 and 128: hit masks and primitives equal and t within 1e-6
   relative (measured: equal), and K5 equal to K4.
12. The dense wavefront path at full width (K4): the final scene at
   1200x800 @ 10 spp, depth 50, seed 0, through ``render_image`` with
   ``accel=pack_scene_pallas(scene)``, ``mode="regenerative"`` and a pool
   of 2^17 (``bench.py BENCH_MODE=regenerative``), then ``mode="wavefront"``
   in chunks of 2^17, counters reset before each and read after: each
   radiance sum within 1% of the golden, the two images equal to 2e-6.  On
   ray ids [0, 2^17): K4 and its plain version give equal radiance and
   segments, the dense sweep (another summation order) the image bound and
   segment totals within 0.1%; a ``record_paths_pool`` tape through K4
   agrees with K2b's and with the plain wavefront ``record_paths`` on the
   dense sweep at 0.999 or above, and equals the plain ``record_paths`` on
   K4's plain version.  K1's image of the frame is
   compared and logged.  Times: seconds per frame (median of 3 after a warm
   run), Mpaths/s, Mrays/s; K4's launches, CUDA-event ms per frame and per
   launch, and bound.
13. The clustered wavefront path at full width (K5): field20000 and
   trifield20000 at 800x450 @ 4, depth 50, seed 0, through ``render_image``
   with ``accel=pack_scene_clustered(scene)``, wavefront in chunks of 2^17,
   counters reset before and read after.  The same frame through K4 gives
   the image bound (pixels that differ at all are counted) and segment
   totals within 0.1% (per pixel on trifield20000).  The radiance sum is
   logged beside the megacluster golden, not gated: the wavefront's
   oc-form quadratic and the megakernels' expanded one part far from the
   origin.  Times: seconds per frame, Mpaths/s, Mrays/s, the host pack's
   seconds, K5's launches, ms and bound from its per-ray counters.

The last two lines of standard output are a JSON object with the kernels'
measurements and the result line ``{"ok": true, "device": {...}}``.  This
script imports no JAX.  Bounds count FP32 operations from the sources: 16
per (segment, sphere) and 46 per (segment, triangle) for the dense sweep;
for K3 and K3t the slots and boxes their sweep counters say they tested, 29
operations per box test (``gate`` in kernels/csrc/megakernel_clustered.cu).
K4 and K5 (kernels/csrc/intersect.cu) test a sphere in 17 operations (the
oc-form quadratic) and a triangle in 52 (its edges from the vertices); K5
adds 29 per box its counters say it tested.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.diff import grad as dg
from first_raytracer_tpu_torch.diff.replay import (plan_buckets,
                                                   record_paths,
                                                   record_paths_pool,
                                                   trace_rays_replay)
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
from first_raytracer_tpu_torch.kernels import record_mega as rm
from first_raytracer_tpu_torch.render.api import (render_image,
                                                  render_ray_batch)
from first_raytracer_tpu_torch.render.camera import generate_rays
from first_raytracer_tpu_torch.render.image import write_png
from first_raytracer_tpu_torch.scene.builders import build_preset

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_KEY = "radiance_sum_mega_1200x800_10spp"
GRAD_GOLDEN = os.path.join(ROOT, "first_raytracer_tpu_torch", "data",
                           "grad_golden_final_2p17.json")
GRAD_GOLDEN_TAPE = GRAD_GOLDEN.replace(".json", "_tape.npz")
SMALL_CASES = [
    ("three-spheres", dict(nx=64, ny=32, spp=4)),
    ("triangle-mesh", dict(nx=64, ny=32, spp=2)),
    ("camera-effects", dict(nx=64, ny=32, spp=4)),
    ("random-spheres", dict(nx=96, ny=64, spp=2)),
]
GRAD_RAYS = 1 << 17
SLICE_RAY0, SLICE_RAYS = 9_500_000, 512
# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per (segment, sphere) and per (segment, triangle) that
# every sweep step does, counted from kernels/csrc/mega_common.cuh
# (closest_hit): 5 + 5 + 1 + 3 + 2 for a sphere; 9 + 5 + 1 + 3 + 6 + 9 +
# 6 + 6 + 1 for a triangle.  Roots, shading and Threefry are left out, so
# the bound is a lower one.
SPHERE_OPS, TRIANGLE_OPS = 16, 46
# FP32 operations of one slab test of a box (ClusterScene::gate in
# kernels/csrc/megakernel_clustered.cu): 6 subtractions and 6
# multiplications, 10 minima and maxima, 4 for the widening, 3 for the test.
BOX_OPS = 29
# FP32 operations per (ray, sphere) and per (ray, triangle) of K4 and K5
# (kernels/csrc/intersect.cu): 3 + 5 + 5 + 2 + 2 for the oc-form
# quadratic; 6 more than the dense sweep's 46 for a triangle, whose edges
# K4 and K5 compute from the vertices.
OC_SPHERE_OPS, MT_TRIANGLE_OPS = 17, 52
# Phases 12 and 13: the pool and the chunk of the wavefront renders.
WAVE_RAYS = 1 << 17
# Phases 8 and 10: the small scenes.
CLUSTER_CASES = [
    ("three-spheres", dict(nx=64, ny=32, spp=2)),
    ("random-spheres", dict(nx=64, ny=32, spp=2)),
    ("triangle-mesh", dict(nx=64, ny=32, spp=2)),
    ("sphere-field", dict(n=600, nx=64, ny=32, spp=2)),
    ("triangle-field", dict(n=2000, nx=64, ny=32, spp=2)),
]
# (ray, column) pairs per chunk of the plain K3 over a whole field frame:
# 1 GiB per dense temporary, so that its launches are few and its memory
# stays a fraction of the card's.
PLAIN_PAIRS = 1 << 28
# Phase 9: the goldens of bench.py's BENCH_MODE=megacluster runs.
FIELD_SCENES = [
    ("field20000", "sphere-field", 20000,
     "radiance_sum_megacluster_field20000_800x450_4spp"),
    ("field5000", "sphere-field", 5000,
     "radiance_sum_megacluster_field5000_800x450_4spp"),
    ("trifield20000", "triangle-field", 20000,
     "radiance_sum_megacluster_trifield20000_800x450_4spp"),
]


# Gradients of the final scene that rest on a few near-tangent rays, where
# float32 rounding of the sphere discriminant moves them by tens of percent.
TANGENT_FIELDS = ("sphere_center", "sphere_radius", "fuzz", "ref_idx")
# The float64 replay against JAX's: the uniforms stay float32 and go through
# each library's own sine and cosine, and a near-tangent ray magnifies that
# last-bit difference in the fields above (on the CPU at 4096 rays up to
# 8.5e-5 of relative L2 error, tests/test_torch_grad.py); the loss and the
# other gradients agree to about 1e-9 there.
F64_BOUND, F64_TANGENT_BOUND = 1e-6, 1e-2


def to_f64(obj):
    """A copy of a scene or camera with its float tensors in float64."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double()
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).is_floating_point()})


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def compare(rad, segs, ref, ref_segs, spp, what):
    """Kernel vs plain: the image bound and the segment-total bound."""
    a, b = (rad / spp).cpu(), (ref / spp).cpu()
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{what}: non-finite kernel radiance")
    diff = (a - b).abs()
    frac = float((diff > 1e-3).float().mean())
    total, ref_total = int(segs.sum()), int(ref_segs.sum())
    seg_rel = abs(total - ref_total) / max(ref_total, 1)
    log(f"  {what}: frac(|a-b|>1e-3)={frac:.6f} "
        f"median={float(diff.median()):.3e} max={float(diff.max()):.6f} "
        f"segments {total} vs {ref_total} (rel {seg_rel:.2e})")
    if not frac < 0.01:
        raise AssertionError(f"{what}: image bound failed ({frac})")
    if not seg_rel <= 1e-3:
        raise AssertionError(f"{what}: segment totals differ ({seg_rel})")
    return float(diff.max())


def compare_clustered(rad, segs, ref, ref_segs, spp, what, per_pixel):
    """K3 vs its plain version: ``compare``'s bounds, or on triangle scenes
    the image bound and segments per pixel (without a dense field of
    spheres, paths leak between coplanar faces and a total moves with one
    of them).  Returns the largest per-pixel error."""
    if not per_pixel:
        return compare(rad, segs, ref, ref_segs, spp, what)
    diff = ((rad - ref) / spp).abs().cpu()
    if not bool(torch.isfinite(rad).all()):
        raise AssertionError(f"{what}: non-finite kernel radiance")
    frac = float((diff > 1e-3).float().mean())
    seg_frac = float((segs != ref_segs).float().mean())
    log(f"  {what}: frac(|a-b|>1e-3)={frac:.6f} max="
        f"{float(diff.max()):.6f}, pixels whose segments differ "
        f"{seg_frac:.6f}")
    if not (frac < 0.01 and seg_frac < 0.01):
        raise AssertionError(f"{what}: K3 off its plain version")
    return float(diff.max())


def cuda_ms(fn, repeats):
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_s(fn):
    """Seconds of ``fn`` and everything it queued on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def bound(pack, segments, out_bytes):
    """The least time the card could take for a sweep of ``segments``
    segments over the pack: the larger of its FP32 operations over the FP32
    peak and its bytes (tables and camera read once, outputs written once)
    over the memory rate.  Returns (ms, "operations" | "bytes")."""
    ops = segments * (pack.sphere_rows * SPHERE_OPS
                      + pack.tri_rows * TRIANGLE_OPS)
    in_bytes = 4 * (20 + pack.spheres.numel() + pack.sph_mx.numel()
                    + pack.tris.numel())
    t_ops, t_bytes = ops / PEAK_FP32, (in_bytes + out_bytes) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_err(g, w):
    """|g - w| / |w| in float64, or None where ``w`` is zero; and |g|."""
    g, w = g.double().flatten().cpu(), w.double().flatten().cpu()
    if float(w.norm()) == 0.0:
        return None, float(g.norm())
    return float((g - w).norm() / w.norm()), float(g.norm())


def check_grads(what, grads, want, allowed):
    """Each gradient against ``want``'s (a dict of value lists): zero where
    it is zero, else a relative L2 error within ``allowed(field)``."""
    for k, values in want.items():
        err, norm = rel_err(grads[k], torch.tensor(values,
                                                   dtype=torch.float64))
        if err is None:
            ok = norm == 0.0
            log(f"      {what} {k}: reference zero, port norm {norm:.3e}")
        else:
            ok = err <= allowed(k)
            log(f"      {what} {k}: relative error {err:.3e} (bound "
                f"{allowed(k):g})")
        if not ok:
            raise AssertionError(f"{what}: gradient {k} off its reference")


def reset_counts():
    mk.render_pixels_mega.launches = 0
    mk.render_pixels_mega.tape_launches = 0
    rm.record_paths_mega.launches = 0
    mc.render_pixels_mega_clustered.launches = 0
    rm.record_paths_mega_clustered.launches = 0
    ip.intersect_pallas.launches = 0
    ic.intersect_clustered.launches = 0


def clustered_bound(pack, sweeps, out_bytes):
    """The least time for a clustered sweep that did what ``sweeps`` (N, 4)
    counts: its FP32 operations (slots and boxes tested) over the FP32 peak
    against its bytes (tables and camera read once, outputs written once)
    over the memory rate.  Returns (ms, "operations" | "bytes")."""
    tot = sweeps.long().sum(0).tolist()
    ops = tot[1] * SPHERE_OPS + tot[2] * TRIANGLE_OPS + tot[3] * BOX_OPS
    tables = (pack.sph, pack.sph_mx, pack.boxes, pack.super_boxes,
              pack.sph_starts, pack.sph_counts, pack.tris, pack.tri_boxes,
              pack.tri_super_boxes, pack.tri_starts, pack.tri_counts)
    in_bytes = 4 * 20 + sum(t.numel() * t.element_size() for t in tables)
    t_ops, t_bytes = ops / PEAK_FP32, (in_bytes + out_bytes) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def wavefront_tape(scene, cam, cfg, key, ray0, num_rays, chunk=1 << 13):
    """The plain wavefront ``record_paths`` over a ray range, in chunks, so
    that its dense (rays, primitives) temporaries stay bounded."""
    parts = []
    for lo in range(ray0, ray0 + num_rays, chunk):
        ids = torch.arange(lo, min(lo + chunk, ray0 + num_rays),
                           device=scene.device)
        o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                             rng.camera_uniforms(key, ids))
        parts.append(record_paths(scene, o, d, ids, key, cfg))
    return torch.cat(parts, dim=1)


def wavefront_agreement(what, got, plain, want, scene):
    """A megakernel recorder's tape (``got``) and its plain version's
    (``plain``) against the plain wavefront ``record_paths`` (``want``) on a
    far field.

    The megakernels' expanded sphere quadratic (b = o.d - d.C, c = |o|^2 -
    2 o.C + c0, the JAX kernels' form) loses c's absolute precision with
    |o|^2, so a bounce ray leaving a sphere 30-90 units from the origin may
    re-hit that sphere at t just past t_min, where the wavefront's oc-form
    rarely does: the tapes part on a tenth of the rays and per-entry
    agreement falls below 0.999.  The kernel is held to its own formula:
    its agreement with the wavefront may fall short of its plain version's
    by at most 1e-4.  The log counts the rays whose first difference is
    such a re-hit (the same non-dielectric sphere twice in a row, which a
    convex surface cannot give).  Returns the kernel's agreement.
    """
    diff = got != want
    differs = diff.any(dim=0)
    d = diff.int().argmax(dim=0)
    refracts = torch.zeros(scene.num_primitives, dtype=torch.bool,
                           device=got.device)
    refracts[:scene.num_spheres] = scene.mat_type[scene.sphere_mat.long()] \
        == 2

    def rehit(tape):
        prev = tape.gather(0, (d - 1).clamp(min=0)[None])[0]
        cur = tape.gather(0, d[None])[0]
        return (differs & (d >= 1) & (cur == prev) & (cur >= 0)
                & ~refracts[cur.clamp(min=0).long()])

    agree = float((~diff).float().mean())
    agree_plain = float((plain == want).float().mean())
    log(f"  {what}: tape agreement {agree:.6f} (plain version "
        f"{agree_plain:.6f}, floor its own - 1e-4), {int(differs.sum())} of "
        f"{got.shape[1]} rays differ, {int(rehit(got).sum())} first by a "
        f"re-hit of the same sphere in the kernel's tape and "
        f"{int(rehit(want).sum())} in the wavefront's")
    if not agree >= agree_plain - 1e-4:
        raise AssertionError(f"{what}: agreement {agree} below the plain "
                             f"version's {agree_plain}")
    return agree


def tape_agreement(what, got, want, floor):
    """Per-entry agreement of two tapes; logs it with the rays that
    differ and fails below ``floor``."""
    agree = float((got == want).float().mean())
    rays = int((got != want).any(dim=0).sum())
    log(f"  {what}: tape agreement {agree:.6f} (floor {floor}), {rays} of "
        f"{got.shape[1]} rays differ")
    if not agree > floor:
        raise AssertionError(f"{what}: tape agreement {agree} <= {floor}")
    return agree


def build():
    """Phase 2: the one library of K1, K2 and K2b."""
    _, info = mk.load_mega_library()
    log(f"build: {os.path.relpath(info.path, ROOT)} (nvcc "
        f"{info.seconds:.2f} s, cached={info.cached})")
    for line in info.log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def render_path(dev, key, card):
    """Phases 3 and 4: K1 against its plain version, then the render path.
    Returns K1's entry of the kernels line and the final scene."""
    for preset, kw in SMALL_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        pack = mk.pack_scene_mega(scene)
        before = mk.render_pixels_mega.launches
        rad, segs = mk.render_pixels_mega(pack, cam, cfg, key)
        torch.cuda.synchronize()
        if mk.render_pixels_mega.launches != before + 1:
            raise AssertionError("launch counter did not move")
        ref, ref_segs = mk.render_pixels_mega_reference(pack, cam, cfg, key)
        compare(rad, segs, ref, ref_segs, cfg.spp,
                f"{preset} {cfg.nx}x{cfg.ny}@{cfg.spp}")

    scene, cam, cfg = build_preset("random-spheres", device=dev)
    pack = mk.pack_scene_mega(scene)
    t0 = time.perf_counter()
    ref, ref_segs = mk.render_pixels_mega_reference(pack, cam, cfg, key)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rad, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    torch.cuda.synchronize()
    max_abs_err = compare(rad, segs, ref, ref_segs, cfg.spp,
                          f"final scene {cfg.nx}x{cfg.ny}@{cfg.spp}")
    log(f"  plain version at full size: {plain_ms:.1f} ms (one run)")
    del ref, ref_segs, rad, segs

    # 4. The render path at full size, through the user's entry point.
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        golden = json.load(f)[GOLDEN_KEY]
    reset_counts()
    img = mk.render_image_mega(scene, cam, cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    launches = mk.render_pixels_mega.launches
    if launches < 1:
        raise AssertionError("the render path did not launch K1")
    if tuple(img.shape) != (cfg.ny, cfg.nx, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("non-finite pixels")
    checksum = float(img.double().sum()) * cfg.spp
    rel = abs(checksum - golden) / golden
    log(f"render path: radiance sum {checksum:.1f} vs golden {golden:.1f} "
        f"(rel {rel:.2e}), K1 launches {launches}")
    if not rel < 1e-2:
        raise AssertionError(f"radiance sum off golden by {rel:.3g}")
    os.makedirs(os.path.join(ROOT, "out"), exist_ok=True)
    write_png(os.path.join(ROOT, "out", "final_torch.png"), img)

    seconds = []
    for _ in range(4):  # one warm run, then three timed
        t0 = time.perf_counter()
        mk.render_image_mega(scene, cam, cfg, seed=0, device=dev)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    sec = statistics.median(seconds[1:])
    _, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    rays = int(segs.sum())
    # One thread per pixel: a warp of 32 consecutive pixels sweeps until its
    # busiest thread is done, so mean/max per warp is its lane efficiency.
    warps = segs.float().reshape(-1, 32)
    lane_eff = float(warps.mean(1).sum() / warps.max(1).values.sum())
    kernel_ms = cuda_ms(lambda: mk.render_pixels_mega(pack, cam, cfg, key),
                        3)
    bound_ms, bound_by = bound(pack, rays, 16 * cfg.num_pixels)
    log(f"final scene {cfg.nx}x{cfg.ny}@{cfg.spp}spp depth "
        f"{cfg.max_depth}: {sec:.4f} s/frame median of 3, "
        f"{cfg.num_rays / sec / 1e6:.3f} Mpaths/s, "
        f"{rays / sec / 1e6:.3f} Mrays/s ({rays} segments); K1 alone "
        f"{kernel_ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by}), warp "
        f"lane efficiency {lane_eff:.3f}; plain {plain_ms:.1f} ms; on {card}")
    k1 = {"name": "K1 megakernel (render_pixels_mega)", "route": "cuda",
          "source": "first_raytracer_tpu_torch/kernels/csrc/megakernel.cu",
          "replaces": mk.REPLACES, "launches": launches,
          "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return k1, scene, cam, cfg, pack


def tape_kernels_vs_plain(dev, key, card, scene, cam, cfg, pack):
    """Phase 5."""
    for preset, kw in SMALL_CASES:
        s, c, cf = build_preset(preset, device=dev, **kw)
        p = mk.pack_scene_mega(s)
        rad, segs = mk.render_pixels_mega(p, c, cf, key)
        before = (mk.render_pixels_mega.tape_launches,
                  rm.record_paths_mega.launches)
        rad2, segs2, tape = mk.render_pixels_mega(p, c, cf, key,
                                                  emit_tape=True)
        tape_b, its = rm.record_paths_mega(p, c, cf, key, return_iters=True)
        torch.cuda.synchronize()
        if (mk.render_pixels_mega.tape_launches,
                rm.record_paths_mega.launches) != (before[0] + 1,
                                                   before[1] + 1):
            raise AssertionError("K2 or K2b launch counter did not move")
        if not (torch.equal(rad2, rad) and torch.equal(segs2, segs)):
            raise AssertionError(f"{preset}: K2 changed K1's results")
        if not torch.equal(tape_b, tape):
            raise AssertionError(f"{preset}: K2b's tape differs from K2's")
        if not torch.equal(its.reshape(-1, cf.spp).sum(1, dtype=torch.int32),
                           segs):
            raise AssertionError(f"{preset}: K2b's trips differ from K1's "
                                 "segments")
        ref_rad, _, ref = mk.render_pixels_mega_reference(p, c, cf, key,
                                                          emit_tape=True)
        ref_b, ref_its = rm.record_paths_mega_reference(p, c, cf, key)
        a2 = float((tape == ref).float().mean())
        ab = float((tape_b == ref_b).float().mean())
        floor = 0.99 if preset == "triangle-mesh" else 0.999
        e2 = float(((rad2 - ref_rad) / cf.spp).abs().max())
        eb = float((its - ref_its).abs().max())
        log(f"  {preset} {cf.nx}x{cf.ny}@{cf.spp}: K2 = K1 bit for bit; "
            f"tape agreement K2 {a2:.6f}, K2b {ab:.6f} (floor {floor}); "
            f"K2 radiance max err {e2:.3e}, K2b trip max err {eb:g}")
        if not (a2 > floor and ab > floor):
            raise AssertionError(f"{preset}: tape agreement below {floor}")

    # K2's path: the megakernel with its tape over the full frame.
    reset_counts()
    _, _, full = mk.render_pixels_mega(pack, cam, cfg, key, emit_tape=True)
    torch.cuda.synchronize()
    k2_launches = mk.render_pixels_mega.tape_launches
    if k2_launches < 1:
        raise AssertionError("render_pixels_mega(emit_tape=True) did not "
                             "launch K2")
    want = full[:, SLICE_RAY0:SLICE_RAY0 + SLICE_RAYS]
    p0 = SLICE_RAY0 // cfg.spp
    _, _, by_k2 = mk.render_pixels_mega(
        pack, cam, cfg, key, pix0=p0, num_pixels=-(-SLICE_RAYS // cfg.spp),
        emit_tape=True)
    off = SLICE_RAY0 - p0 * cfg.spp
    by_k2b = rm.record_paths_mega(pack, cam, cfg, key, ray0=SLICE_RAY0,
                                  num_rays=SLICE_RAYS)
    for what, got in (("K2", by_k2[:, off:off + SLICE_RAYS]),
                      ("K2b", by_k2b)):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: slice at ray {SLICE_RAY0} "
                                 "differs from the full-frame tape")
    ref, _ = rm.record_paths_mega_reference(pack, cam, cfg, key,
                                            ray0=SLICE_RAY0,
                                            num_rays=SLICE_RAYS)
    rays = int((ref != want).any(dim=0).sum())
    log(f"  slice against the plain K2b: agreement "
        f"{float((ref == want).float().mean()):.6f}, {rays} rays differ "
        "(bound: at most one)")
    if rays > 1:
        raise AssertionError("the slice differs from the plain K2b's")
    log(f"  slice [{SLICE_RAY0}, +{SLICE_RAYS}) through K2 and K2b equals "
        "the full-frame K2 tape's columns")
    del full, want
    torch.cuda.empty_cache()
    calls = {
        "K1": lambda: mk.render_pixels_mega(pack, cam, cfg, key),
        "K2": lambda: mk.render_pixels_mega(pack, cam, cfg, key,
                                            emit_tape=True),
        "K2b": lambda: rm.record_paths_mega(pack, cam, cfg, key)}
    runs = {k: [] for k in calls}
    for k in ("K1", "K2", "K2b", "K2b", "K2", "K1"):  # in turns
        runs[k].append(cuda_ms(calls[k], 3))
        torch.cuda.empty_cache()
    k1_ms, k2_ms, kb_ms = (statistics.mean(runs[k]) for k in calls)
    log(f"full frame, in turns K1 K2 K2b K2b K2 K1 (median of 3 each): K1 "
        f"{runs['K1']} ms, K2 {runs['K2']} ms, K2b {runs['K2b']} ms; tape "
        f"write +{k2_ms - k1_ms:.3f} ms ({(k2_ms / k1_ms - 1) * 100:.1f}%); "
        f"K2b/K2 {kb_ms / k2_ms:.3f}; on {card}")
    return k2_launches


def grad_path(dev, key, card, scene, cam, cfg, pack):
    """Phase 6.  Returns the launches and times for the kernels line."""
    R = GRAD_RAYS
    ids = torch.arange(R, device=dev)
    target = torch.zeros((R, 3), device=dev)
    params, _ = dg.split_params(scene)

    def record():
        return rm.record_paths_mega(pack, cam, cfg, key, num_rays=R)

    def record_k2():
        return mk.render_pixels_mega(pack, cam, cfg, key,
                                     num_pixels=-(-R // cfg.spp),
                                     emit_tape=True)[2][:, :R]

    def step():
        tape = record()
        plan = plan_buckets(tape)
        loss, grads = dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, tape, plan=plan)
        return tape, plan, loss, grads

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    tape, plan, loss, grads = step()
    tape_b, its = rm.record_paths_mega(pack, cam, cfg, key, num_rays=R,
                                       return_iters=True)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {"K2b": rm.record_paths_mega.launches}
    log(f"grad path: launches {launches}, buckets {plan[1]}, peak memory "
        f"{peak_gb:.3f} GB")
    if launches["K2b"] < 2:
        raise AssertionError("the grad path did not record with K2b")
    segments = int(its.sum())

    # (a) K2 and K2b against their plain versions at this size, and K2's
    # tape against the plain wavefront recorder.
    pixels_k2 = -(-R // cfg.spp)  # K2 covers the pixels that hold the rays
    plain2_s, (ref_rad, ref_segs, ref_tape) = host_s(
        lambda: mk.render_pixels_mega_reference(
            pack, cam, cfg, key, num_pixels=pixels_k2, emit_tape=True))
    plain_b_s, (ref_b, ref_its) = host_s(
        lambda: rm.record_paths_mega_reference(pack, cam, cfg, key,
                                               num_rays=R))
    rad2, segs2, tape2 = mk.render_pixels_mega(pack, cam, cfg, key,
                                               num_pixels=pixels_k2,
                                               emit_tape=True)
    err2 = compare(rad2, segs2, ref_rad, ref_segs, cfg.spp,
                   f"K2 vs plain over {pixels_k2} pixels")
    if not (torch.equal(tape2[:, :R], tape) and torch.equal(tape_b, tape)):
        raise AssertionError("K2b's tape, or K2's of the whole pixels, "
                             "differs from the step's")
    whole = R // cfg.spp
    if not torch.equal(its[:whole * cfg.spp].reshape(whole, cfg.spp).sum(
            1, dtype=torch.int32), segs2[:whole]):
        raise AssertionError("K2b's trips differ from K2's segments")
    agree2 = float((tape == ref_tape[:, :R]).float().mean())
    agree_b = float((tape_b == ref_b).float().mean())
    err_b = float((its - ref_its).abs().max())
    trips_rel = abs(segments - int(ref_its.sum())) / int(ref_its.sum())
    log(f"  (a) K2b = K2 (tapes; trips per pixel = segments); tape agreement "
        f"with the plain versions: K2 {agree2:.6f}, K2b {agree_b:.6f} (floor "
        f"0.999), {int((tape != ref_tape[:, :R]).any(dim=0).sum())} and "
        f"{int((tape_b != ref_b).any(dim=0).sum())} rays differ; K2b trips "
        f"{segments} vs {int(ref_its.sum())} (rel {trips_rel:.2e}), per ray "
        f"max err {err_b:g}")
    if not (agree2 > 0.999 and agree_b > 0.999):
        raise AssertionError("K2 or K2b tape off its plain version")
    if not trips_rel <= 1e-3:
        raise AssertionError(f"K2b trip totals differ ({trips_rel})")
    del ref_rad, ref_tape, ref_b, tape2
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    wave_s, wave = host_s(lambda: record_paths(scene, o, d, ids, key, cfg))
    agree = float((tape == wave).float().mean())
    differing = int((tape != wave).any(dim=0).sum())
    log(f"  (a) the step's tape (K2b) vs plain record_paths: agreement "
        f"{agree:.6f}, {differing} rays differ (record_paths "
        f"{wave_s * 1e3:.1f} ms, one run)")
    if not agree > 0.999:
        raise AssertionError(f"K2b tape agreement {agree}")
    del wave

    # (b) The replay's radiance per whole pixel against K1.
    with torch.no_grad():
        rad = trace_rays_replay(scene, o, d, ids, key, cfg, tape)
    rad_px = rad[:whole * cfg.spp].reshape(whole, cfg.spp, 3).sum(1)
    k1_rad, _ = mk.render_pixels_mega(pack, cam, cfg, key, num_pixels=whole)
    diff = ((rad_px - k1_rad) / cfg.spp).abs()
    frac = float((diff > 1e-3).float().mean())
    log(f"  (b) replay vs K1 over {whole} pixels: frac(|a-b|>1e-3)="
        f"{frac:.6f} max={float(diff.max()):.3e}")
    if not frac < 0.01:
        raise AssertionError(f"replay radiance off K1 ({frac})")

    # (c) Finite loss and gradients; the albedo gradient moves.
    if not bool(torch.isfinite(loss)):
        raise AssertionError("non-finite loss")
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient {k}")
    if not float(grads["albedo"].abs().max()) > 0.0:
        raise AssertionError("zero albedo gradient")

    # (d) The JAX package's golden, computed on the CPU, and its tape.
    with open(GRAD_GOLDEN) as f:
        golden = json.load(f)
    with np.load(GRAD_GOLDEN_TAPE) as saved:
        jax_tape = torch.from_numpy(saved["tape"].astype(np.int32)).to(dev)
    agree_j = float((tape == jax_tape).float().mean())
    rays_j = int((tape != jax_tape).any(dim=0).sum())
    log(f"  (d) the step's tape (K2b) vs JAX's tape: agreement "
        f"{agree_j:.6f}, {rays_j} rays differ")
    if not agree_j > 0.999:
        raise AssertionError(f"K2b tape agreement with JAX's {agree_j}")
    f64 = golden["f64"]
    want64 = {k: v["values"] for k, v in f64["fields"].items()}
    # (d1) float32, on K2b's tape (the step as run) and on JAX's: the loss
    # within 1% and the albedo gradient within 5% of JAX's float32 values.
    # The fields of TANGENT_FIELDS are only logged here: in float32 they
    # move by tens of percent between tapes or roundings in either package.
    loss_j, grads_j = dg.render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, ids, target, jax_tape)
    for what, l32, g32 in (("K2b's", loss, grads),
                           ("JAX's", loss_j, grads_j)):
        rel = abs(float(l32) - golden["loss"]) / golden["loss"]
        log(f"  (d1) float32 on {what} tape: loss {float(l32):.9g}, rel "
            f"{rel:.3e} (bound 1e-2)")
        if not rel < 1e-2:
            raise AssertionError(f"loss on {what} tape off by {rel:.3g}")
        check_grads(f"(d1) {what} tape", {"albedo": g32["albedo"]},
                    {"albedo": golden["fields"]["albedo"]["values"]},
                    lambda k: 0.05)
        for k in TANGENT_FIELDS:
            err = rel_err(g32[k], torch.tensor(want64[k],
                                               dtype=torch.float64))[0]
            log(f"      {k}: {err:.4f} from JAX's float64 (JAX's own "
                f"float32: {f64['fields'][k]['f32']['rel_err']})")
    # (d2) float64 on JAX's tape: every field against JAX's float64 replay.
    scene64, cam64 = to_f64(scene), to_f64(cam)
    params64, _ = dg.split_params(scene64)
    loss64, grads64 = dg.render_loss_and_grads_bucketed(
        params64, scene64, cam64, cfg, key, ids, target.double(), jax_tape)
    rel64 = abs(float(loss64) - f64["loss"]) / f64["loss"]
    log(f"  (d2) float64 on JAX's tape: loss {float(loss64):.17g}, rel "
        f"{rel64:.3e} (bound {F64_BOUND:g})")
    if not (loss64.dtype == torch.float64 and rel64 < F64_BOUND):
        raise AssertionError(f"float64 loss off JAX's by {rel64:.3g}")
    check_grads("(d2) float64", grads64, want64,
                lambda k: F64_TANGENT_BOUND if k in TANGENT_FIELDS
                else F64_BOUND)
    del scene64, cam64, params64, grads64

    # Times, median of 3 after the warm step above.
    k2_ms = cuda_ms(record_k2, 3)
    kb_ms = cuda_ms(record, 3)
    replay_s = statistics.median(host_s(
        lambda: dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, tape, plan=plan))[0]
        for _ in range(3))
    step_s = statistics.median(host_s(step)[0] for _ in range(3))
    D = cfg.max_depth + 1
    k2_bound = bound(pack, int(segs2.sum()),
                     16 * pixels_k2 + 4 * D * pixels_k2 * cfg.spp)
    kb_bound = bound(pack, segments, 4 * (D + 1) * R)
    log(f"  at {R} rays: K2 {k2_ms:.3f} ms (bound {k2_bound[0]:.4f} ms), "
        f"K2b {kb_ms:.3f} ms (bound {kb_bound[0]:.4f} ms), plain K2 "
        f"{plain2_s * 1e3:.1f} ms, plain K2b {plain_b_s * 1e3:.1f} ms (one "
        f"run each); on {card}")
    log(f"  replay value and gradient {replay_s * 1e3:.1f} ms; whole step "
        f"(record + plan + value and gradient) {step_s * 1e3:.1f} ms: "
        f"{R / step_s / 1e6:.4f} gradient Mpaths/s, "
        f"{segments / step_s / 1e6:.3f} Mrays/s ({segments} segments), "
        f"replay {replay_s / step_s * 100:.1f}% of the step (K2b records); "
        "peak memory "
        f"{peak_gb:.3f} GB; on {card}")
    return dict(launches=launches, k2_ms=k2_ms, kb_ms=kb_ms,
                plain2_ms=plain2_s * 1e3, plain_b_ms=plain_b_s * 1e3,
                k2_bound=k2_bound, kb_bound=kb_bound, err2=err2,
                err_b=err_b, agree2=agree2, agree_b=agree_b)


def fit_cli(card):
    """Phase 7: the fit CLI in a subprocess on the card."""
    cmd = [sys.executable, "-m", "first_raytracer_tpu_torch.cli", "fit",
           "--preset", "random-spheres", "--nx", "64", "--ny", "32",
           "--spp", "2", "--fields", "albedo", "--opt", "adam", "--lr",
           "0.05", "--fast", "--steps", "5"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"fit CLI exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    steps, last = lines[:-1], lines[-1]
    log(f"fit CLI: {' '.join(cmd[3:])} in {time.perf_counter() - t0:.1f} s: "
        f"losses {[s['loss'] for s in steps]}, {last}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError("the fit's loss did not fall")
    if last["device"] != "cuda" or last["kernel_launches"]["K2b"] < 5:
        raise AssertionError("the fit did not record with K2b on the card")


def clustered_vs_plain(dev, key, card):
    """Phase 8.  Returns K1's and K3's times on field5000 and the final
    scene."""
    for preset, kw in CLUSTER_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        pack = mc.pack_scene_mega_clustered(scene, cam)
        before = mc.render_pixels_mega_clustered.launches
        rad, segs, sweeps = mc.render_pixels_mega_clustered(
            pack, cam, cfg, key, return_iters=True)
        torch.cuda.synchronize()
        if mc.render_pixels_mega_clustered.launches != before + 1:
            raise AssertionError("K3's launch counter did not move")
        ref, ref_segs, ungated = mc.render_pixels_mega_clustered_reference(
            pack, cam, cfg, key, return_iters=True)
        what = (f"{preset} {kw.get('n', '')} {cfg.nx}x{cfg.ny}@{cfg.spp} "
                f"({pack.clusters} + {pack.tri_clusters} clusters)")
        compare_clustered(rad, segs, ref, ref_segs, cfg.spp, what,
                          per_pixel="triangle" in preset)
        done, full = sweeps.long().sum(0), ungated.long().sum(0)
        log(f"    sweeps: {done.tolist()} of an ungated sweep's "
            f"{full.tolist()} ({', '.join(mc.SWEEP_COLUMNS)})")
        if not bool((sweeps[:, :3] <= ungated[:, :3]).all()):
            raise AssertionError(f"{what}: K3 swept more than every cluster")

    # K3 against K1 at full size, on field5000 and on the final scene.
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        goldens = json.load(f)
    times = {}
    for label, preset, kw in (("field5000", "sphere-field", dict(n=5000)),
                              ("final scene", "random-spheres", {})):
        scene_, cam_, cfg_ = build_preset(preset, device=dev, **kw)
        dpack = mk.pack_scene_mega(scene_)
        cpack = mc.pack_scene_mega_clustered(scene_, cam_)
        rad1, segs1 = mk.render_pixels_mega(dpack, cam_, cfg_, key)
        rad3, segs3 = mc.render_pixels_mega_clustered(cpack, cam_, cfg_, key)
        diff = ((rad3 - rad1) / cfg_.spp).abs().cpu()
        frac = float((diff > 1e-3).float().mean())
        ms = {k: cuda_ms(fn, 3) for k, fn in (
            ("K1", lambda: mk.render_pixels_mega(dpack, cam_, cfg_, key)),
            ("K3", lambda: mc.render_pixels_mega_clustered(cpack, cam_, cfg_,
                                                           key)))}
        times[label] = ms
        log(f"  K3 vs K1, {label} {cfg_.nx}x{cfg_.ny}@{cfg_.spp}: "
            f"frac(|a-b|>1e-3)={frac:.6f} max={float(diff.max()):.3e}, "
            f"segments {int(segs3.sum())} vs {int(segs1.sum())}; K1 "
            f"{ms['K1']:.3f} ms, K3 {ms['K3']:.3f} ms; on {card}")
        if not frac < 0.01:
            raise AssertionError(f"K3 off K1 on {label} ({frac})")
        if preset == "random-spheres":
            total = float(rad3.double().sum())
            rel = abs(total - goldens[GOLDEN_KEY]) / goldens[GOLDEN_KEY]
            log(f"    final scene through K3: radiance sum {total:.1f} vs "
                f"golden {goldens[GOLDEN_KEY]:.1f} (rel {rel:.2e})")
            if not rel < 1e-2:
                raise AssertionError(f"K3's final scene off golden ({rel})")
        del rad1, rad3
    return times


def large_scene_path(dev, key, card):
    """Phase 9.  Returns K3's launches, per scene its times, bound and error
    against the plain version, and the field scenes for phase 10."""
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        goldens = json.load(f)
    out, scenes = {}, {}
    launches = 0
    for label, preset, n, gkey in FIELD_SCENES:
        scene, cam, cfg = build_preset(preset, device=dev, n=n)
        scenes[label] = (scene, cam, cfg)
        reset_counts()
        img = mc.render_image_mega_clustered(scene, cam, cfg, seed=0,
                                             device=dev)
        torch.cuda.synchronize()
        frame_launches = mc.render_pixels_mega_clustered.launches
        launches += frame_launches
        if frame_launches != 1:
            raise AssertionError(f"{label}: {frame_launches} K3 launches "
                                 "for one frame")
        if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: bad image")
        total = float(img.double().sum()) * cfg.spp
        rel = abs(total - goldens[gkey]) / goldens[gkey]
        log(f"{label} {cfg.nx}x{cfg.ny}@{cfg.spp} depth {cfg.max_depth}: "
            f"radiance sum {total:.3f} vs golden {goldens[gkey]} (rel "
            f"{rel:.2e}), K3 launches {frame_launches}")
        if not rel < 1e-2:
            raise AssertionError(f"{label}: radiance sum off golden by {rel}")
        os.makedirs(os.path.join(ROOT, "out"), exist_ok=True)
        write_png(os.path.join(ROOT, "out", f"{label}_torch.png"), img)
        seconds = []
        for _ in range(4):  # one warm run, then three timed
            seconds.append(host_s(lambda: mc.render_image_mega_clustered(
                scene, cam, cfg, seed=0, device=dev))[0])
        sec = statistics.median(seconds[1:])
        pack_s = statistics.median(host_s(
            lambda: mc.pack_scene_mega_clustered(scene, cam))[0]
            for _ in range(3))
        pack = mc.pack_scene_mega_clustered(scene, cam)
        rad, segs, sweeps = mc.render_pixels_mega_clustered(
            pack, cam, cfg, key, return_iters=True)
        rays = int(segs.sum())
        k3_ms = cuda_ms(
            lambda: mc.render_pixels_mega_clustered(pack, cam, cfg, key), 3)
        tot = sweeps.long().sum(0).tolist()
        b = clustered_bound(pack, sweeps, 32 * cfg.num_pixels)
        log(f"  {sec:.4f} s/frame median of 3 ({cfg.num_rays / sec / 1e6:.3f}"
            f" Mpaths/s, {rays / sec / 1e6:.3f} Mrays/s, {rays} segments); "
            f"host pack {pack_s:.4f} s; K3 alone {k3_ms:.3f} ms "
            f"({cfg.num_rays / k3_ms / 1e3:.1f} Mpaths/s; bound {b[0]:.4f} "
            f"ms, {b[1]}); per segment {tot[0] / rays:.2f} clusters swept, "
            f"{tot[1] / rays:.1f} sphere and {tot[2] / rays:.1f} triangle "
            f"slots, {tot[3] / rays:.1f} boxes tested; on {card}")
        # K3's output at this shape against its plain version, on the
        # middle quarter of the frame's pixels (the plain version's time
        # over whole frames pushed the script past ten minutes).
        p0, n_px = 3 * cfg.num_pixels // 8, cfg.num_pixels // 4
        mc.check_clustered_guards(pack, cfg)
        plain_s, (ref, ref_segs) = host_s(lambda: mk.render_reference(
            pack, cam, cfg, key, pix0=p0, num_pixels=n_px,
            rays_per_chunk=PLAIN_PAIRS // pack.sweep_columns))
        band = slice(p0, p0 + n_px)
        err = compare_clustered(rad[band], segs[band], ref, ref_segs,
                                cfg.spp, f"  K3 vs plain, pixels [{p0}, "
                                f"{p0 + n_px}) of the frame",
                                per_pixel=preset == "triangle-field")
        log(f"  plain version {plain_s * 1e3:.1f} ms on a quarter of the "
            "frame (one run)")
        out[label] = dict(ms=k3_ms, bound=b, sec=sec, err=err,
                          plain_ms=plain_s * 1e3)
        del ref, ref_segs, rad
        torch.cuda.empty_cache()
    return launches, out, scenes


def clustered_tapes_and_step(dev, key, card, scenes):
    """Phase 10.  Returns K3t's entries for the kernels line."""
    for preset, kw in CLUSTER_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        pack = mc.pack_scene_mega_clustered(scene, cam)
        before = rm.record_paths_mega_clustered.launches
        tape = rm.record_paths_mega_clustered(pack, cam, cfg, key)
        torch.cuda.synchronize()
        if rm.record_paths_mega_clustered.launches != before + 1:
            raise AssertionError("K3t's launch counter did not move")
        ref, _ = rm.record_paths_mega_clustered_reference(pack, cam, cfg,
                                                          key)
        tape_agreement(f"K3t vs plain, {preset} {kw.get('n', '')} "
                       f"{cfg.nx}x{cfg.ny}@{cfg.spp}", tape, ref,
                       0.99 if "triangle" in preset else 0.999)

    R = GRAD_RAYS
    scene, cam, cfg = scenes["field5000"]
    cpack = mc.pack_scene_mega_clustered(scene, cam)
    dpack = mk.pack_scene_mega(scene)
    tape3, its3, sweeps3 = rm.record_paths_mega_clustered(
        cpack, cam, cfg, key, num_rays=R, return_iters=True)
    tape_b = rm.record_paths_mega(dpack, cam, cfg, key, num_rays=R)
    agree_k2b = tape_agreement(f"field5000 rays [0, {R}): K3t vs K2b",
                               tape3, tape_b, 0.999)
    plain_s, (ref3, ref_its3) = host_s(
        lambda: rm.record_paths_mega_clustered_reference(
            cpack, cam, cfg, key, num_rays=R))
    trips_err = int((its3 - ref_its3).abs().max())
    agree_plain = tape_agreement("  K3t vs its plain version", tape3, ref3,
                                 0.999)
    wavefront_agreement("  K3t vs the plain wavefront record_paths", tape3,
                        ref3, wavefront_tape(scene, cam, cfg, key, 0, R),
                        scene)
    del ref3
    k3t_ms = cuda_ms(lambda: rm.record_paths_mega_clustered(
        cpack, cam, cfg, key, num_rays=R), 3)
    bound = clustered_bound(cpack, sweeps3, 4 * (cfg.max_depth + 6) * R)

    s20, c20, cfg20 = scenes["field20000"]
    p20 = mc.pack_scene_mega_clustered(s20, c20)
    t20 = rm.record_paths_mega_clustered(p20, c20, cfg20, key, num_rays=R)
    ref20, _ = rm.record_paths_mega_clustered_reference(p20, c20, cfg20,
                                                        key, num_rays=R)
    tape_agreement(f"field20000 rays [0, {R}): K3t vs its plain version",
                   t20, ref20, 0.999)
    wavefront_agreement("  K3t vs the plain wavefront record_paths", t20,
                        ref20, wavefront_tape(s20, c20, cfg20, key, 0, R),
                        s20)
    del ref20
    k3t20_ms = cuda_ms(lambda: rm.record_paths_mega_clustered(
        p20, c20, cfg20, key, num_rays=R), 3)
    del t20, p20

    # One clustered fit step on field5000 through the user's entry point.
    ids = torch.arange(R, device=dev)
    target = torch.zeros((R, 3), device=dev)
    params, _ = dg.split_params(scene)
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = dg.make_optimizer("adam", params, 1e-3)
    step = dg.make_fit_step_replay(scene, cam, cfg, ids, target, opt,
                                   device=dev)
    reset_counts()
    loss = step(params, key)
    torch.cuda.synchronize()
    launches = rm.record_paths_mega_clustered.launches
    log(f"clustered fit step, field5000, {R} rays: loss {float(loss):.9g}, "
        f"launches K3t {launches}, K2b {rm.record_paths_mega.launches}")
    if launches != 1 or rm.record_paths_mega.launches:
        raise AssertionError("the clustered fit step did not record with "
                             "K3t alone")
    grads = {k: v.grad for k, v in params.items()}
    if not bool(torch.isfinite(loss)) or not all(
            bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError("non-finite loss or gradient")
    base = dataclasses.replace(scene, **start)
    p0 = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    loss_b, _ = dg.render_loss_and_grads_bucketed(p0, base, cam, cfg, key,
                                                  ids, target, tape_b)
    rel = abs(float(loss) - float(loss_b)) / float(loss_b)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    with torch.no_grad():
        rad3 = trace_rays_replay(base, o, d, ids, key, cfg, tape3)
        rad_b = trace_rays_replay(base, o, d, ids, key, cfg, tape_b)
    same = (tape3 == tape_b).all(dim=0)
    bit_equal = torch.equal(rad3[same], rad_b[same])
    log(f"  loss on K2b's tape {float(loss_b):.9g} (rel {rel:.3e}, bound "
        f"1e-3); replayed radiance bit-equal on the {int(same.sum())} rays "
        f"whose tapes are equal: {bit_equal}")
    if not (rel < 1e-3 and bit_equal):
        raise AssertionError("the clustered step is off the step on K2b's "
                             "tape")
    if bool(same.all()) and float(loss) != float(loss_b):
        raise AssertionError("equal tapes, unequal losses")
    step_s = statistics.median(host_s(lambda: step(params, key))[0]
                               for _ in range(3))
    segments = int(its3.sum())
    log(f"  K3t at {R} rays: field5000 {k3t_ms:.3f} ms (bound "
        f"{bound[0]:.4f} ms, {bound[1]}; plain {plain_s * 1e3:.1f} ms, one "
        f"run), field20000 {k3t20_ms:.3f} ms; the step {step_s * 1e3:.1f} ms"
        f" median of 3: {R / step_s / 1e6:.4f} gradient Mpaths/s, "
        f"{segments / step_s / 1e6:.3f} Mrays/s ({segments} segments); "
        f"trip counts off the plain version's by at most {trips_err}; on "
        f"{card}")
    return dict(launches=launches, ms=k3t_ms, ms20=k3t20_ms,
                trips_err=trips_err,
                plain_ms=plain_s * 1e3, bound=bound, agree=agree_plain,
                agree_k2b=agree_k2b)


def intersect_ops(pack, rays):
    """FP32 operations of K4 over ``rays`` rays of a dense pack."""
    return rays * (pack.sphere_rows * OC_SPHERE_OPS
                   + pack.tri_rows * MT_TRIANGLE_OPS)


def intersect_bound(ops, in_bytes, out_bytes):
    """(ms, "operations" | "bytes") of ``ops`` FP32 operations against the
    bytes read and written."""
    t_ops, t_bytes = ops / PEAK_FP32, (in_bytes + out_bytes) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def k4_bound(pack, rays, launches=1):
    """K4's bound over ``launches`` launches of ``rays`` rays in all: the
    table read once a launch, 24 bytes in and 8 out a ray."""
    return intersect_bound(intersect_ops(pack, rays),
                           launches * tensor_bytes(pack.spheres, pack.tris)
                           + 24 * rays, 8 * rays)


def k5_bound(pack, sweeps_total, rays, launches=1):
    """K5's bound from the slots and boxes its counters say it tested
    (``sweeps_total``: the four ``SWEEP_COLUMNS`` sums)."""
    tot = [int(x) for x in sweeps_total]
    ops = tot[1] * OC_SPHERE_OPS + tot[2] * MT_TRIANGLE_OPS + tot[3] * BOX_OPS
    tables = tensor_bytes(pack.sph, pack.tri, pack.sph_box, pack.tri_box,
                          pack.sph_gid, pack.tri_gid, pack.sph_count,
                          pack.tri_count)
    return intersect_bound(ops, launches * tables + 24 * rays, 8 * rays)


class Clocked:
    """An ``intersect_fn`` that records CUDA events around each call of the
    wrapper ``fn`` (its kernel and the hit comparison after it) and, for
    K5, sums its per-ray counters on the card: the kernel's time and work
    over a whole frame without a host sync per call."""

    def __init__(self, fn, counters=False):
        self.fn, self.counters = fn, counters
        self.events, self.rays = [], 0
        self.sweeps = None

    def __call__(self, scene, accel, o, d, t_min):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if self.counters:
            prim, t, hit, sweeps = self.fn(scene, accel, o, d, t_min,
                                           return_iters=True)
            s = sweeps.long().sum(0)
            self.sweeps = s if self.sweeps is None else self.sweeps + s
        else:
            prim, t, hit = self.fn(scene, accel, o, d, t_min)
        end.record()
        self.events.append((start, end))
        self.rays += o.shape[0]
        return prim, t, hit

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def frame_stats(scene, cam, cfg, key, accel, intersect_fn=None):
    """The wavefront frame in chunks of ``WAVE_RAYS``, as ``render_image``
    traces it, with the segments: (per-pixel mean radiance (P, 3),
    per-pixel segments (P,)), pixels bottom row first."""
    rad, segs = [], []
    for lo in range(0, cfg.num_rays, WAVE_RAYS):
        ids = torch.arange(lo, min(lo + WAVE_RAYS, cfg.num_rays),
                           device=scene.device)
        r, sg = render_ray_batch(scene, cam, cfg, key, ids, accel,
                                 intersect_fn, return_stats=True)
        rad.append(r)
        segs.append(sg)
    rad = torch.cat(rad).reshape(-1, cfg.spp, 3).mean(dim=1)
    segs = torch.cat(segs).reshape(-1, cfg.spp).sum(dim=1)
    return rad, segs


def camera_rays(scene, cam, cfg, key, num_rays):
    ids = torch.arange(num_rays, device=scene.device)
    return generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))


def same_hits(what, got, want):
    """Hit masks and primitives equal, t within 1e-6 relative; returns the
    largest |t| difference on the hits."""
    p1, t1, h1 = got
    p2, t2, h2 = want
    if not (torch.equal(h1, h2) and torch.equal(p1, p2)):
        raise AssertionError(f"{what}: hits or primitives differ "
                             f"({int((p1 != p2).sum())} rays)")
    err = float((t1[h1] - t2[h1]).abs().max()) if bool(h1.any()) else 0.0
    rel = float(((t1[h1] - t2[h1]).abs() / t2[h1]).max()) if bool(
        h1.any()) else 0.0
    if not rel <= 1e-6:
        raise AssertionError(f"{what}: t off by {rel:.3g} relative")
    return err


def intersect_vs_plain(dev, key):
    """Phase 11.  Returns the largest t error of K4 and of K5 against their
    plain versions."""
    err4 = err5 = 0.0
    for preset, kw in CLUSTER_CASES:
        scene, cam, cfg = build_preset(preset, device=dev, **kw)
        g = torch.Generator().manual_seed(0)
        o = (torch.rand((4096, 3), generator=g) * 16 - 8).to(dev)
        d = torch.randn((4096, 3), generator=g)
        d = (d / d.norm(dim=1, keepdim=True)).to(dev)
        dense = ip.pack_scene_pallas(scene)
        line = []
        for label, rays in (("random", (o, d)),
                            ("camera", camera_rays(scene, cam, cfg, key,
                                                   cfg.num_rays))):
            before = ip.intersect_pallas.launches
            k4 = ip.intersect_pallas(scene, dense, *rays, 1e-3)
            torch.cuda.synchronize()
            if ip.intersect_pallas.launches != before + 1:
                raise AssertionError("K4's launch counter did not move")
            err4 = max(err4, same_hits(
                f"K4 {preset} {label}", k4,
                ip.intersect_pallas_reference(scene, dense, *rays, 1e-3)))
            for max_leaf in (1, 7, 128):
                pack = ic.pack_scene_clustered(scene, max_leaf=max_leaf)
                before = ic.intersect_clustered.launches
                k5 = ic.intersect_clustered(scene, pack, *rays, 1e-3)
                torch.cuda.synchronize()
                if ic.intersect_clustered.launches != before + 1:
                    raise AssertionError("K5's launch counter did not move")
                what = f"K5 {preset} {label} max_leaf {max_leaf}"
                err5 = max(err5, same_hits(
                    what, k5, ic.intersect_clustered_reference(
                        scene, pack, *rays, 1e-3)))
                same_hits(f"{what} vs K4", k5, k4)
            line.append(f"{label} {int(k4[2].sum())}/{rays[0].shape[0]} "
                        "hits")
        log(f"  {preset} {kw.get('n', '')}: K4 = plain, K5 (max_leaf 1, 7, "
            f"128) = plain = K4 ({', '.join(line)})")
    return err4, err5


def dense_wavefront_path(dev, key, card):
    """Phase 12.  Returns K4's entry of the kernels line."""
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        golden = json.load(f)[GOLDEN_KEY]
    pack = ip.pack_scene_pallas(scene)

    def frame(mode):
        return render_image(scene, cam, cfg, seed=0, accel=pack, mode=mode,
                            chunk=WAVE_RAYS, pool_size=WAVE_RAYS,
                            device=dev)

    imgs, launches = {}, {}
    for mode in ("regenerative", "wavefront"):
        reset_counts()
        imgs[mode] = frame(mode)
        torch.cuda.synchronize()
        launches[mode] = ip.intersect_pallas.launches
        img = imgs[mode]
        if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{mode}: bad image")
        total = float(img.double().sum()) * cfg.spp
        rel = abs(total - golden) / golden
        log(f"{mode} final scene {cfg.nx}x{cfg.ny}@{cfg.spp} through K4: "
            f"radiance sum {total:.1f} vs golden {golden:.1f} (rel "
            f"{rel:.2e}), K4 launches {launches[mode]}")
        if launches[mode] < 1:
            raise AssertionError(f"the {mode} render did not launch K4")
        if not rel < 1e-2:
            raise AssertionError(f"{mode}: radiance sum off golden ({rel})")
    diff = float((imgs["regenerative"] - imgs["wavefront"]).abs().max())
    log(f"  regenerative vs wavefront: max |a - b| = {diff:.3e} (bound 2e-6)")
    if not diff <= 2e-6:
        raise AssertionError("regenerative and wavefront images differ")
    mega = mk.render_image_mega(scene, cam, cfg, seed=0, device=dev)
    kdiff = (imgs["wavefront"] - mega).abs()
    log(f"  against K1's image: frac(|a-b|>1e-3)="
        f"{float((kdiff > 1e-3).float().mean()):.6f} (logged: K1 uses the "
        f"expanded quadratic)")
    del mega, kdiff

    # Ray ids [0, 2^17): K4, its plain version and the dense sweep.
    ids = torch.arange(WAVE_RAYS, device=dev)
    r4, s4 = render_ray_batch(scene, cam, cfg, key, ids, pack,
                              return_stats=True)
    rp, sp = render_ray_batch(scene, cam, cfg, key, ids, pack,
                              ip.intersect_pallas_reference,
                              return_stats=True)
    if not (torch.equal(r4, rp) and torch.equal(s4, sp)):
        raise AssertionError("K4's and its plain version's paths differ")
    rb, sb = render_ray_batch(scene, cam, cfg, key, ids, return_stats=True)
    whole = WAVE_RAYS // cfg.spp * cfg.spp  # the rays of whole pixels
    px = lambda r: r[:whole].reshape(-1, cfg.spp, 3).mean(1)  # noqa: E731
    bdiff = (px(r4) - px(rb)).abs()
    frac = float((bdiff > 1e-3).float().mean())
    seg_rel = abs(int(s4.sum()) - int(sb.sum())) / int(sb.sum())
    log(f"  rays [0, {WAVE_RAYS}): K4 = its plain version (radiance and "
        f"segments); vs the dense sweep over {whole // cfg.spp} whole "
        f"pixels frac(|a-b|>1e-3)={frac:.6f}, "
        f"segments {int(s4.sum())} vs {int(sb.sum())} (rel {seg_rel:.2e})")
    if not (frac < 0.01 and seg_rel <= 1e-3):
        raise AssertionError("K4's paths off the dense sweep's")

    # The tape of those rays through K4.
    tape = record_paths_pool(scene, cam, cfg, key, ids, pack,
                             ip.intersect_pallas, pool_size=1 << 14)
    o, d = camera_rays(scene, cam, cfg, key, WAVE_RAYS)
    plain = record_paths(scene, o, d, ids, key, cfg, pack,
                         ip.intersect_pallas_reference)
    if not torch.equal(tape, plain):
        raise AssertionError("the pool tape through K4 differs from the "
                             "plain wavefront record_paths")
    k2b = rm.record_paths_mega(mk.pack_scene_mega(scene), cam, cfg, key,
                               num_rays=WAVE_RAYS)
    tape_agreement("  the pool tape through K4 (= plain record_paths on "
                   "K4's plain version) vs K2b's", tape, k2b, 0.999)
    tape_agreement("  the pool tape through K4 vs the plain record_paths on "
                   "the dense sweep", tape,
                   record_paths(scene, o, d, ids, key, cfg), 0.999)
    del tape, plain, k2b

    # Times: frames, then K4 over a whole frame and per launch.
    sec = {}  # the frames above were the warm runs
    for mode in ("regenerative", "wavefront"):
        sec[mode] = statistics.median(host_s(lambda: frame(mode))[0]
                                      for _ in range(3))
    clocks = {mode: Clocked(ip.intersect_pallas)
              for mode in ("regenerative", "wavefront")}
    render_image(scene, cam, cfg, seed=0, accel=pack,
                 intersect_fn=clocks["regenerative"], mode="regenerative",
                 pool_size=WAVE_RAYS, device=dev)
    _, segs = frame_stats(scene, cam, cfg, key, pack, clocks["wavefront"])
    rays = int(segs.sum())
    o, d = camera_rays(scene, cam, cfg, key, WAVE_RAYS)
    k4_ms = cuda_ms(lambda: ip.intersect_pallas(scene, pack, o, d, 1e-3), 5)
    plain_s, _ = host_s(lambda: ip.intersect_pallas_reference(
        scene, pack, o, d, 1e-3))
    b1 = k4_bound(pack, WAVE_RAYS)
    for mode in ("regenerative", "wavefront"):
        c = clocks[mode]
        ms = c.ms()
        fb = k4_bound(pack, c.rays, len(c.events))
        log(f"{mode}: {sec[mode]:.4f} s/frame median of 3, "
            f"{cfg.num_rays / sec[mode] / 1e6:.3f} Mpaths/s, "
            f"{rays / sec[mode] / 1e6:.3f} Mrays/s ({rays} segments); K4 "
            f"{len(c.events)} launches over {c.rays} rays, {ms:.2f} ms per "
            f"frame ({ms / len(c.events) * 1e3:.1f} us per launch; bound "
            f"{fb[0]:.3f} ms, {fb[1]}), {ms / 1e3 / sec[mode] * 100:.2f}% "
            f"of the frame; on {card}")
    log(f"  K4 alone at {WAVE_RAYS} camera rays: {k4_ms:.4f} ms (bound "
        f"{b1[0]:.4f} ms, {b1[1]}); plain {plain_s * 1e3:.1f} ms (one run)")
    c = clocks["regenerative"]
    return {"name": "K4 dense closest hit (intersect_pallas), 2^17 rays of "
                    "the final scene",
            "route": "cuda",
            "source": "first_raytracer_tpu_torch/kernels/csrc/intersect.cu",
            "replaces": ip.REPLACES, "launches": launches["regenerative"],
            "launches_wavefront": launches["wavefront"], "max_abs_err": None,
            "ms": k4_ms, "plain_ms": plain_s * 1e3, "bound_ms": b1[0],
            "bound_by": b1[1], "library_ms": None,
            "frame_ms": c.ms(),
            "frame_bound_ms": k4_bound(pack, c.rays, len(c.events))[0]}


FIELD_WAVE = [("field20000", "sphere-field", 20000,
               "radiance_sum_megacluster_field20000_800x450_4spp"),
              ("trifield20000", "triangle-field", 20000,
               "radiance_sum_megacluster_trifield20000_800x450_4spp")]


def clustered_wavefront_path(dev, key, card):
    """Phase 13.  Returns K5's entry of the kernels line."""
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        goldens = json.load(f)
    launches, entry = 0, None
    for label, preset, n, gkey in FIELD_WAVE:
        scene, cam, cfg = build_preset(preset, device=dev, n=n)
        pack_s = statistics.median(host_s(
            lambda: ic.pack_scene_clustered(scene))[0] for _ in range(3))
        cpack = ic.pack_scene_clustered(scene)

        def frame():
            return render_image(scene, cam, cfg, seed=0,
                                accel=ic.pack_scene_clustered(scene),
                                chunk=WAVE_RAYS, device=dev)

        reset_counts()
        img = frame()
        torch.cuda.synchronize()
        frame_launches = ic.intersect_clustered.launches
        launches += frame_launches
        if frame_launches < 1 or ip.intersect_pallas.launches:
            raise AssertionError(f"{label}: the frame did not go through K5")
        if tuple(img.shape) != (cfg.ny, cfg.nx, 3) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{label}: bad image")
        total = float(img.double().sum()) * cfg.spp
        rel = (total - goldens[gkey]) / goldens[gkey]
        log(f"{label} {cfg.nx}x{cfg.ny}@{cfg.spp} wavefront through K5: "
            f"radiance sum {total:.3f}, megacluster golden {goldens[gkey]} "
            f"(rel {rel:+.3e}, logged: the oc-form and the expanded "
            f"quadratic part far out), K5 launches {frame_launches}")
        sec = statistics.median(host_s(frame)[0] for _ in range(3))
        clock = Clocked(ic.intersect_clustered, counters=True)
        rad5, segs5 = frame_stats(scene, cam, cfg, key, cpack, clock)
        k5_frame_ms = clock.ms()
        rad_img = rad5.reshape(cfg.ny, cfg.nx, 3).flip(0)
        if not torch.equal(rad_img, img):
            raise AssertionError(f"{label}: the counted frame differs")
        dpack = ip.pack_scene_pallas(scene)
        clock4 = Clocked(ip.intersect_pallas)
        rad4, segs4 = frame_stats(scene, cam, cfg, key, dpack, clock4)
        diff = (rad5 - rad4).abs()
        frac = float((diff > 1e-3).float().mean())
        differ = int((diff > 0).any(dim=1).sum())
        if preset == "triangle-field":
            seg_bad = float((segs5 != segs4).float().mean())
            seg_note = f"pixels whose segments differ {seg_bad:.6f}"
            seg_ok = seg_bad < 0.01
        else:
            seg_rel = abs(int(segs5.sum()) - int(segs4.sum())) / int(
                segs4.sum())
            seg_note = (f"segments {int(segs5.sum())} vs {int(segs4.sum())}"
                        f" (rel {seg_rel:.2e})")
            seg_ok = seg_rel <= 1e-3
        log(f"  K5 vs K4 frame: frac(|a-b|>1e-3)={frac:.6f}, {differ} pixels"
            f" differ at all, {seg_note}")
        if not (frac < 0.01 and seg_ok):
            raise AssertionError(f"{label}: K5's frame off K4's")
        rays = int(segs5.sum())
        fb = k5_bound(cpack, clock.sweeps.tolist(), clock.rays,
                      len(clock.events))
        tot = clock.sweeps.tolist()
        o, d = camera_rays(scene, cam, cfg, key, WAVE_RAYS)
        k5_ms = cuda_ms(lambda: ic.intersect_clustered(scene, cpack, o, d,
                                                       1e-3), 5)
        *_, sw1 = ic.intersect_clustered(scene, cpack, o, d, 1e-3,
                                         return_iters=True)
        b1 = k5_bound(cpack, sw1.long().sum(0).tolist(), WAVE_RAYS)
        plain_s, want = host_s(lambda: ic.intersect_clustered_reference(
            scene, cpack, o, d, 1e-3))
        err = same_hits(f"K5 {label} at {WAVE_RAYS} camera rays",
                        ic.intersect_clustered(scene, cpack, o, d, 1e-3),
                        want)
        k4_ms = cuda_ms(lambda: ip.intersect_pallas(scene, dpack, o, d,
                                                    1e-3), 3)
        log(f"  {sec:.4f} s/frame median of 3 ({cfg.num_rays / sec / 1e6:.3f}"
            f" Mpaths/s, {rays / sec / 1e6:.3f} Mrays/s, {rays} segments); "
            f"host pack {pack_s:.4f} s; K5 {len(clock.events)} launches over "
            f"{clock.rays} rays, {k5_frame_ms:.2f} ms per frame (bound "
            f"{fb[0]:.3f} ms, {fb[1]}), per ray "
            f"{tot[0] / clock.rays:.2f} clusters swept, "
            f"{tot[1] / clock.rays:.1f} sphere and "
            f"{tot[2] / clock.rays:.1f} triangle slots, "
            f"{tot[3] / clock.rays:.1f} boxes; K4 on the same frame "
            f"{clock4.ms():.2f} ms; on {card}")
        log(f"  at {WAVE_RAYS} camera rays: K5 {k5_ms:.4f} ms (bound "
            f"{b1[0]:.4f} ms, {b1[1]}), plain {plain_s * 1e3:.1f} ms (one "
            f"run), K4 {k4_ms:.4f} ms")
        if label == "field20000":
            entry = {
                "name": "K5 clustered closest hit (intersect_clustered), "
                        "2^17 camera rays of field20000",
                "route": "cuda",
                "source": "first_raytracer_tpu_torch/kernels/csrc/"
                          "intersect.cu",
                "replaces": ic.REPLACES, "max_abs_err": err, "ms": k5_ms,
                "plain_ms": plain_s * 1e3, "bound_ms": b1[0],
                "bound_by": b1[1], "library_ms": None,
                "frame_ms": k5_frame_ms, "frame_bound_ms": fb[0]}
        del rad4, rad5, img, dpack, cpack
        torch.cuda.empty_cache()
    entry["launches"] = launches
    return entry


def main():
    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(card)

    build()  # 2.
    key = rng.base_key(0)
    k1, scene, cam, cfg, pack = render_path(dev, key, card)  # 3, 4.
    log("K2 and K2b vs plain:")
    k2_launches = tape_kernels_vs_plain(dev, key, card, scene, cam, cfg,
                                        pack)  # 5.
    g = grad_path(dev, key, card, scene, cam, cfg, pack)  # 6.
    fit_cli(card)  # 7.
    del scene, pack
    torch.cuda.empty_cache()
    log("K3 vs plain:")
    clustered_vs_plain(dev, key, card)  # 8.
    k3_launches, fields, scenes = large_scene_path(dev, key, card)  # 9.
    log("K3t and the clustered fit step:")
    t10 = clustered_tapes_and_step(dev, key, card, scenes)  # 10.
    del scenes
    torch.cuda.empty_cache()
    log("K4 and K5 vs plain:")
    err4, err5 = intersect_vs_plain(dev, key)  # 11.
    k4 = dense_wavefront_path(dev, key, card)  # 12.
    k4["max_abs_err"] = err4
    k5 = clustered_wavefront_path(dev, key, card)  # 13.
    k5["max_abs_err"] = max(err5, k5["max_abs_err"])

    src = "first_raytracer_tpu_torch/kernels/csrc/"
    f20 = fields["field20000"]
    log(json.dumps({"kernels": [k1, {
        "name": "K2 megakernel with tape (render_pixels_mega "
                "emit_tape=True)",
        "route": "cuda", "source": src + "megakernel.cu",
        "replaces": mk.REPLACES, "launches": k2_launches,
        "max_abs_err": g["err2"], "tape_agreement": g["agree2"],
        "ms": g["k2_ms"],
        "plain_ms": g["plain2_ms"], "bound_ms": g["k2_bound"][0],
        "bound_by": g["k2_bound"][1], "library_ms": None}, {
        "name": "K2b standalone recorder (record_paths_mega)",
        "route": "cuda", "source": src + "megakernel.cu",
        "replaces": rm.REPLACES, "launches": g["launches"]["K2b"],
        "max_abs_err": g["err_b"], "tape_agreement": g["agree_b"],
        "ms": g["kb_ms"],
        "plain_ms": g["plain_b_ms"], "bound_ms": g["kb_bound"][0],
        "bound_by": g["kb_bound"][1], "library_ms": None}, {
        "name": "K3 clustered megakernel (render_pixels_mega_clustered), "
                "field20000 800x450@4 (plain_ms: a quarter of the pixels)",
        "route": "cuda", "source": src + "megakernel_clustered.cu",
        "replaces": mc.REPLACES, "launches": k3_launches,
        "max_abs_err": f20["err"], "ms": f20["ms"],
        "plain_ms": f20["plain_ms"],
        "bound_ms": f20["bound"][0], "bound_by": f20["bound"][1],
        "library_ms": None}, {
        "name": "K3t clustered recorder (record_paths_mega_clustered), "
                "2^17 rays of field5000",
        "route": "cuda", "source": src + "megakernel_clustered.cu",
        "replaces": mc.REPLACES, "launches": t10["launches"],
        "max_abs_err": t10["trips_err"], "tape_agreement": t10["agree"],
        "tape_agreement_with_k2b": t10["agree_k2b"], "ms": t10["ms"],
        "plain_ms": t10["plain_ms"], "bound_ms": t10["bound"][0],
        "bound_by": t10["bound"][1], "library_ms": None}, k4, k5]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
