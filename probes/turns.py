"""K1-K5 in one checkout, for comparing two commits on one card.

For each kernel named: its ptxas line (registers, spills) and the SASS
instruction count of its functions (``cuobjdump -sass``), then its CUDA-event
times, median of the repeats after a warm launch:

- k1: K1 on the final scene (1200x800 @ 10);
- k2: K2 on the pixels of the final scene's first 2^17 ray ids;
- k2b: K2b on those ray ids (the gradient step's record) and over the
  whole frame (9.6 M ray ids, past the card's resident lanes);
- k3: K3 on field20000, field5000 and trifield20000 (800x450 @ 4);
- k3t: K3t on the first 2^17 ray ids of field5000 (the clustered fit
  step's record) and of field20000;
- chain: K2b (final scene) and K3t (field5000, field20000) at 2^17 rays
  with the depth cap at 50 (the scenes' own), 20, 10 and 5, queued: how
  much of a launch waits on its deepest paths' serial segments;
- lone: the deepest path among those 2^17 ray ids, recorded alone by a
  launch of that one ray id (queued): the latency of one path's chain of
  segments, and for K3t its counters per segment (boxes tested, clusters
  opened); with the paths' depths at 2^17 rays;
- k4: K4 at 2^17 camera rays of the final scene, and over one regenerative
  frame of it (pool 2^17);
- k5: K5 at 2^17 camera rays of field20000 and of trifield20000, and over
  one wavefront frame of field20000 (chunks of 2^17);
- k6: K6, the flat-BVH walk (``build_bvh(max_leaf=4)``), at 2^17 camera
  rays of the final scene, at one bounce's secondary rays from their hits,
  at 2^17 camera rays of field5000, field20000 and trifield20000 (each
  with a digest of (prim, t, hit, counters) and the path it took where the
  checkout has two), over one regenerative frame's calls (pool 2^17); the
  BVH pool frame (s/frame, median of 3) and ``entry()``'s forward (s,
  median of 5);
- frames: the whole frames those kernels serve, host clock around
  ``render_image`` and a synchronize, median of 3 after a warm frame: the
  final scene regenerative (pool 2^17, K4), field20000 and trifield20000
  wavefront (chunks of 2^17, K5).

K4 and K5 take 0.05-0.2 ms a launch, less than the host's cost of one call
of their wrappers, so the wrapper's calls are captured in a CUDA graph and
the graph's replays timed: 20 calls at 2^17 rays; for a frame, every batch
the frame hands its intersector, recorded once and captured back to back.
The sum of events around each call of the frame (the wrapper's host time
included, as ``chip_smoke.py`` clocks a frame) is printed beside it.

Run from the repository root on a GPU host, each checkout in its own
process, in turns (parent, change, change, parent):

    git archive <parent> | tar -x -C out/parent
    for t in out/parent . . out/parent; do
        PYTHONPATH=. python probes/turns.py $t k1 k2 k2b k3 k3t k4 k5; done

The checkout's own package is imported (its path goes first on sys.path),
so the parent is measured with its own kernels and wrappers.  For K2b and
K3t at 2^17 rays the time per call of 10 calls queued back to back between
two events is printed too (at under a millisecond a call, the wrapper's
host work is a part of an eager call's events).  For K2b and K3t each
shape also prints a digest of the outputs that must not depend on
the schedule (tape, trips, K3t's per-ray counters), to compare the two
checkouts bit for bit, and the warp lane efficiency: trips over 32 x the
warps' steps (K3t's ``sweeps[:, 5]``; K2b's ``steps`` output where the
checkout's recorder has one, else the steps of its one-shot grid, whose
warps hold 32 consecutive ray ids each until the deepest path ends).  The
ptxas lines come with the blocks an SM holds at that register count
(shared memory is not the limit of these kernels).
"""
import dataclasses
import functools
import hashlib
import inspect
import os
import re
import statistics
import subprocess
import sys
import time

CHECKOUT = sys.argv[1]
sys.path.insert(0, CHECKOUT)

import torch  # noqa: E402
from torch.utils.cpp_extension import CUDA_HOME  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import record_mega as rm  # noqa: E402
from first_raytracer_tpu_torch.render.api import render_image  # noqa: E402
from first_raytracer_tpu_torch.render.camera import generate_rays  # noqa: E402,E501

# A frame whose intersector is a Python wrapper (``Recorded``, ``Clocked``)
# runs eagerly, where the checkout's render_image can be asked to.
EAGER = ({"graphed": False} if "graphed" in inspect.signature(
    render_image).parameters else {})
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501
from first_raytracer_tpu_torch.utils.roofline import (bound,  # noqa: E402
                                                      clustered_bound)

RAYS = 1 << 17
# Kernel -> the function names of its entries in the library.
ENTRIES = {"k1": ("mega_kernelILb0",), "k2": ("mega_kernelILb1",),
           "k2b": ("record_kernel",),
           "k3": ("mega_clustered_kernel",),
           "k3t": ("record_clustered_kernel",),
           "chain": ("record_kernel", "record_clustered_kernel"),
           "lone": ("record_kernel", "record_clustered_kernel"),
           "k4": ("intersect_dense_kernel",),
           "k5": ("intersect_clustered_kernel",),
           "k6": ("bvh_walk_kernel",), "frames": ()}


def say(*parts):
    print(CHECKOUT, *parts, flush=True)


def event_ms(fn, repeats):
    """Median and sorted CUDA-event milliseconds of ``fn`` after a warm
    call."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), [round(t, 5) for t in sorted(times)]


def queued_ms(fn, repeats, calls=10):
    """Median and sorted milliseconds per call of ``fn``: ``calls`` calls
    queued back to back between two events."""
    med, times = event_ms(lambda: [fn() for _ in range(calls)], repeats)
    return med / calls, [round(t / calls, 5) for t in times]


def graph_ms(fn, repeats, inner=1):
    """Median and sorted milliseconds per call of ``fn``: ``inner`` calls
    captured in one CUDA graph, its replays timed by events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    med, times = event_ms(graph.replay, repeats)
    return med / inner, [round(t / inner, 5) for t in times]


class Clocked:
    """An ``intersect_fn`` that records CUDA events around each call."""

    def __init__(self, fn):
        self.fn, self.events = fn, []

    def __call__(self, scene, accel, o, d, t_min):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(scene, accel, o, d, t_min)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


class Recorded:
    """An ``intersect_fn`` that keeps a copy of every batch it is handed."""

    def __init__(self, fn):
        self.fn, self.batches = fn, []

    def __call__(self, scene, accel, o, d, t_min):
        self.batches.append((o.clone(), d.clone(), t_min))
        return self.fn(scene, accel, o, d, t_min)

    def replay_ms(self, scene, accel):
        """The batches through ``fn`` back to back in one CUDA graph:
        median of 3 replays."""
        return graph_ms(lambda: [self.fn(scene, accel, o, d, t)
                                 for o, d, t in self.batches], 3)


def frame_ms(fn, render, scene, accel, what):
    """``fn`` over the frame ``render(intersect_fn)`` draws: the batches
    replayed back to back, and the per-call event sums of three frames."""
    rec = Recorded(fn)
    render(rec)
    say(f"{what} replayed ms", *rec.replay_ms(scene, accel), "launches",
        len(rec.batches), "rays", sum(o.shape[0] for o, _, _ in
                                      rec.batches))
    del rec
    sums = []
    for _ in range(3):
        clock = Clocked(fn)
        render(clock)
        sums.append(clock.ms())
    say(f"{what} per-call events ms", statistics.median(sums), sorted(sums))


def camera_rays(scene, cam, cfg):
    ids = torch.arange(RAYS, device=scene.device)
    return generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(rng.base_key(0), ids))


def code(info, kernels):
    """The ptxas register lines and SASS instruction counts of the named
    kernels' entries."""
    entry = None
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif ("registers" in line or "spill" in line) and entry and any(
                n in entry for k in kernels for n in ENTRIES[k]):
            text = line.split(":", 1)[-1].strip()
            regs = re.search(r"Used (\d+) registers", text)
            say("ptxas", entry[:60], text, *(
                ["blocks/SM by registers", blocks_per_sm(int(regs[1]))]
                if regs else []))
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", info.path],
        capture_output=True, text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        if any(n in name for k in kernels for n in ENTRIES[k]):
            say("SASS", name[:60], "instructions",
                len(re.findall(r"/\*[0-9a-f]{4}\*/", body)))


def blocks_per_sm(regs, threads=128):
    """Blocks of ``threads`` an H100 SM holds at ``regs`` registers a
    thread: 65,536 registers, allocated per warp in units of 256, and at
    most 64 warps and 32 blocks."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // (per_warp * warps), 64 // warps, 32)


def digest(*tensors):
    """A short hash of the tensors' bytes, to compare two checkouts."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k1():
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(0)
    say("K1 final scene ms", *event_ms(
        lambda: mk.render_pixels_mega(pack, cam, cfg, key), 5))


def k2():
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(0)
    say("K2 2^17 rays ms", *event_ms(
        lambda: mk.render_pixels_mega(pack, cam, cfg, key,
                                      num_pixels=-(-RAYS // cfg.spp),
                                      emit_tape=True), 5))


def k2b():
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(0)
    with_steps = "return_steps" in inspect.signature(
        rm._launch_record).parameters
    for label, n in (("2^17 rays", RAYS), ("full frame", cfg.num_rays)):
        call = functools.partial(rm.record_paths_mega, pack, cam, cfg, key,
                                 num_rays=n)
        say(f"K2b {label} ms", *event_ms(call, 5))
        if n == RAYS:
            say(f"K2b {label} queued ms", *queued_ms(call, 5))
        if with_steps:
            tape, its, steps = rm._launch_record(
                pack, mk.camera_table(cam).to(pack.device), cfg, key, 0, n,
                cfg.spp, return_steps=True)
        else:
            tape, its = rm.record_paths_mega(pack, cam, cfg, key, num_rays=n,
                                             return_iters=True)
            steps = mk.pixel_lane_steps(its)
        trips = int(its.long().sum())
        say(f"K2b {label} outputs", digest(tape, its), "lane efficiency",
            trips / (32 * int(steps.long().sum())), "trips", trips,
            "deepest", int(its.max()), "bound ms",
            *bound(pack, trips, 4 * (cfg.max_depth + 2) * n))
        del tape
        torch.cuda.empty_cache()


def k3():
    for label, preset, n in (("field20000", "sphere-field", 20000),
                             ("field5000", "sphere-field", 5000),
                             ("trifield20000", "triangle-field", 20000)):
        scene, cam, cfg = build_preset(preset, device="cuda", n=n)
        pack = mc.pack_scene_mega_clustered(scene, cam)
        key = rng.base_key(0)
        say(f"K3 {label} ms", *event_ms(
            lambda: mc.render_pixels_mega_clustered(pack, cam, cfg, key), 5))


def k3t():
    for n in (5000, 20000):
        scene, cam, cfg = build_preset("sphere-field", device="cuda", n=n)
        pack = mc.pack_scene_mega_clustered(scene, cam)
        key = rng.base_key(0)
        call = functools.partial(rm.record_paths_mega_clustered, pack, cam,
                                 cfg, key, num_rays=RAYS)
        say(f"K3t field{n} 2^17 rays ms", *event_ms(call, 5))
        say(f"K3t field{n} 2^17 rays queued ms", *queued_ms(call, 5))
        tape, its, sweeps = rm.record_paths_mega_clustered(
            pack, cam, cfg, key, num_rays=RAYS, return_iters=True)
        trips = int(its.long().sum())
        say(f"K3t field{n} outputs", digest(tape, its, sweeps[:, :4]),
            "lane efficiency", trips / (32 * int(sweeps[:, 5].long().sum())),
            "trips", trips, "deepest", int(its.max()), "bound ms",
            *clustered_bound(pack, sweeps, 4 * (cfg.max_depth + 6) * RAYS))


def chain():
    scenes = [("K2b final scene", "random-spheres", {}, False)] + [
        (f"K3t field{n}", "sphere-field", {"n": n}, True)
        for n in (5000, 20000)]
    for label, preset, kw, clustered in scenes:
        scene, cam, cfg = build_preset(preset, device="cuda", **kw)
        pack = (mc.pack_scene_mega_clustered(scene, cam) if clustered else
                mk.pack_scene_mega(scene))
        record = (rm.record_paths_mega_clustered if clustered else
                  rm.record_paths_mega)
        for depth in (50, 20, 10, 5):
            c = dataclasses.replace(cfg, max_depth=depth)
            call = functools.partial(record, pack, cam, c, rng.base_key(0),
                                     num_rays=RAYS)
            say(f"{label} 2^17 rays depth cap {depth} queued ms",
                *queued_ms(call, 5))


def lone():
    scenes = [("K2b final scene", "random-spheres", {}, False)] + [
        (f"K3t field{n}", "sphere-field", {"n": n}, True)
        for n in (5000, 20000)]
    for label, preset, kw, clustered in scenes:
        scene, cam, cfg = build_preset(preset, device="cuda", **kw)
        key = rng.base_key(0)
        if clustered:
            pack = mc.pack_scene_mega_clustered(scene, cam)
            _, its, sweeps = rm.record_paths_mega_clustered(
                pack, cam, cfg, key, num_rays=RAYS, return_iters=True)
        else:
            pack = mk.pack_scene_mega(scene)
            _, its = rm.record_paths_mega(pack, cam, cfg, key,
                                          num_rays=RAYS, return_iters=True)
        record = (rm.record_paths_mega_clustered if clustered else
                  rm.record_paths_mega)
        deep = int(its.argmax())
        say(f"{label} 2^17 rays: paths of 20+ segments",
            int((its >= 20).sum()), "of 40+", int((its >= 40).sum()),
            "at the cap", int((its == cfg.max_depth + 1).sum()))
        call = functools.partial(record, pack, cam, cfg, key, ray0=deep,
                                 num_rays=1)
        say(f"{label} ray {deep} ({int(its[deep])} segments) alone queued ms",
            *queued_ms(call, 5))
        if clustered:
            n = int(its[deep])
            say(f"{label} ray {deep} per segment: clusters opened",
                int(sweeps[deep, 0]) / n, "sphere slots",
                int(sweeps[deep, 1]) / n, "boxes", int(sweeps[deep, 3]) / n,
                "; all 2^17 rays:", *(int(v) / int(its.sum()) for v in
                                     sweeps[:, :4].long().sum(0)))


def k4():
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = ip.pack_scene_pallas(scene)
    o, d = camera_rays(scene, cam, cfg)
    say("K4 2^17 camera rays ms", *graph_ms(
        lambda: ip.intersect_pallas(scene, pack, o, d, 1e-3), 11, 20))
    frame_ms(ip.intersect_pallas, lambda fn: render_image(
        scene, cam, cfg, seed=0, accel=pack, intersect_fn=fn, **EAGER,
        mode="regenerative", pool_size=RAYS, device="cuda"), scene, pack,
        "K4 regenerative frame")


def k5():
    for label, preset in (("field20000", "sphere-field"),
                          ("trifield20000", "triangle-field")):
        scene, cam, cfg = build_preset(preset, device="cuda", n=20000)
        pack = ic.pack_scene_clustered(scene)
        o, d = camera_rays(scene, cam, cfg)
        say(f"K5 {label} 2^17 camera rays ms", *graph_ms(
            lambda: ic.intersect_clustered(scene, pack, o, d, 1e-3), 11, 20))
        if label != "field20000":
            continue
        *_, sweeps = ic.intersect_clustered(scene, pack, o, d, 1e-3,
                                            return_iters=True)
        say(f"K5 {label} per camera ray: boxes",
            float(sweeps[:, 3].float().mean()), "clusters swept",
            float(sweeps[:, 0].float().mean()))
        frame_ms(ic.intersect_clustered, lambda fn: render_image(
            scene, cam, cfg, seed=0, accel=pack, intersect_fn=fn, **EAGER,
            chunk=RAYS, device="cuda"), scene, pack, f"K5 {label} frame")


def k6():
    from first_raytracer_tpu_torch.accel import traverse
    from first_raytracer_tpu_torch.accel.build import build_bvh
    from first_raytracer_tpu_torch.entry import entry
    from first_raytracer_tpu_torch.materials.scatter import scatter
    from first_raytracer_tpu_torch.render.integrator import recompute_hit

    path = getattr(traverse, "walk_path", lambda *a: "one")
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    bvh = build_bvh(scene, max_leaf=4)
    o, d = (t.contiguous() for t in camera_rays(scene, cam, cfg))
    prim, _, hit = traverse.intersect_bvh(scene, bvh, o, d, 1e-3)
    _, p, n, mat = recompute_hit(scene, o, d, prim, 1e-3)
    ids = torch.arange(RAYS, device="cuda")
    new_d, _, ok = scatter(scene, mat, d, p, n,
                           rng.bounce_uniforms(rng.base_key(0), ids, 0))
    live = hit & ok
    sets = [("final scene 2^17 camera rays", scene, bvh, o, d),
            (f"final scene {int(live.sum())} bounce rays", scene, bvh,
             p[live].contiguous(), new_d[live].contiguous())]
    for label, preset, n_prims in (("field5000", "sphere-field", 5000),
                                   ("field20000", "sphere-field", 20000),
                                   ("trifield20000", "triangle-field",
                                    20000)):
        sc, c, cf = build_preset(preset, device="cuda", n=n_prims)
        sets.append((f"{label} 2^17 camera rays", sc,
                     build_bvh(sc, max_leaf=4),
                     *(t.contiguous() for t in camera_rays(sc, c, cf))))
    for label, sc, bv, so, sd in sets:
        out = traverse.intersect_bvh(sc, bv, so, sd, 1e-3,
                                     return_counters=True)
        say(f"K6 {label} ms", *graph_ms(
            lambda: traverse.intersect_bvh(sc, bv, so, sd, 1e-3), 11, 20),
            "path", path(sc, bv), "outputs", digest(*out))
    frame_ms(traverse.intersect_bvh, lambda fn: render_image(
        scene, cam, cfg, seed=0, accel=bvh, intersect_fn=fn, **EAGER,
        mode="regenerative", pool_size=RAYS, device="cuda"), scene, bvh,
        "K6 regenerative frame")
    say("BVH regenerative final scene s/frame", *host_s(
        lambda: render_image(scene, cam, cfg, seed=0, accel=bvh,
                             mode="regenerative", pool_size=RAYS,
                             device="cuda"), 3))
    fn, args = entry("cuda")
    say("entry() forward s", *host_s(lambda: fn(*args), 5))


def host_s(fn, repeats):
    """Median and sorted seconds of ``fn`` and all it queued, after a warm
    call."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), [round(t, 4) for t in sorted(times)]


def frames():
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = ip.pack_scene_pallas(scene)
    say("regenerative final scene s/frame", *host_s(lambda: render_image(
        scene, cam, cfg, seed=0, accel=pack, mode="regenerative",
        pool_size=RAYS, device="cuda"), 3))
    for label, preset in (("field20000", "sphere-field"),
                          ("trifield20000", "triangle-field")):
        scene, cam, cfg = build_preset(preset, device="cuda", n=20000)
        say(f"{label} wavefront s/frame", *host_s(lambda: render_image(
            scene, cam, cfg, seed=0, accel=ic.pack_scene_clustered(scene),
            chunk=RAYS, device="cuda"), 3))


def main():
    kernels = sys.argv[2:] or ["k1"]
    for k in kernels:
        if k not in ENTRIES:
            raise SystemExit(f"unknown kernel {k}: one of {list(ENTRIES)}")
    _, info = mk.load_mega_library()
    say("build", f"{info.seconds:.1f} s", "cached" if info.cached else "")
    code(info, kernels)
    for k in kernels:
        globals()[k]()


if __name__ == "__main__":
    main()
