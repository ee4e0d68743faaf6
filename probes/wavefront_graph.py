"""The wavefront loops as CUDA graphs against their eager runs, on one card.

``render/graphed.py`` replays the regenerative pool's passes and a chunk's
trips as CUDA graphs, ``PASSES_PER_READ`` passes a replay and one read of
the alive flag per replay; ``graphed=False`` runs the same bodies op by op.

1. Checks, at small size (random-spheres 96x64 @ 2, depth 50): through the
   dense sweep, K4 and K5, the pool (4096 slots) and the chunked batch
   (chunks of 2048), each graphed frame's radiance and segments
   ``torch.equal`` to the eager frame's; K4's or K5's launches of a graphed
   frame equal to the passes the cache ran, and the warm-up's block (the
   launches a capture records come back with every replay).  Any failure
   exits 1.
2. Times at full size, host clock around the frame and a synchronize:
   ``pool`` (the final scene, 1200x800 @ 10, through K4, a pool of 2^17),
   ``chunks`` (the same frame in chunks of 2^17), ``field`` (field20000,
   800x450 @ 4, through K5: chunks of 2^17, then a pool of 2^17).  For each
   frame, in turns: eager, graphed at each ``--reads`` value (passes per
   read), the same graphed runs in reverse order, eager; with each graphed
   run's passes, live passes, flag reads and launches, and each capture's
   warm-up and capture seconds and pool bytes.  ``--repeats`` frames a
   turn (median; the chunked frames once).

``--parts``: a pool pass of the final scene at 2^17 slots and its parts
(camera rays of every slot, the bounce draw, K4), each call in a CUDA
graph.  ``--checkout DIR`` runs another checkout's package; one from
before the graphs (no ``render/graphed.py``) times its eager frames only,
so a parent and this tree can be timed in turns in one call.

Run from the repository root on a GPU host:

    python probes/wavefront_graph.py --reads 1 2 4 8 --frames pool chunks field
    for t in out/parent . . out/parent; do python probes/wavefront_graph.py \
        --checkout $t --frames pool --reads 2 --no-checks; done

Prints JSON lines (one per check or turn); writes them to ``--out`` too.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), help="the checkout whose package runs "
    "(one without render/graphed.py times its eager frames only)")
ap.add_argument("--reads", type=int, nargs="+", default=[1, 2, 4, 8])
ap.add_argument("--frames", nargs="*", default=["pool", "chunks", "field"])
ap.add_argument("--repeats", type=int, default=3)
ap.add_argument("--checks", action=argparse.BooleanOptionalAction,
                default=True)
ap.add_argument("--parts", action="store_true",
                help="time a pool pass and its parts at 2^17 slots")
ap.add_argument("--out", default="out/wavefront_graph.jsonl")
ap.add_argument("--device", default="cuda",
                help="cpu: a rehearsal of the script (plain versions, no "
                     "graphs, nothing timed that a card would show)")
ARGS = ap.parse_args()
sys.path.insert(0, ARGS.checkout)

import torch  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501
try:
    from first_raytracer_tpu_torch.render import graphed  # noqa: E402
except ImportError:  # a checkout from before the graphs: eager only
    graphed = None
from first_raytracer_tpu_torch.render.api import render_ray_batch  # noqa: E402,E501
from first_raytracer_tpu_torch.render.regenerative import (  # noqa: E402
    render_rays_regenerative)
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501

LINES = []


def say(**kw):
    print(json.dumps(kw), flush=True)
    LINES.append(kw)


def launches():
    return ip.intersect_pallas.launches + ic.intersect_clustered.launches


def frame(scene, cam, cfg, accel, mode, size, **kw):
    """(radiance, segments) of every ray of the frame: the pool of ``size``
    slots, or chunks of ``size`` rays (the last padded, as render_rays)."""
    key = rng.base_key(0)
    total = cfg.num_rays
    if mode == "pool":
        return render_rays_regenerative(scene, cam, cfg, key, 0, total,
                                        accel, pool_size=size,
                                        return_stats=True, **kw)
    rad, segs = [], []
    for lo in range(0, total, size):
        ids = torch.arange(lo, lo + size, device=scene.device).clamp(
            max=total - 1)
        r, s = render_ray_batch(scene, cam, cfg, key, ids, accel,
                                return_stats=True, **kw)
        rad.append(r)
        segs.append(s)
    return torch.cat(rad)[:total], torch.cat(segs)[:total]


def sync():
    if ARGS.device == "cuda":
        torch.cuda.synchronize()


def run(fn):
    """Host seconds of ``fn`` and what it queued; its result; the cache's
    counters and the launches it made."""
    if graphed is not None:
        graphed.LOOPS.reset_counts()
    before = launches()
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    sec = time.perf_counter() - t0
    if graphed is None:
        return sec, out, dict(launches=launches() - before, captures=0)
    loops = graphed.LOOPS
    return sec, out, dict(passes=loops.passes, live=loops.live_passes,
                          reads=loops.syncs, captures=loops.captures,
                          warmups=loops.warmups, replays=loops.replays,
                          launches=launches() - before)


def checks():
    dev = torch.device(ARGS.device)
    scene, cam, cfg = build_preset("random-spheres", device=dev, nx=96,
                                   ny=64, spp=2)
    ok = True
    for label, accel in (("dense sweep", None),
                         ("K4", ip.pack_scene_pallas(scene)),
                         ("K5", ic.pack_scene_clustered(scene))):
        for mode, size in (("pool", 4096), ("chunks", 2048)):
            _, want, eager = run(lambda: frame(scene, cam, cfg, accel, mode,
                                               size, graphed=False))
            _, got, graph = run(lambda: frame(scene, cam, cfg, accel, mode,
                                              size))
            _, again, replay = run(lambda: frame(scene, cam, cfg, accel,
                                                 mode, size))
            equal = all(torch.equal(a, b) for a, b in zip(got, want)) and \
                all(torch.equal(a, b) for a, b in zip(again, want))
            # A warm-up runs one block eagerly, its launches real ones.
            counted = accel is None or dev.type == "cpu" or (
                graph["launches"] == graph["passes"] + graph["warmups"]
                * graphed.PASSES_PER_READ
                and replay["launches"] == replay["passes"])
            ok = ok and equal and counted
            say(check=f"{label} {mode}", equal=equal, launches_counted=counted,
                eager=eager, first=graph, second=replay,
                capture=graphed.LOOPS.last)
    if not ok:
        sys.exit(1)


def turns(label, scene, cam, cfg, accel, mode, size, repeats):
    def timed(kw):
        secs, out, stats, cap = [], None, None, None
        for _ in range(repeats):
            s, out, stats = run(lambda: frame(scene, cam, cfg, accel, mode,
                                              size, **kw))
            secs.append(s)
            cap = cap or (graphed.LOOPS.last if stats["captures"] else None)
        return secs, out, stats, cap

    order = [None] + ARGS.reads + ARGS.reads[::-1] + [None]
    if graphed is None:
        order = [None, None]
    want = None
    for k in order:
        kw = {} if graphed is None else dict(graphed=k is not None)
        if k is not None:
            graphed.PASSES_PER_READ = k
        secs, out, stats, cap = timed(kw)
        if want is None:
            want = out
        equal = all(torch.equal(a, b) for a, b in zip(out, want))
        say(frame=label, run="eager" if k is None else "graphed",
            checkout=ARGS.checkout, passes_per_read=graphed and (
                graphed.PASSES_PER_READ),
            s=statistics.median(secs), all_s=secs, equal_to_eager=equal,
            segments=int(out[1].long().sum()), capture=cap, **stats)
        if not equal:
            sys.exit(1)


def graph_ms(fn, inner=10, repeats=5):
    """Median ms a call of ``fn``: ``inner`` calls captured in one CUDA
    graph after a warm call, its replays timed by events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def parts(dev):
    """A pool pass of the final scene at 2^17 slots and its parts, each in
    a CUDA graph: the pass, the camera rays of every slot (Threefry's
    camera draw and ``generate_rays``), the bounce draw, K4."""
    from first_raytracer_tpu_torch.render import regenerative as reg
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    pack = ip.pack_scene_pallas(scene)
    key = rng.base_key(0).to(dev)
    C = 1 << 17
    ids = torch.arange(C, device=dev)
    depth = torch.zeros((C,), dtype=torch.int64, device=dev)
    o, d = reg._fresh_rays(cam, cfg, key, ids)
    inputs = dict(scene=scene, camera=cam, accel=pack, key=key,
                  start_id=torch.zeros((), dtype=torch.int64, device=dev))
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=C,
                  intersect_fn=ip.intersect_pallas)
    state = reg.pool_state(**inputs, **static)
    say(parts="final scene, 2^17 slots", ms=dict(
        pool_pass=graph_ms(lambda: reg.pool_pass(state, **inputs,
                                                 **static)),
        camera_rays=graph_ms(lambda: reg._fresh_rays(cam, cfg, key, ids)),
        bounce_draw=graph_ms(lambda: rng.bounce_uniforms(key, ids, depth)),
        k4=graph_ms(lambda: ip.intersect_pallas(scene, pack, o, d, 1e-3))))


def main():
    card = "cpu" if ARGS.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    if ARGS.checks and graphed is not None:
        checks()
    dev = torch.device(ARGS.device)
    if ARGS.parts:
        parts(dev)
    if {"pool", "chunks"} & set(ARGS.frames):
        scene, cam, cfg = build_preset("random-spheres", device=dev)
        pack = ip.pack_scene_pallas(scene)
        if "pool" in ARGS.frames:
            turns("final scene pool 2^17, K4", scene, cam, cfg, pack,
                  "pool", 1 << 17, ARGS.repeats)
        if "chunks" in ARGS.frames:
            turns("final scene chunks 2^17, K4", scene, cam, cfg, pack,
                  "chunks", 1 << 17, 1)
    if "field" in ARGS.frames:
        scene, cam, cfg = build_preset("sphere-field", device=dev, n=20000)
        pack = ic.pack_scene_clustered(scene)
        turns("field20000 chunks 2^17, K5", scene, cam, cfg, pack,
              "chunks", 1 << 17, ARGS.repeats)
        turns("field20000 pool 2^17, K5", scene, cam, cfg, pack, "pool",
              1 << 17, ARGS.repeats)
    os.makedirs(os.path.dirname(ARGS.out) or ".", exist_ok=True)
    with open(ARGS.out, "w") as f:
        for line in LINES:
            f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
