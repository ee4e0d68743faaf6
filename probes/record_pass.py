"""Phase 22 of ``chip_smoke.py`` alone (K11, K12 and K13 on the card), or
the recorders' graphed bodies and the direct step of one checkout, for
turns with another.

Without arguments: builds the kernels' library (phase 2: ptxas's
registers and spills of each kernel) and runs
``chip_smoke.record_pass_path``: K11 bit-equal to ``intersect_brute`` on
its sets, K12's three modes and K13 bit-equal to their plain versions
pass by pass on phase 21's seven sets, the main path's launches (the
direct step, the pool recorder, the occupancy scan) and its tapes and
counts against the plain route, the kernels' ms at 2^17 and bounds, and
the graphed bodies' ms and nodes.  Prints the phase's log and the
kernels' entries of the kernels line (a few minutes with the build).

With ``--turns CHECKOUT``: imports the package of ``CHECKOUT`` (a
directory holding ``first_raytracer_tpu_torch``, e.g. a parent unpacked
with ``git archive`` under ``out/``) and prints one JSON line of its
graphed times on the final scene at 2^17 rays (seed 0, zero target,
every field): a lockstep recorder bounce, a pool recorder pass (2^14
slots) and an occupancy length pass, each as one call captured in a CUDA
graph (its ms, median of 5 replays, and its nodes by ``cuGraphGetNodes``),
and the graphed direct step (``render_loss_and_grads``), lockstep
recorder, pool recorder (2^14 slots), occupancy scan (2^17 rays) and
field5000's direct step through K5 (s, the median of 3 after a warm
call); K11 (``dense_hit``) on the 2^17 camera rays with liveness masks
of live shares 1, 0.1 and 0.01 (20 calls a CUDA graph, the median of 5
replays; a checkout whose ``dense_hit`` takes no mask sweeps every ray)
and its bound from the rays it swept (``utils/roofline.py::k11_bound``);
the final scene's pool frame (2^17 slots) and chunked frame (chunks of
2^17) without an accel, graphed (s, the median of 3 after a warm call),
and K11's part of each: the same loop stepped op by op, each pass's K11
call on the pass's rays and mask timed in a CUDA graph of 10 calls
replayed on copies of them, summed over the pool frame's passes and over
the chunked frame's trips.  Run in turns, parent and change:

    mkdir -p out/parent && git archive <parent> | tar -x -C out/parent
    for t in out/parent . . out/parent; do
        python probes/record_pass.py --turns $t; done
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def graph_ms(torch, fn, repeats=5, inner=1):
    """Median ms of one call of ``fn``, ``inner`` calls captured in a CUDA
    graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_nodes(torch, fn):
    """Nodes of a CUDA graph of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return count.value


def host_s(torch, fn, repeats=3):
    """Median seconds of ``fn`` and what it queued, after a warm call."""
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


class K11Clock:
    """K11 timed on the rays and mask of one pass: copied into static
    buffers, then 10 calls captured once in a CUDA graph and replayed;
    ``total_ms`` sums a call's ms over the passes timed."""

    def __init__(self, torch, dense_hit, scene, t_min, n, masked):
        self.torch, self.total_ms, self.calls = torch, 0.0, 0
        dev = scene.sphere_center.device
        self.o = torch.zeros((n, 3), device=dev)
        self.d = torch.zeros((n, 3), device=dev)
        self.d[:, 2] = 1.0
        self.alive = torch.zeros((n,), dtype=torch.bool, device=dev)
        extra = (self.alive,) if masked else ()

        def call():
            dense_hit(scene, self.o, self.d, t_min, *extra)
        call()
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(10):
                call()

    def time(self, o, d, alive):
        torch = self.torch
        self.o.copy_(o)
        self.d.copy_(d)
        self.alive.copy_(alive)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        end.synchronize()
        self.total_ms += start.elapsed_time(end) / 10
        self.calls += 1


def k11_parts(torch, dh, scene, cam, cfg, key, masked):
    """K11's part of the final scene's pool frame (2^17 slots) and chunked
    frame (chunks of 2^17) without an accel: each loop stepped op by op
    (its live passes), each pass's K11 timed by ``K11Clock``.  Returns
    {frame: [ms, calls]}."""
    from first_raytracer_tpu_torch.render.api import batch_state
    from first_raytracer_tpu_torch.render.integrator import (
        default_intersect, trip)
    from first_raytracer_tpu_torch.render.regenerative import (pool_pass,
                                                               pool_state)
    C, total, dev = 1 << 17, cfg.num_rays, scene.sphere_center.device
    out = {}
    clock = K11Clock(torch, dh.dense_hit, scene, cfg.t_min, C, masked)
    start = torch.zeros((), dtype=torch.int64, device=dev)
    static = dict(scene=scene, camera=cam, accel=None, key=key,
                  start_id=start, cfg=cfg, num_rays=total, pool_size=C,
                  intersect_fn=default_intersect)
    state = pool_state(**static)
    while bool(state["alive"].any()):
        clock.time(state["o"], state["d"], state["alive"])
        pool_pass(state, **static)
    out["pool"] = [clock.total_ms, clock.calls]
    clock.total_ms, clock.calls = 0.0, 0
    for lo in range(0, total, C):
        ids = torch.arange(lo, lo + C, device=dev).clamp(max=total - 1)
        state = batch_state(scene, cam, key, ids, cfg=cfg)
        while bool(state["alive"].any()):
            clock.time(state["origin"], state["direction"], state["alive"])
            trip(state, scene=scene, accel=None, key=key, cfg=cfg,
                 intersect_fn=default_intersect)
    out["chunked"] = [clock.total_ms, clock.calls]
    return out


def turns(checkout):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.diff import grad as dg
    from first_raytracer_tpu_torch.diff import replay as rrep
    from first_raytracer_tpu_torch.kernels import intersect_clustered as ic
    from first_raytracer_tpu_torch.render.camera import camera_rays
    from first_raytracer_tpu_torch.render.integrator import (
        default_intersect)
    from first_raytracer_tpu_torch.scene.builders import build_preset
    from first_raytracer_tpu_torch.utils import metrics

    import inspect

    import numpy as np

    from first_raytracer_tpu_torch.kernels import dense_hit as dh
    from first_raytracer_tpu_torch.render.api import render_image

    import first_raytracer_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(
            os.path.abspath(checkout)):
        raise SystemExit(f"imported {pkg.__file__}, not {checkout}'s")
    dev = torch.device("cuda")
    R, pool = 1 << 17, 1 << 14
    key = rng.base_key(0).to(dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    ids = torch.arange(R, device=dev)
    o, d = camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    inputs = dict(scene=scene, accel=None, key=key, ray_ids=ids)
    static = dict(cfg=cfg, intersect_fn=default_intersect)
    lock = rrep.record_state(o, d, cfg=cfg)
    length = rrep.record_state(o, d, cfg=cfg, tape=False)
    length["length"] = torch.zeros((R,), dtype=torch.int64, device=dev)
    rpool = rrep.record_pool_state(cam, key, ids, cfg=cfg, pool_size=pool)
    bodies = {
        "lockstep bounce": lambda: rrep.record_bounce(lock, **inputs,
                                                      **static),
        "pool pass": lambda: rrep.record_pool_pass(
            rpool, camera=cam, pool_size=pool, **inputs, **static),
        "length pass": lambda: metrics._length_pass(length, **inputs,
                                                    **static)}
    nodes = {k: graph_nodes(torch, f) for k, f in bodies.items()}
    body_ms = {k: graph_ms(torch, f) for k, f in bodies.items()}
    params, _ = dg.split_params(scene)
    target = torch.zeros((R, 3), device=dev)
    fs, fc, fcfg = build_preset("sphere-field", device=dev, n=5000)
    fparams, _ = dg.split_params(fs)
    pack5 = ic.pack_scene_clustered(fs)
    runs = {
        "direct step": lambda: dg.render_loss_and_grads(
            params, scene, cam, cfg, key, ids, target),
        "recorder": lambda: dg.record_tape(params, scene, cam, cfg, key,
                                           ids),
        "pool recorder": lambda: dg.record_tape(
            params, scene, cam, cfg, key, ids, record_pool=pool),
        "occupancy": lambda: metrics.wavefront_occupancy(
            scene, cam, cfg, seed=0, num_rays=R, device=dev),
        "field5000 direct step": lambda: dg.render_loss_and_grads(
            fparams, fs, fc, fcfg, key, ids, target, pack5)}
    secs = {k: host_s(torch, f) for k, f in runs.items()}

    # K11 with masks (a checkout without them sweeps every ray), and the
    # frames without an accel.
    masked = "alive" in inspect.signature(dh.dense_hit).parameters
    from first_raytracer_tpu_torch.utils.roofline import k11_bound
    k11_ms, k11_live, k11_bound_ms = {}, {}, {}
    for share in (1.0, 0.1, 0.01):
        alive = torch.from_numpy(
            np.random.default_rng(7).random(R) < share).to(dev)
        extra = (alive,) if masked else ()
        k11_live[share] = int(alive.sum())
        k11_bound_ms[share] = (k11_bound(scene, R, live=k11_live[share])
                               if masked else k11_bound(scene, R))[0]
        k11_ms[share] = graph_ms(
            torch, lambda extra=extra: dh.dense_hit(scene, o, d, cfg.t_min,
                                                    *extra), inner=20)

    def frame(mode):
        def run():
            render_image(scene, cam, cfg, seed=0, accel=None, mode=mode,
                         chunk=R, pool_size=R, device=dev)
        return run
    frames = {"pool": host_s(torch, frame("regenerative")),
              "chunked": host_s(torch, frame("wavefront"))}
    parts = k11_parts(torch, dh, scene, cam, cfg, rng.base_key(0).to(dev),
                      masked)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"checkout": checkout, "card": card, "nodes": nodes,
                      "body_ms": body_ms, "s": secs, "k11_masked": masked,
                      "k11_live": k11_live, "k11_ms": k11_ms,
                      "k11_bound_ms": k11_bound_ms,
                      "frames_s": frames, "k11_part_ms": parts}),
          flush=True)


def phase22():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("probes/record_pass.py: no CUDA device")
    card = cs.card_line()
    cs.log(card)
    cs.build()
    entries = cs.record_pass_path(torch.device("cuda"), cs.rng.base_key(0),
                                  card)
    print(json.dumps({"kernels": entries}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", metavar="CHECKOUT")
    args = ap.parse_args()
    if args.turns:
        turns(args.turns)
    else:
        phase22()


if __name__ == "__main__":
    main()
