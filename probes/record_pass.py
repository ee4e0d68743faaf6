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
K12 (``record_step``) in lockstep and length modes at the first bounce of
the 2^17 camera rays with masks of live shares 1, 0.1 and 0.01, and in
lockstep mode summed over the direct step's bounces (each bounce's state
and closest hit copied into a ``StateClock``: 20 calls a CUDA graph, each
restoring the rays, liveness and counter it moves, the restores' own
graph taken off; each bounce's live rays and ms listed too), and the pool pass past its closest hit (K12's pool mode
with K13, one launch where K13 is folded in and two in a checkout before
that) after one pass at 2^14 slots over 2^17 ids and at 2^17 over 2^19;
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


def capture(torch, fn, inner):
    """A CUDA graph of ``inner`` calls of ``fn`` (after a warm call)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return graph


def replay_ms(torch, graph, repeats):
    """Median ms of a replay of ``graph``."""
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class StateClock:
    """``call(work, *args)`` timed on copies of a state it moves: ``inner``
    calls, each after the keys ``moved`` of ``work`` are restored from a
    source copy, captured once in a CUDA graph beside a graph of the
    restores alone.  ``ms(state, args)`` copies ``state``'s keys and the
    arguments in and returns one call's ms, the restore's taken off
    (medians of ``repeats`` replays)."""

    def __init__(self, torch, call, state, args, moved, inner=20):
        self.torch, self.inner = torch, inner
        self.src = {k: v.clone() for k, v in state.items()}
        self.work = {k: v.clone() for k, v in state.items()}
        self.args = [a.clone() for a in args]

        def restore():
            for k in moved:
                self.work[k].copy_(self.src[k])

        def both():
            restore()
            call(self.work, *self.args)
        self.graphs = (capture(torch, both, inner),
                       capture(torch, restore, inner))

    def ms(self, state, args, repeats=5):
        for k, v in state.items():
            self.src[k].copy_(v)
        for a, b in zip(self.args, args):
            a.copy_(b)
        both, restore = (replay_ms(self.torch, g, repeats)
                         for g in self.graphs)
        return (both - restore) / self.inner


def live_mask(torch, n, share, dev, seed=7):
    """(n,) bool on ``dev``, each entry live with probability ``share``
    (numpy's generator from ``seed``)."""
    import numpy as np
    return torch.from_numpy(np.random.default_rng(seed).random(n)
                            < share).to(dev)


def step_moved(state):
    """The keys of a lockstep or length state that K12 moves (``d`` too: a
    checkout whose K12 leaves it is restored all the same)."""
    return [k for k in ("o", "dr", "alive", "d", "arrivals", "length")
            if k in state]


def direct_bounces(torch, rrep, dh, intersect_fn, scene, cfg, key, o, d):
    """The lockstep recorder's bounces on the rays (o, d), as the direct
    step runs them: each bounce's (o, dr, alive, d) and the closest hit
    (prim, hit) K11 gives it."""
    ids = torch.arange(o.shape[0], device=o.device)
    state = rrep.record_state(o, d, cfg=cfg)
    out = []
    while bool(state["alive"].any()):
        prim, _, hit = dh.dense_hit(scene, state["o"], state["dr"],
                                    cfg.t_min, state["alive"])
        out.append(({k: state[k].clone() for k in ("o", "dr", "alive",
                                                  "d")}, (prim, hit)))
        rrep.record_bounce(state, scene=scene, accel=None, key=key,
                           ray_ids=ids, cfg=cfg, intersect_fn=intersect_fn)
    return out


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

    # K12: lockstep and length modes at the first bounce of the camera
    # rays with masks of live shares 1, 0.1 and 0.01, lockstep mode summed
    # over the direct step's bounces, and the pool pass past its closest
    # hit (K12's pool mode and K13: one launch where K13 is folded in, two
    # before) after a pass at 2^14 slots over 2^17 ids and at 2^17 over
    # 2^19; each through StateClock.
    from first_raytracer_tpu_torch.diff import record_pass as rpass
    kw = dict(scene=scene, key=key, ray_ids=ids, cfg=cfg)
    fused = "camera" in inspect.signature(rpass.record_shade).parameters
    prim, _, hit = dh.dense_hit(scene, o, d, cfg.t_min)
    k12_ms = {}
    for mode in ("lockstep", "length"):
        first = rrep.record_state(o, d, cfg=cfg, tape=mode == "lockstep")
        if mode == "length":
            first["length"] = torch.zeros((R,), dtype=torch.int64,
                                          device=dev)
        clock = StateClock(torch, lambda w, p, h: rpass.record_step(
            w, p, h, **kw), first, (prim, hit), step_moved(first))
        for share in (1.0, 0.1, 0.01):
            k12_ms[f"{mode} {share}"] = clock.ms(
                dict(first, alive=live_mask(torch, R, share, dev)),
                (prim, hit))
    bounces = direct_bounces(torch, rrep, dh, default_intersect, scene, cfg,
                             key, o, d)
    lock = rrep.record_state(o, d, cfg=cfg)
    clock = StateClock(torch, lambda w, p, h: rpass.record_step(
        w, p, h, **kw), lock, bounces[0][1], step_moved(lock))
    per_bounce = [clock.ms(b, hits, repeats=3) for b, hits in bounces]
    k12_ms["direct step's bounces"] = sum(per_bounce)

    def pool_call(work, p, h, ray_ids):
        pkw = dict(kw, ray_ids=ray_ids)
        if fused:
            rpass.record_shade(work, p, h, camera=cam, **pkw)
        else:
            rpass.record_shade(work, p, h, **pkw)
            rpass.record_regenerate(work, camera=cam, **pkw)
    for slots, n_ids in ((pool, R), (R, 4 * R)):
        pids = torch.arange(n_ids, device=dev)
        pstate = rrep.record_pool_state(cam, key, pids, cfg=cfg,
                                        pool_size=slots)
        rrep.record_pool_pass(pstate, camera=cam, accel=None, **dict(
            kw, ray_ids=pids), intersect_fn=default_intersect)
        pprim, _, phit = dh.dense_hit(scene, pstate["o"], pstate["d"],
                                      cfg.t_min, pstate["alive"])
        clock = StateClock(
            torch, lambda w, p, h, pids=pids: pool_call(w, p, h, pids),
            pstate, (pprim, phit), tuple(rpass.RECORD_ROWS) + ("cursor",))
        k12_ms[f"pool {slots}"] = clock.ms(pstate, (pprim, phit))

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
                      "k12_fused": fused, "k12_ms": k12_ms,
                      "k12_direct_bounces": len(bounces),
                      "k12_bounce_live": [int(b["alive"].sum())
                                          for b, _ in bounces],
                      "k12_bounce_ms": per_bounce,
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
