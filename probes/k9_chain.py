"""Where one slot's time goes in K9, and K9's and K10's times, on the card.

Times, at 2^17 slots of the final scene (random-spheres 1200x800 @ 10,
closest hits from K4), 20 calls captured in a CUDA graph, median of 7
replays, each call first restoring the state it changes (the restore's
own graph timed alone and taken off):

- K9 in pool mode on the pool after one pass (live, dead and fresh
  slots), the pool's rows restored;
- K9 in trip mode at a chunk's first trip (every ray live) and at its
  ninth (most rays dead), the carry restored;
- K10 as the pass runs it (in a checkout before the redesign, with the
  cursor's copy after it); a graphed pool pass's ms and nodes.

K9 is timed through the package's own build and through variants of
``wavefront_pass.cu`` built with one nvcc each, all at once, into
``out/k9_chain/``: ``FRT_K9_NO_DRAW`` (constant uniforms, no Threefry),
``FRT_K9_CONST_GATHERS`` (the primitive and its material replaced by
constants), both, ``FRT_K9_ALIVE_FIRST`` (a slot's liveness read and
tested before its other fields), and copies of the source edited
(``VARIANTS``): the look-back left out (each tile's prefix its own first
slot), 2 or 4 status words a lane a look-back window (the package reads
1), the look-back's closing fence an acq_rel one, the status words
published and read with no fence, the spin without its sleep or with a
sleep of 256 or 1024 ns (the package sleeps 32).  A variant
the source does not know is skipped, so the probe also times a checkout
from before the variants: run it with that checkout's package first on
the path,

    python probes/k9_chain.py [--tree CHECKOUT] [--out FILE]

and, to compare two commits on one card, in turns (parent, change,
change, parent) in one call.  Prints each variant's ptxas line and one
JSON line of the times; ``--out`` appends that line to a file.
"""
import argparse
import ctypes
import functools
import json
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ARGS.add_argument("--tree", default=HERE,
                  help="the checkout whose package and source to time")
ARGS.add_argument("--out", default=None, help="append the JSON line here")

RAYS = 1 << 17
# Each variant: the macros it defines and the edits of a copy of the
# source (old, new) it makes.
LOOK_BACK = ("    const int64_t prefix = tile > 0 ? look_back(status, tile, "
             "epoch) : 0;")
SPAN = "constexpr int kSpan = 1;"
FENCE = "      __threadfence();  // the reads above become acquire reads"
RELEASE = "st.release.gpu.global.u64"
SLEEP = "      __nanosleep(32);"
VARIANTS = {
    "no draw": (("FRT_K9_NO_DRAW",), ()),
    "const gathers": (("FRT_K9_CONST_GATHERS",), ()),
    "no draw, const gathers": (("FRT_K9_NO_DRAW", "FRT_K9_CONST_GATHERS"),
                               ()),
    "alive first": (("FRT_K9_ALIVE_FIRST",), ()),
    # Each tile's prefix its own first slot: no look-back, and the
    # survivors stay in their tile.
    "no look-back": ((), ((LOOK_BACK, "    const int64_t prefix = "
                                      "static_cast<int64_t>(tile) * "
                                      "kThreads;"),)),
    "span 2": ((), ((SPAN, "constexpr int kSpan = 2;"),)),
    "span 4": ((), ((SPAN, "constexpr int kSpan = 4;"),)),
    "acq_rel fence": ((), ((FENCE, '      asm volatile("fence.acq_rel.gpu;" '
                                   '::: "memory");'),)),
    "relaxed": ((), ((FENCE, ""), (RELEASE, "st.relaxed.gpu.global.u64"))),
    "no sleep": ((), ((SLEEP, ""),)),
    "sleep 256": ((), ((SLEEP, "      __nanosleep(256);"),)),
    "sleep 1024": ((), ((SLEEP, "      __nanosleep(1024);"),)),
}
ROWS = ("o", "d", "tp", "ids", "depth", "alive")


def cuda_ms(fn, repeats):
    import torch
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, inner=20, repeats=7):
    """Median ms a call of ``fn``: ``inner`` calls in one CUDA graph."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    return cuda_ms(graph.replay, repeats) / inner


def graph_nodes(fn):
    """Nodes of a CUDA graph of one call of ``fn`` (``cuGraphGetNodes``)."""
    import torch
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


def build_variants(mk, build):
    """One nvcc a variant the source knows, all at once; returns {name:
    (library, ptxas lines of the K9 kernels)} and the variants skipped."""
    src = os.path.join(build.CSRC_DIR, "wavefront_pass.cu")
    with open(src) as f:
        text = f.read()
    out_dir = os.path.join(HERE, "out", "k9_chain")
    os.makedirs(out_dir, exist_ok=True)
    procs, skipped = {}, []
    for name, (defines, edits) in VARIANTS.items():
        if not all(d in text for d in defines) or not all(
                old in text for old, _ in edits):
            skipped.append(name)
            continue
        stem = os.path.join(out_dir, "k9_" + re.sub(r"\W+", "_", name))
        with open(stem + ".cu", "w") as f:
            f.write(functools.reduce(lambda t, e: t.replace(*e), edits,
                                     text))
        lib = stem + ".so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *mk.NVCC_EXTRA_FLAGS,
               *(f"-D{d}" for d in defines), "-I", build.CSRC_DIR, "-o",
               lib, stem + ".cu"]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (mk.bind_wavefront_pass(ctypes.CDLL(lib)), ptxas(log))
    return libs, skipped


def ptxas(log):
    """ptxas's register and spill lines of the K9 and K10 kernels."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            kind = re.search(r"(shade_pool|shade_trip|regenerate)", entry)
            if kind:
                out.append(f"{kind[1]}: {line.split(':', 1)[-1].strip()}")
    return out


def entry_of(lib):
    """``megakernel.launch_entry`` on ``lib`` instead of the package's."""
    import torch

    def call(dev, name, *args):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} failed ({err})")
    return call


def main():
    args = ARGS.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.kernels import build
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
    from first_raytracer_tpu_torch.kernels import megakernel as mk
    from first_raytracer_tpu_torch.render import wavefront_pass as wp
    from first_raytracer_tpu_torch.render.api import batch_state
    from first_raytracer_tpu_torch.render.integrator import trip
    from first_raytracer_tpu_torch.render.regenerative import (pool_pass,
                                                               pool_state)
    from first_raytracer_tpu_torch.scene.builders import build_preset

    if not torch.cuda.is_available():
        raise SystemExit("probes/k9_chain.py: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    _, info = mk.load_mega_library()
    libs, skipped = build_variants(mk, build)
    print(f"tree {os.path.abspath(args.tree)}; {card}; package build "
          f"{info.seconds:.1f} s; variants {list(libs)}, not in this "
          f"source {skipped}", flush=True)
    for line in ptxas(info.log):
        print(f"  package {line}", flush=True)
    for name, (_, lines) in libs.items():
        for line in lines:
            print(f"  {name} {line}", flush=True)

    key = rng.base_key(0).to(dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    pack = ip.pack_scene_pallas(scene)
    start = torch.zeros((), dtype=torch.int64, device=dev)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=RAYS)
    inputs = dict(scene=scene, camera=cam, accel=pack, key=key,
                  start_id=start)
    state = pool_state(**inputs, **static)
    pool_pass(state, **inputs, intersect_fn=ip.intersect_pallas, **static)
    prim, _, hit = ip.intersect_pallas(scene, pack, state["o"], state["d"],
                                       cfg.t_min)
    work = {k: v.clone() for k, v in state.items()}

    def restore_pool():
        for k in ROWS:
            work[k].copy_(state[k])

    shade_kw = dict(scene=scene, key=key, cfg=cfg, start_id=start,
                    num_rays=cfg.num_rays)
    ids = torch.arange(RAYS, device=dev)
    chunk = batch_state(scene, cam, key, ids, cfg=cfg)
    trips = {"first trip": {k: v.clone() for k, v in chunk.items()}}
    for _ in range(8):
        trip(chunk, scene=scene, accel=pack, key=key, cfg=cfg,
             intersect_fn=ip.intersect_pallas)
    trips["ninth trip"] = chunk
    trip_hits = {label: ip.intersect_pallas(scene, pack, st["origin"],
                                            st["direction"], cfg.t_min)
                 for label, st in trips.items()}
    carry = ("origin", "direction", "throughput", "radiance", "alive",
             "segments")

    def k9_times():
        restore_ms = graph_ms(restore_pool)
        out = {"pool": graph_ms(lambda: (restore_pool(), wp._launch_shade(
            work, prim, hit, **shade_kw))) - restore_ms}
        for label, st in trips.items():
            tp, _, th = trip_hits[label]
            tw = {k: v.clone() for k, v in st.items()}

            def restore():
                for k in carry:
                    tw[k].copy_(st[k])
            base = graph_ms(restore)
            out[label] = graph_ms(lambda: (restore(), wp._launch_shade(
                tw, tp, th, scene=scene, key=key, cfg=cfg))) - base
            out[f"{label} live"] = int(st["alive"].sum())
        return out

    result = {"tree": os.path.abspath(args.tree), "card": card,
              "pool live": int(state["alive"].sum())}
    result["package"] = k9_times()
    restore_pool()
    wp._launch_shade(work, prim, hit, **shade_kw)
    result["K10"] = graph_ms(lambda: wp._launch_regenerate(
        work, camera=cam, key=key, start_id=start, **static))

    def one_pass():
        pool_pass(state, **inputs, intersect_fn=ip.intersect_pallas,
                  **static)
    result["pool pass"] = graph_ms(one_pass, inner=1)
    result["pool pass nodes"] = graph_nodes(one_pass)
    saved = mk.launch_entry
    for name, (lib, _) in libs.items():
        mk.launch_entry = entry_of(lib)
        try:
            result[name] = k9_times()
        finally:
            mk.launch_entry = saved
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
