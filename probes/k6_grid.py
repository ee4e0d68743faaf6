"""K6's design constants, tried on the card.

``kernels/csrc/bvh_walk.cu`` fixes ``kWalkThreads`` (threads a block),
``kLeafAll`` (the warp leaves its node phase when every lane has a leaf
pending or is done, or as soon as one has), ``kNodeSteps`` (node steps a
lane takes between two votes) and takes the box's NaN minima and maxima
as PTX ``min.NaN`` / ``max.NaN``.  This probe builds a copy of
the source for each variant in ``VARIANTS`` (one nvcc each, all started
together, into ``out/k6_grid/``), prints each one's ptxas line and SASS
instruction count, checks every variant's (prim, t, hit, counters) equal
to the package's K6 on every set below, and the package's K6 to the plain
walk (counters included) on the final scene's camera rays through both
paths; then times each variant through each path the set can take, 20
launches captured in a CUDA graph, median of 7 replays:

- the final scene's 2^17 camera rays, and one bounce's secondary rays
  from their hits (``scatter`` at bounce 0);
- 2^17 camera rays of field5000 (its records and slots fit a block's
  227 KB), field20000 and trifield20000 (they do not: global only).

The shared path is forced with a budget of 2^31 - 1 bytes and the global
one with 0.  Then the package's K6 through both paths at 32 to 2^17 of the
final scene's camera rays (a launch's floor, beside a one-element fill in
a graph), and at 2^17 camera rays of sphere fields of 500-5000 spheres,
whose records and slots span a block's shared memory: the measurement
behind ``SHARED_BUDGET``.  Run from
the repository root on a GPU host (~1 min):

    python probes/k6_grid.py
"""
import ctypes
import os
import re
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from first_raytracer_tpu_torch.accel import traverse as tv  # noqa: E402
from first_raytracer_tpu_torch.accel.build import build_bvh  # noqa: E402
from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels.build import (CSRC_DIR,  # noqa: E402
                                                     NVCC_FLAGS, _nvcc)
from first_raytracer_tpu_torch.materials.scatter import scatter  # noqa: E402,E501
from first_raytracer_tpu_torch.render.camera import generate_rays  # noqa: E402,E501
from first_raytracer_tpu_torch.render.integrator import recompute_hit  # noqa: E402,E501
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501
from first_raytracer_tpu_torch.utils.roofline import k6_bound  # noqa: E402

RAYS = 1 << 17
# (threads a block, kLeafAll, PTX minima and maxima, node steps a vote).
VARIANTS = [(512, True, True, s) for s in (1, 3, 4, 6, 8)] + [
    (512, False, True, 4), (512, True, False, 4)]
# sphere_field sizes whose records and slots span the budget (shared
# against global through the package's K6).
BUDGET_FIELDS = (500, 1000, 1500, 2000, 3000, 5000)
FORCE = {"shared": 2 ** 31 - 1, "global": 0}
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "out", "k6_grid")
PTX_GUARD = "#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 800"


def name(variant):
    t, rule, ptx, steps = variant
    return (f"{t}_{'all' if rule else 'any'}_{'ptx' if ptx else 'c'}_"
            f"{steps}")


def build_all():
    """One nvcc per variant, all at once; returns {variant: (lib, log)}."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC_DIR, "bvh_walk.cu")) as f:
        src = f.read()
    if src.count(PTX_GUARD) != 2:
        raise RuntimeError("the PTX minima's guards were not found")
    procs = {}
    for v in VARIANTS:
        t, rule, ptx, steps = v
        text = re.sub(r"constexpr int kWalkThreads = \d+;",
                      f"constexpr int kWalkThreads = {t};", src)
        text = re.sub(r"constexpr int kNodeSteps = \d+;",
                      f"constexpr int kNodeSteps = {steps};", text)
        text = re.sub(r"constexpr bool kLeafAll = \w+;",
                      f"constexpr bool kLeafAll = {str(rule).lower()};",
                      text)
        if not ptx:
            text = text.replace(PTX_GUARD, "#if 0")
        path = os.path.join(OUT, f"bvh_walk_{name(v)}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"libk6_{name(v)}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *mk.NVCC_EXTRA_FLAGS, "-I", CSRC_DIR,
               "-o", lib, path]
        procs[v] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for v, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name(v)}:\n{log}")
        out[v] = (mk.bind_bvh(ctypes.CDLL(lib)), lib, log)
    return out


def ptxas(log):
    """ptxas's register and spill lines of each bvh_walk_kernel entry."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "bvh_walk_kernel" in entry and (
                "registers" in line or "spill" in line):
            kind = re.search(r"(Global|Shared\w+)Leaves", entry)
            out.append(f"{kind[1] if kind else entry[:40]}: "
                       f"{line.split(':', 1)[-1].strip()}")
    return out


def sass_counts(lib):
    """SASS instructions of each bvh_walk_kernel function in ``lib``."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        fn = body.split("\n", 1)[0].strip()
        if "bvh_walk_kernel" in fn:
            kind = re.search(r"(Global|Shared\w+)Leaves", fn)
            out[kind[1] if kind else fn[:40]] = len(
                re.findall(r"/\*[0-9a-f]{4}\*/", body))
    return out


def launcher(dll, scene, bvh, budget):
    """The variant's K6 over (o, d): (prim, t, hit, counters)."""
    def run(o, d):
        n = o.shape[0]
        dev = o.device
        prim = torch.empty((n,), dtype=torch.int32, device=dev)
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        hit = torch.empty((n,), dtype=torch.bool, device=dev)
        counters = torch.empty((n, 3), dtype=torch.int32, device=dev)
        err = dll.frt_bvh_walk(
            o.data_ptr(), d.data_ptr(), bvh.nodes.data_ptr(),
            bvh.prim_ids.data_ptr(), bvh.num_nodes, bvh.prim_ids.shape[0],
            scene.sphere_center.data_ptr(), scene.sphere_radius.data_ptr(),
            scene.num_spheres, scene.tri_v0.data_ptr(),
            scene.tri_v1.data_ptr(), scene.tri_v2.data_ptr(),
            scene.num_triangles, 4, n, ctypes.c_float(1e-3), budget,
            prim.data_ptr(), t.data_ptr(), hit.data_ptr(),
            counters.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return prim, t, hit, counters
    return run


def graph_ms(fn, repeats=7, inner=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
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


def camera_rays(scene, cam, cfg):
    ids = torch.arange(RAYS, device=scene.device)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(rng.base_key(0), ids))
    return o.contiguous(), d.contiguous()


def sets():
    """(label, scene, bvh, o, d) of each ray set."""
    dev = torch.device("cuda")
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    bvh = build_bvh(scene, max_leaf=4)
    o, d = camera_rays(scene, cam, cfg)
    prim, _, hit = tv.intersect_bvh(scene, bvh, o, d, 1e-3)
    _, p, n, mat = recompute_hit(scene, o, d, prim, 1e-3)
    ids = torch.arange(RAYS, device=dev)
    new_d, _, ok = scatter(scene, mat, d, p, n,
                           rng.bounce_uniforms(rng.base_key(0), ids, 0))
    live = hit & ok
    out = [("final scene camera", scene, bvh, o, d),
           ("final scene bounce", scene, bvh, p[live].contiguous(),
            new_d[live].contiguous())]
    for label, preset, n_prims in (("field5000", "sphere-field", 5000),
                                   ("field20000", "sphere-field", 20000),
                                   ("trifield20000", "triangle-field",
                                    20000)):
        sc, c, cf = build_preset(preset, device=dev, n=n_prims)
        out.append((f"{label} camera", sc, build_bvh(sc, max_leaf=4),
                    *camera_rays(sc, c, cf)))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/k6_grid.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for v, (_, lib, log) in libs.items():
        print(name(v), "ptxas", ptxas(log), "SASS", sass_counts(lib),
              flush=True)
    ray_sets = sets()
    limit = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", 232448)
    # The package's K6 against the plain walk, counters included.
    _, scene, bvh, o, d = ray_sets[0]
    want = tv.intersect_bvh_plain(scene, bvh, o, d, 1e-3,
                                  return_counters=True)
    for path, budget in FORCE.items():
        got = tv._launch_cuda(scene, bvh, o, d, 1e-3, 4, True, budget)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K6's {path} path differs from the plain "
                                 "walk on the final scene's camera rays")
    print("the package's K6 equals the plain walk (prim, t, hit, counters) "
          "on the final scene's 2^17 camera rays through both paths",
          flush=True)
    for label, scene, bvh, o, d in ray_sets:
        fits = tv.shared_bytes(scene, bvh) <= limit
        paths = ["shared", "global"] if fits else ["global"]
        ref = tv._launch_cuda(scene, bvh, o, d, 1e-3, 4, True, 0)
        sums = ref[3].long().sum(0).tolist()
        bound = k6_bound(scene, bvh, sums, o.shape[0])
        print(f"{label}: {o.shape[0]} rays, {bvh.num_nodes} nodes, "
              f"{tv.shared_bytes(scene, bvh)} bytes staged (limit {limit}), "
              f"default path {tv.walk_path(scene, bvh)}; per ray "
              f"{sums[0] / o.shape[0]:.2f} nodes, {sums[1] / o.shape[0]:.2f}"
              f" sphere and {sums[2] / o.shape[0]:.2f} triangle slots; bound"
              f" {bound[0]:.5f} ms ({bound[1]})", flush=True)
        for path in paths:
            row = []
            for v, (dll, _, _) in libs.items():
                run = launcher(dll, scene, bvh, FORCE[path])
                got = run(o, d)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{name(v)} differs on {label} "
                                         f"({path})")
                row.append(f"{name(v)} {graph_ms(lambda: run(o, d)):.5f}")
            print(f"  {path} ms: " + ", ".join(row), flush=True)
    # A launch's floor: the package's K6 through each path at 32 to 2^17
    # of the final scene's camera rays, beside a graph node that fills one
    # element.
    _, scene, bvh, o, d = ray_sets[0]
    one = torch.empty(1, device="cuda")
    print(f"a one-element fill in the graph: {graph_ms(one.zero_):.5f} ms",
          flush=True)
    for n in (32, 1024, 8192, 32768, RAYS):
        so, sd = o[:n].contiguous(), d[:n].contiguous()
        row = [f"{path} {graph_ms(lambda: tv._launch_cuda(scene, bvh, so, sd, 1e-3, 4, False, budget)):.5f}"  # noqa: E501
               for path, budget in FORCE.items()]
        print(f"final scene, {n} camera rays: " + ", ".join(row) + " ms",
              flush=True)
    # The budget: each path of the package's K6 on fields whose records
    # and slots span a block's shared memory.
    for n_prims in BUDGET_FIELDS:
        sc, c, cf = build_preset("sphere-field", device="cuda", n=n_prims)
        bv = build_bvh(sc, max_leaf=4)
        o, d = camera_rays(sc, c, cf)
        row = [f"{path} {graph_ms(lambda: tv._launch_cuda(sc, bv, o, d, 1e-3, 4, False, budget)):.5f}"  # noqa: E501
               for path, budget in FORCE.items()]
        print(f"field{n_prims} 2^17 camera rays, {tv.shared_bytes(sc, bv)} "
              f"bytes staged: " + ", ".join(row) + " ms", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s; {card}", flush=True)


if __name__ == "__main__":
    main()
