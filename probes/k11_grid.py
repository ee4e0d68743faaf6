"""K11's design constants, tried on the card.

``kernels/csrc/dense_hit.cu`` fixes ``kThreads`` (threads a block),
``kRays`` (rays a thread when more than ``kThreads`` rays of a window are
live; the window is their product), ``kGroup`` (spheres whose
discriminants share a branch) and ``kMaxSplit`` (the most lanes a ray's
sweep is split over), takes ``__launch_bounds__(kThreads)``, and
stages the first tile of the scene once the block knows it has a live
ray.  This probe builds a copy of the source for each variant in
``VARIANTS`` (one nvcc each, all started together, into
``out/k11_grid/``; "early": the first tile staged before the block's live
count is known, as first written, so a window with no live ray reads the
scene too; "min N": ``__launch_bounds__(kThreads, N)``), prints each one's
ptxas lines, checks every variant's (prim, t, hit) equal to the package's
K11 on every input below, and times each, 20 launches captured in a CUDA
graph, median of 7 replays:

- the final scene's 2^17 camera rays with liveness masks of live shares
  1 to 0 (from a numpy seed);
- every bounce of the lockstep recorder on those rays (its state's rays
  and mask as ``record_bounce`` hands them to K11), summed over the
  bounces: K11's part of a recorder run.

Run from the repository root on a GPU host (~1.5 min):

    python probes/k11_grid.py
"""
import ctypes
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.diff import replay as rrep  # noqa: E402
from first_raytracer_tpu_torch.kernels import dense_hit as dh  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels.build import (CSRC_DIR,  # noqa: E402
                                                     NVCC_FLAGS, _nvcc)
from first_raytracer_tpu_torch.render.camera import camera_rays  # noqa: E402,E501
from first_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    default_intersect)
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501
from first_raytracer_tpu_torch.utils.roofline import k11_bound  # noqa: E402

RAYS = 1 << 17
SHARES = (1.0, 0.75, 0.5, 0.43, 0.25, 0.1, 0.03, 0.01, 0.001, 0.0)
# (threads a block, rays a thread, spheres a group, most lanes a ray, the
# first tile staged early, launch bounds' minimum blocks an SM or 0).
VARIANTS = [(128, 2, 8, 32, False, 0), (128, 2, 4, 32, False, 0),
            (128, 2, 4, 32, True, 0), (128, 2, 2, 32, False, 0),
            (128, 2, 16, 32, False, 0), (128, 2, 4, 8, False, 0),
            (128, 2, 4, 32, False, 8), (256, 1, 4, 32, False, 0),
            (256, 1, 8, 32, False, 0), (256, 1, 16, 32, False, 0),
            (256, 2, 8, 32, False, 0), (128, 1, 8, 32, False, 0),
            (64, 2, 8, 32, False, 0)]
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "out", "k11_grid")
BALLOT = "  unsigned ballot[kRays];\n"
LATE = ("  if (total == 0) return;  // the whole block: no live ray, no "
        "scene\n  stage(sc, 0, raw);\n  commit_copies();\n")
BOUNDS = "__launch_bounds__(kThreads)"


def name(v):
    t, r, g, split, early, blocks = v
    return (f"{t}x{r}_g{g}_s{split}{'_early' if early else ''}"
            f"{f'_min{blocks}' if blocks else ''}")


def build_all():
    """One nvcc per variant, all at once; returns {variant: (dll, log)}."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC_DIR, "dense_hit.cu")) as f:
        src = f.read()
    if src.count(BALLOT) != 1 or src.count(LATE) != 1 or \
            src.count(BOUNDS) != 1:
        raise RuntimeError("the first tile's staging was not found")
    procs = {}
    for v in VARIANTS:
        t, r, g, split, early, blocks = v
        text = re.sub(r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {t};", src)
        text = re.sub(r"constexpr int kRays = \d+;",
                      f"constexpr int kRays = {r};", text)
        text = re.sub(r"constexpr int kGroup = \d+;",
                      f"constexpr int kGroup = {g};", text)
        text = re.sub(r"constexpr int kMaxSplit = \d+;",
                      f"constexpr int kMaxSplit = {split};", text)
        if early:
            text = text.replace(BALLOT, "  stage(sc, 0, raw);\n"
                                        "  commit_copies();\n" + BALLOT)
            text = text.replace(LATE, "  if (total == 0) {\n"
                                      "    wait_copies<0>();\n"
                                      "    return;\n  }\n")
        if blocks:
            text = text.replace(BOUNDS,
                                f"__launch_bounds__(kThreads, {blocks})")
        path = os.path.join(OUT, f"dense_hit_{name(v)}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"libk11_{name(v)}.so")
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
        out[v] = (mk.bind_dense_hit(ctypes.CDLL(lib)), log)
    return out


def ptxas(log):
    """ptxas's register and spill lines of the K11 entry."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "dense_hit_kernel" in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def launcher(dll, scene):
    """The variant's K11 over (o, d, alive): (prim, t, hit)."""
    def run(o, d, alive):
        n = o.shape[0]
        dev = o.device
        prim = torch.empty((n,), dtype=torch.int32, device=dev)
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        hit = torch.empty((n,), dtype=torch.bool, device=dev)
        err = dll.frt_dense_hit(
            scene.sphere_center.data_ptr(), scene.sphere_radius.data_ptr(),
            scene.tri_v0.data_ptr(), scene.tri_v1.data_ptr(),
            scene.tri_v2.data_ptr(), scene.num_spheres,
            scene.num_triangles, o.data_ptr(), d.data_ptr(),
            alive.data_ptr(), n, ctypes.c_float(1e-3), prim.data_ptr(),
            t.data_ptr(), hit.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return prim, t, hit
    return run


class Clock:
    """A K11 launcher timed on copies of its inputs: 20 calls captured
    once in a CUDA graph on static buffers, median of 7 replays."""

    def __init__(self, run, n, dev):
        self.o = torch.zeros((n, 3), device=dev)
        self.d = torch.zeros((n, 3), device=dev)
        self.d[:, 2] = 1.0
        self.alive = torch.zeros((n,), dtype=torch.bool, device=dev)
        run(self.o, self.d, self.alive)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(20):
                run(self.o, self.d, self.alive)

    def ms(self, o, d, alive, repeats=7):
        self.o.copy_(o)
        self.d.copy_(d)
        self.alive.copy_(alive)
        self.graph.replay()
        times = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 20)
        return statistics.median(times)


def recorder_bounces(scene, cam, cfg, key, o, d):
    """The lockstep recorder's state at each bounce: (o, dr, alive)."""
    ids = torch.arange(o.shape[0], device=o.device)
    state = rrep.record_state(o, d, cfg=cfg)
    out = []
    while bool(state["alive"].any()):
        out.append((state["o"].clone(), state["dr"].clone(),
                    state["alive"].clone()))
        rrep.record_bounce(state, scene=scene, accel=None, key=key,
                           ray_ids=ids, cfg=cfg,
                           intersect_fn=default_intersect)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/k11_grid.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    libs = build_all()
    for v, (_, log) in libs.items():
        print(f"{name(v)}: " + "; ".join(ptxas(log)), flush=True)
    dev = torch.device("cuda")
    key = rng.base_key(0).to(dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    ids = torch.arange(RAYS, device=dev)
    o, d = camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    masks = {s: torch.from_numpy(np.random.default_rng(7).random(RAYS)
                                 < s).to(dev) for s in SHARES}
    bounces = recorder_bounces(scene, cam, cfg, key, o, d)
    inputs = [(f"{s}", o, d, masks[s]) for s in SHARES] + [
        (f"bounce {b}", *x) for b, x in enumerate(bounces)]
    # Every variant against the package's K11.
    for v, (dll, _) in libs.items():
        run = launcher(dll, scene)
        for label, io, idr, alive in inputs:
            got = run(io, idr, alive)
            want = dh.dense_hit(scene, io, idr, 1e-3, alive)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name(v)} differs on {label}")
    print(f"every variant equal to the package's K11 on {len(inputs)} "
          "inputs", flush=True)
    rows = {}
    for v, (dll, _) in libs.items():
        clock = Clock(launcher(dll, scene), RAYS, dev)
        rows[v] = {s: clock.ms(o, d, masks[s]) for s in SHARES}
        rows[v]["recorder"] = sum(clock.ms(*x, repeats=3) for x in bounces)
    live = {s: int(masks[s].sum()) for s in SHARES}
    print("variant | " + " | ".join(f"{s} ({live[s]} live)" for s in SHARES)
          + f" | sum over {len(bounces)} recorder bounces (ms)", flush=True)
    for v, row in rows.items():
        print(f"{name(v)} | " + " | ".join(f"{row[s]:.4f}" for s in SHARES)
              + f" | {row['recorder']:.4f}", flush=True)
    print("bound | " + " | ".join(
        f"{k11_bound(scene, RAYS, live[s])[0]:.5f}" for s in SHARES) +
        f" | {sum(k11_bound(scene, RAYS, int(a.sum()))[0] for *_, a in bounces):.5f}"  # noqa: E501
        f"; on {card}", flush=True)


if __name__ == "__main__":
    main()
