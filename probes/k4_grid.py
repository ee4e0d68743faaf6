"""K4's two work-split constants, tried on the card.

``kernels/csrc/intersect.cu`` fixes ``kDenseRays`` (R: rays a thread tests
against each staged primitive) and ``kDenseSplit`` (S: lanes that share one
ray's primitive loop), and leaves the sphere test at ``disc <= 0`` by one
branch per group of 4 spheres.  This probe builds a copy of that source
for every (R, S) in {1, 2, 4}^2, and for (1, 1) and (1, 2) copies with a
branch per sphere ("each") and with the root taken on every pair
("select"), one nvcc each, all started together, into ``out/k4_grid/``;
checks each variant against K4's plain version, and times it with CUDA
events at K4's shapes, many launches between two events (one launch takes
about as long as the host's call):

- 2^17 camera rays of the final scene (20 launches, median of 11);
- the bounce rays of one regenerative frame of it (pool 2^17): every batch
  the frame hands its intersector, recorded once, then replayed through
  each variant back to back (median of 3 replays);
- 2^17 camera rays of field20000 (20,004 spheres: 40 tiles; 3 launches,
  median of 5).

Run from the repository root on a GPU host:

    python probes/k4_grid.py
"""
import ctypes
import os
import re
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels.build import (CSRC_DIR,  # noqa: E402
                                                     NVCC_FLAGS, _nvcc)
from first_raytracer_tpu_torch.render.api import render_image  # noqa: E402
from first_raytracer_tpu_torch.render.camera import generate_rays  # noqa: E402,E501
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501

RAYS = 1 << 17
# The branch of sphere_group: one per group of kGroup spheres ("group", the
# source's), one per sphere ("each"), or none before the fold, the root
# taken on every pair ("select").
GROUP = """  if (!any) return;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    float t;
    if (disc[g] > 0.0f && sphere_root(b[g], disc[g], t_min, t)) fold(t, g);
  }
"""
EACH = GROUP.replace("  if (!any) return;\n", "")
SELECT = """#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const float sq = sqrtf(disc[g] > 0.0f ? disc[g] : 0.0f);
    const float tn = -b[g] - sq;
    const float tf = -b[g] + sq;
    const bool near = tn > t_min && tn < kBig;
    if (disc[g] > 0.0f && (near || (tf > t_min && tf < kBig)))
      fold(near ? tn : tf, g);
  }
"""
FORMS = {"group": GROUP, "each": EACH, "select": SELECT}
GRID = [(r, s, "group") for r in (1, 2, 4) for s in (1, 2, 4)] + [
    (r, s, form) for r, s in ((1, 1), (1, 2)) for form in ("each", "select")]
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "out", "k4_grid")


def build_all():
    """One nvcc per variant, all at once; returns {(R, S, form): (lib,
    log)}."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC_DIR, "intersect.cu")) as f:
        src = f.read()
    if src.count(GROUP) != 1:
        raise RuntimeError("sphere_group's branch was not found")
    procs = {}
    for r, s, form in GRID:
        text = re.sub(r"constexpr int kDenseRays = \d+;",
                      f"constexpr int kDenseRays = {r};", src)
        text = re.sub(r"constexpr int kDenseSplit = \d+;",
                      f"constexpr int kDenseSplit = {s};", text)
        text = text.replace(GROUP, FORMS[form])
        path = os.path.join(OUT, f"intersect_{r}_{s}_{form}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"libk4_{r}_{s}_{form}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *mk.NVCC_EXTRA_FLAGS, "-I", CSRC_DIR,
               "-o", lib, path]
        procs[(r, s, form)] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        dll = ctypes.CDLL(lib)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        dll.frt_intersect_dense.argtypes = (
            [ptr] * 3 + [i32] * 2 + [ptr] + [i32] * 3 + [ctypes.c_float]
            + [ptr] * 3)
        dll.frt_intersect_dense.restype = i32
        out[key] = (dll, log)
    return out


def k4_ptxas(log):
    """ptxas's spill and register lines of K4's entry."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = "intersect_dense_kernel" in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def launcher(dll, pack):
    def run(o, d):
        n = o.shape[0]
        t = torch.empty((n,), dtype=torch.float32, device=o.device)
        prim = torch.empty((n,), dtype=torch.int32, device=o.device)
        err = dll.frt_intersect_dense(
            o.data_ptr(), d.data_ptr(), pack.spheres.data_ptr(),
            pack.sphere_rows, pack.spheres.shape[1], pack.tris.data_ptr(),
            pack.tri_rows, pack.tris.shape[1], n, ctypes.c_float(1e-3),
            t.data_ptr(), prim.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return prim, t
    return run


def event_ms(fn, repeats, inner=1):
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def camera_rays(scene, cam, cfg):
    ids = torch.arange(RAYS, device=scene.device)
    return generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(rng.base_key(0), ids))


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all()
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = ip.pack_scene_pallas(scene)
    batches = []

    def record(scene_, accel, o, d, t_min):
        batches.append((o.clone(), d.clone()))
        return ip.intersect_pallas(scene_, accel, o, d, t_min)

    render_image(scene, cam, cfg, seed=0, accel=pack, intersect_fn=record,
                 mode="regenerative", pool_size=RAYS, device="cuda",
                 graphed=False)
    cam_rays = camera_rays(scene, cam, cfg)
    field, fcam, fcfg = build_preset("sphere-field", device="cuda", n=20000)
    fpack = ip.pack_scene_pallas(field)
    field_rays = camera_rays(field, fcam, fcfg)
    want = ip.intersect_pallas_reference(scene, pack, *cam_rays, 1e-3)
    print(f"regenerative frame: {len(batches)} batches, "
          f"{sum(o.shape[0] for o, _ in batches)} rays", flush=True)
    for (r, s, form), (dll, log) in libs.items():
        regs = k4_ptxas(log)
        run, frun = launcher(dll, pack), launcher(dll, fpack)
        prim, t = run(*cam_rays)
        if not (torch.equal(prim, want[0]) and torch.equal(t, want[1])):
            raise AssertionError(f"R={r} S={s} {form} differs from the "
                                 "plain K4")
        cam_ms = event_ms(lambda: run(*cam_rays), 11, 20)
        frame_ms = event_ms(lambda: [run(o, d) for o, d in batches], 3)
        field_ms = event_ms(lambda: frun(*field_rays), 5, 3)
        print(f"R={r} S={s} {form}: 2^17 camera rays {cam_ms:.4f} ms, "
              f"regenerative "
              f"frame {frame_ms:.2f} ms, field20000 2^17 camera rays "
              f"{field_ms:.4f} ms; ptxas {regs}", flush=True)


if __name__ == "__main__":
    main()
