"""K1's and K3's constants, tried on the card.

``kernels/csrc/megakernel.cu`` fixes ``__launch_bounds__(kThreads, 8)`` on
K1 (at most 64 registers, eight blocks an SM) and its ``kMaxChunk`` (the
samples of a pixel in a unit of a warp's work, 8);
``kernels/csrc/megakernel_clustered.cu`` fixes K3's
``__launch_bounds__(kThreads, 5)``, its ``kMaxChunk`` (2) and ``kMaxSplit``
(the most lanes that share one (ray, cluster) pair: 1 sweeps each pair on
the lane of its ray, 32 spreads the pairs of an opened cluster over the
whole warp).  This probe builds a copy of the sources for each variant
below, one nvcc each, all started together, into ``out/mega_grid/``;
checks each variant's output equal to the source's as built (which
chip_smoke.py holds to the plain versions: the schedule must not change a
result); and times it with CUDA events, median of 5 after a warm launch:

- K1 on the final scene (1200x800 @ 10) and K2b at its first 2^17 ray ids;
- K3 on field20000, field5000 and trifield20000 (800x450 @ 4).

Run from the repository root on a GPU host:

    python probes/mega_grid.py
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import record_mega as rm  # noqa: E402
from first_raytracer_tpu_torch.kernels.build import (CSRC_DIR,  # noqa: E402
                                                     NVCC_FLAGS, _nvcc)
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501

K1_BOUNDS = "__launch_bounds__(kThreads, 8)\n    mega_kernel("
K3_BOUNDS = "__launch_bounds__(kThreads, 5)\n    mega_clustered_kernel("
SPLIT = "constexpr int kMaxSplit = 32;"
# name -> [(file, text in the source, its replacement)]
K1_CHUNK = "constexpr int kMaxChunk = 8;"
K3_CHUNK = "constexpr int kMaxChunk = 2;"
VARIANTS = {"source": []}
for b in (6, 5):
    VARIANTS[f"K1 blocks {b}"] = [(
        "megakernel.cu", K1_BOUNDS, K1_BOUNDS.replace("8)", f"{b})"))]
for c in (2, 4):
    VARIANTS[f"K1 chunk {c}"] = [(
        "megakernel.cu", K1_CHUNK, K1_CHUNK.replace("8", str(c)))]
for s in (1, 8):
    VARIANTS[f"K3 split {s}"] = [(
        "megakernel_clustered.cu", SPLIT,
        SPLIT.replace("32", str(s)))]
for b in (4, 6):
    VARIANTS[f"K3 blocks {b}"] = [(
        "megakernel_clustered.cu", K3_BOUNDS,
        K3_BOUNDS.replace("5)", f"{b})"))]
for c in (1, 4):
    VARIANTS[f"K3 chunk {c}"] = [(
        "megakernel_clustered.cu", K3_CHUNK, K3_CHUNK.replace("2", str(c)))]
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "out", "mega_grid")


def build_all():
    """One nvcc per variant, all at once; returns {name: (lib, log)}."""
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = os.path.join(OUT, f"v{i}")
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(CSRC_DIR, src)
        for fname, old, new in subs:
            path = os.path.join(src, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not found once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        lib = os.path.join(OUT, f"libv{i}.so")
        units = [os.path.join(src, n) for n in (
            mk.KERNEL_SOURCE, mk.CLUSTERED_SOURCE, mk.INTERSECT_SOURCE)]
        cmd = [_nvcc(), *NVCC_FLAGS, *mk.NVCC_EXTRA_FLAGS, "-o", lib, *units]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (mk.bind(ctypes.CDLL(lib)), log)
    return out


def ptxas(log, entry):
    """ptxas's register and spill lines of the entries named ``entry``."""
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = entry in line
        elif inside and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def use(lib):
    """Points the wrappers' launches at ``lib``."""
    def entry(dev, name, *args):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(
            dev).cuda_stream)
        if err:
            raise RuntimeError(f"{name} failed ({err})")
    mk.launch_entry = entry


def event_ms(fn, repeats=5):
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
    return statistics.median(times)


def main():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all()
    key = rng.base_key(0)
    final = build_preset("random-spheres", device="cuda")
    fpack = mk.pack_scene_mega(final[0])
    fields = {}
    for label, preset in (("field20000", "sphere-field"),
                          ("field5000", "sphere-field"),
                          ("trifield20000", "triangle-field")):
        scene, cam, cfg = build_preset(preset, device="cuda",
                                       n=int(label.split("field")[1]))
        fields[label] = (mc.pack_scene_mega_clustered(scene, cam), cam, cfg)

    def k1():
        return mk.render_pixels_mega(fpack, final[1], final[2], key)

    def k2b():
        return rm.record_paths_mega(fpack, final[1], final[2], key,
                                    num_rays=1 << 17)

    def k3(label):
        p, cam, cfg = fields[label]
        return mc.render_pixels_mega_clustered(p, cam, cfg, key)

    want = None
    for name, (lib, log) in libs.items():
        use(lib)
        got = [k1()[0], k2b()] + [k3(f)[0] for f in fields]
        if want is None:
            want = got
        elif not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: output differs from the source's")
        times = [event_ms(k1), event_ms(k2b)] + [
            event_ms(lambda: k3(f)) for f in fields]
        print(f"{name}: K1 {times[0]:.3f} ms, K2b 2^17 {times[1]:.4f} ms, "
              f"K3 field20000 {times[2]:.3f}, field5000 {times[3]:.3f}, "
              f"trifield20000 {times[4]:.3f} ms; ptxas K1 "
              f"{ptxas(log, 'mega_kernelILb0')}, K3 "
              f"{ptxas(log, 'mega_clustered_kernel')}", flush=True)


if __name__ == "__main__":
    main()
