"""The megakernels' and recorders' constants, tried on the card.

``kernels/csrc/megakernel.cu`` fixes ``__launch_bounds__(kThreads, 8)`` on
K1 (at most 64 registers, eight blocks an SM) and ``(kThreads, 5)`` on
K2b, and K1's ``kMaxChunk`` (the samples of a pixel in a unit of a warp's
work, 8);
``kernels/csrc/megakernel_clustered.cu`` fixes K3's
``__launch_bounds__(kThreads, 5)`` and K3t's ``(kThreads, 4)``, K3's
``kMaxChunk`` (2) and ``kMaxSplit`` (the most lanes that share one (ray,
cluster) pair: 1 sweeps each pair on the lane of its ray, 32 spreads the
pairs of an opened cluster over the whole warp);
``kernels/csrc/mega_common.cuh`` fixes the recorders' ``kRecordWindow``
(the consecutive ray ids a warp takes at a time, 16).  This probe builds a
copy of the sources for each
variant below, one nvcc each, all started together, into
``out/mega_grid/``; checks each variant's outputs equal to the source's as
built (which chip_smoke.py holds to the plain versions: the schedule must
not change a result); and times them with CUDA events, median of 5 after a
warm launch, in two rounds (the variants in turn, then in reverse order).
The recorders at 2^17 rays take less than a millisecond, of which the
wrappers' host work would be a part, so those are timed over 10 calls
queued back to back between two events (the host stays ahead of the
card), per call.  Groups of variants, by the first word of
their names:

- K1, K3: K1 on the final scene (1200x800 @ 10) and K2b at its first 2^17
  ray ids; K3 on field20000, field5000 and trifield20000 (800x450 @ 4);
- K2b, K3t, window, tail (the recorders): K2b at the final scene's first
  2^17 ray ids and over its whole frame, K3t at the first 2^17 ray ids of
  field5000 and field20000, each with its warp lane efficiency (trips over
  32 x the warps' steps); the "tail" variant makes each warp count apart
  the steps it takes after it found the launch's ray ids all handed out,
  and prints that share of the steps; "walk" varies K3's and K3t's
  ``kMinWalkSplit`` (the fewest lanes a ray's gates take when a warp's few
  live rays walk their gates together; 64 never walks) and times K3 too.

Run from the repository root on a GPU host, all groups or those named:

    python probes/mega_grid.py [K1 K3 K2b K3t window tail walk]
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
K2B_BOUNDS = "__launch_bounds__(kThreads, 5)\n    record_kernel("
K3_BOUNDS = "__launch_bounds__(kThreads, 5)\n    mega_clustered_kernel("
K3T_BOUNDS = "__launch_bounds__(kThreads, 4)\n    record_clustered_kernel("
SPLIT = "constexpr int kMaxSplit = 32;"
K1_CHUNK = "constexpr int kMaxChunk = 8;"
K3_CHUNK = "constexpr int kMaxChunk = 2;"
WINDOW = "constexpr int kRecordWindow = 16;"
WALK = "constexpr int kMinWalkSplit = 8;"
STEP = ("    if (!__any_sync(kFullMask, live)) break;  // no ids left, paths "
        "done\n    ++nsteps;")
# Steps after the warp found the ids exhausted, in the high 16 bits.
TAIL_STEP = STEP.replace("++nsteps;", "nsteps += exhausted ? 0x10001 : 1;")
# name -> [(file, text in the source, its replacement)]
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
for b in (4, 6, 8):
    VARIANTS[f"K2b blocks {b}"] = [(
        "megakernel.cu", K2B_BOUNDS, K2B_BOUNDS.replace("5)", f"{b})"))]
for b in (3, 5, 6):
    VARIANTS[f"K3t blocks {b}"] = [(
        "megakernel_clustered.cu", K3T_BOUNDS,
        K3T_BOUNDS.replace("4)", f"{b})"))]
for w in (4, 8, 32, 64):
    VARIANTS[f"window {w}"] = [(
        "mega_common.cuh", WINDOW, WINDOW.replace("16", str(w)))]
VARIANTS["tail"] = [("mega_common.cuh", STEP, TAIL_STEP)]
for w in (4, 16, 32, 64):
    VARIANTS[f"walk {w}"] = [(
        "megakernel_clustered.cu", WALK, WALK.replace("8", str(w)))]
RECORDERS = ("K2b", "K3t", "window", "tail", "walk")
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "out", "mega_grid")


def build_all(variants):
    """One nvcc per variant, all at once; returns {name: (lib, log)}."""
    procs = {}
    for i, (name, subs) in enumerate(variants.items()):
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


def queued_ms(fn, repeats=5, calls=10):
    """Median milliseconds per call of ``fn``, ``calls`` calls queued back
    to back between two events."""
    return event_ms(lambda: [fn() for _ in range(calls)], repeats) / calls


def lanes(its, steps):
    """Lane efficiency and the share of the steps taken after the warp
    found the ids exhausted (the tail variant's high bits, else 0)."""
    steps = steps.long()
    total, tail = int((steps & 0xFFFF).sum()), int((steps >> 16).sum())
    return (f"lane efficiency {int(its.long().sum()) / (32 * total):.4f}, "
            f"tail {tail / total:.4f} of {total} steps")


def main():
    groups = sys.argv[1:]
    variants = {n: v for n, v in VARIANTS.items() if n == "source" or not
                groups or any(n.startswith(g) for g in groups)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all(variants)
    key = rng.base_key(0)
    final = build_preset("random-spheres", device="cuda")
    fpack = mk.pack_scene_mega(final[0])
    cam_row = mk.camera_table(final[1]).cuda()
    fields = {}
    for label, preset in (("field20000", "sphere-field"),
                          ("field5000", "sphere-field"),
                          ("trifield20000", "triangle-field")):
        scene, cam, cfg = build_preset(preset, device="cuda",
                                       n=int(label.split("field")[1]))
        fields[label] = (mc.pack_scene_mega_clustered(scene, cam), cam, cfg)

    def k1():
        return mk.render_pixels_mega(fpack, final[1], final[2], key)

    def k2b(n=1 << 17):
        return rm.record_paths_mega(fpack, final[1], final[2], key,
                                    num_rays=n)

    def k3(label):
        p, cam, cfg = fields[label]
        return mc.render_pixels_mega_clustered(p, cam, cfg, key)

    def k3t(label):
        p, cam, cfg = fields[label]
        return rm.record_paths_mega_clustered(p, cam, cfg, key,
                                              num_rays=1 << 17,
                                              return_iters=True)

    frame = final[2].num_rays
    want = None
    for name, (lib, log) in libs.items():  # outputs against the source's
        use(lib)
        rec = name == "source" or name.startswith(RECORDERS)
        got = {"K1": k1()[0], "K2b": k2b()}
        if rec:
            got["K2b frame"] = k2b(frame)
            for f in ("field5000", "field20000"):
                tape, its, sweeps = k3t(f)
                got[f"K3t {f}"] = (tape, its, sweeps[:, :4])
        if not rec or name.startswith(("source", "walk")):
            got.update({f"K3 {f}": k3(f)[0] for f in fields})
        if want is None:
            want = got
        for what, out in got.items():
            out = out if isinstance(out, tuple) else (out,)
            ref = want[what] if isinstance(want[what], tuple) else (
                want[what],)
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"{name}: {what} differs from the "
                                     "source's")
        del got
        torch.cuda.empty_cache()
    del want
    torch.cuda.empty_cache()
    names = list(libs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            lib, log = libs[name]
            use(lib)
            time_variant(name, log, rnd, k1, k2b, k3, k3t, fields, fpack,
                         cam_row, final, key, frame)


def time_variant(name, log, rnd, k1, k2b, k3, k3t, fields, fpack, cam_row,
                 final, key, frame):
    """Prints one round's times of variant ``name``."""
    rec = name == "source" or name.startswith(RECORDERS)
    tag = f"round {rnd + 1} {name}"
    if not rec or name.startswith(("source", "walk")):
        times = [event_ms(k1), queued_ms(k2b)] + [
            event_ms(lambda: k3(f)) for f in fields]
        print(f"{tag}: K1 {times[0]:.3f} ms, K2b 2^17 {times[1]:.4f} "
              f"ms, K3 field20000 {times[2]:.3f}, field5000 "
              f"{times[3]:.3f}, trifield20000 {times[4]:.3f} ms; ptxas "
              f"K1 {ptxas(log, 'mega_kernelILb0')}, K3 "
              f"{ptxas(log, 'mega_clustered_kernel')}", flush=True)
    if not rec:
        return
    parts = []
    for n, what in ((1 << 17, "2^17"), (frame, "frame")):
        _, its, steps = rm._launch_record(fpack, cam_row, final[2], key, 0,
                                          n, final[2].spp,
                                          return_steps=True)
        ms = queued_ms(lambda: k2b(n)) if n < frame else event_ms(
            lambda: k2b(n))
        parts.append(f"K2b {what} {ms:.4f} ms ({lanes(its, steps)})")
        del its, steps
        torch.cuda.empty_cache()
    for f in ("field5000", "field20000"):
        _, its, sweeps = k3t(f)
        parts.append(f"K3t {f} {queued_ms(lambda: k3t(f)):.4f} ms "
                     f"({lanes(its, sweeps[:, 5])})")
    if name == "source":
        parts.append(f"K1 {event_ms(k1):.3f} ms")
    print(f"{tag}: " + "; ".join(parts) + f"; ptxas K2b "
          f"{ptxas(log, 'record_kernel')}, K3t "
          f"{ptxas(log, 'record_clustered_kernel')}", flush=True)


if __name__ == "__main__":
    main()
