"""Path lengths of the final scene: the wavefront integrator against K1.

The megakernels' mean path length (segments over rays) is held against
the wavefront integrator's (``utils/metrics.py``).  The two trace the same
rays with the same RNG but find their sphere roots by different formulas
(K1 the expanded quadratic, the wavefront the oc-form), so a path that
grazes a surface can part between them and go on to another length; the
same holds between one formula's float32 arithmetic on the CPU and on a
GPU.  This probe says how many rays part, where, and what that does to the
mean:

- ``--small``: random-spheres 64x32 @ 8 (2^14 rays, every ray of the
  frame, as ``cli occupancy`` counts them): each ray's wavefront segments
  (closest hit by the brute-force sweep, and by K4 on a GPU) and K2b
  trips (the megakernels' segments of that ray);
- ``--full`` (GPU): the final scene at full size (1200x800 @ 10), the same
  per ray, per band of 100 rows and over the whole frame, and the seconds
  and peak memory of ``wavefront_occupancy`` over the whole frame;
- ``--band R0 N``: the brute-force wavefront's and K2b's segments of ray
  ids [R0, R0 + N) of the full-size frame.

Each run saves its per-ray arrays into ``--out``.  Run from the
repository root:

    python probes/path_length.py --device cuda --small --full \\
        --band 4800000 131072 --out out/pl_cuda
    python probes/path_length.py --device cpu --small \\
        --band 4800000 131072 --out out/pl_cpu
    python probes/path_length.py --compare out/pl_cuda/small.npz \\
        out/pl_cpu/small.npz

``--compare`` prints how the two runs' paths (the brute-force wavefront's
and K2b's of each) part, and the rays that part most.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels import record_mega as rm  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa
from first_raytracer_tpu_torch.utils import metrics  # noqa: E402


def per_ray(scene, cam, cfg, key, pack, accel, r0, n, chunk=1 << 17):
    """Segments of ray ids [r0, r0 + n) by the brute-force wavefront, by
    the wavefront on K4 (``accel``, when given) and by K2b."""
    dev = pack.device
    out = {"brute": [], "k2b": []}
    if accel is not None:
        out["k4"] = []
    for c0 in range(r0, r0 + n, chunk):
        m = min(chunk, r0 + n - c0)
        ids = torch.arange(c0, c0 + m, device=dev)
        out["brute"].append(metrics._path_lengths(scene, cam, cfg, key, ids,
                                                  None).cpu().numpy())
        if accel is not None:
            out["k4"].append(metrics._path_lengths(
                scene, cam, cfg, key, ids, accel).cpu().numpy())
        out["k2b"].append(rm.record_paths_mega(
            pack, cam, cfg, key, ray0=c0, num_rays=m,
            return_iters=True)[1].cpu().numpy())
    return {k: np.concatenate(v).astype(np.int64) for k, v in out.items()}


def stats(paths, sl, cap):
    line = {}
    for k, v in paths.items():
        line[f"{k}_mean"] = float(v[sl].mean())
        line[f"{k}_capped"] = int((v[sl] == cap).sum())
    for a, b in (("brute", "k2b"), ("k4", "k2b"), ("k4", "brute")):
        if a in paths and b in paths:
            d = paths[a][sl] - paths[b][sl]
            line[f"{a}-{b} (rays, segments)"] = [int((d != 0).sum()),
                                                 int(d.sum())]
    return line


def small(dev, out_dir):
    scene, cam, cfg = build_preset("random-spheres", device=dev, nx=64,
                                   ny=32, spp=8)
    key = rng.base_key(0)
    pack = mk.pack_scene_mega(scene, dev)
    accel = ip.pack_scene_pallas(scene) if dev.type == "cuda" else None
    paths = per_ray(scene, cam, cfg, key, pack, accel, 0, cfg.num_rays)
    _, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    if not (paths["k2b"].reshape(-1, cfg.spp).sum(1)
            == segs.cpu().numpy()).all():
        raise AssertionError("K2b's trips per pixel are not K1's segments")
    print(json.dumps({"small": "random-spheres 64x32 @ 8", "device":
                      str(dev), **stats(paths, slice(None),
                                        cfg.max_depth + 1)}), flush=True)
    np.savez_compressed(os.path.join(out_dir, "small.npz"), **paths)


def full(dev, out_dir):
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    key = rng.base_key(0)
    pack = mk.pack_scene_mega(scene, dev)
    accel = ip.pack_scene_pallas(scene)
    paths = per_ray(scene, cam, cfg, key, pack, accel, 0, cfg.num_rays)
    _, segs = mk.render_pixels_mega(pack, cam, cfg, key)
    segs = segs.long().cpu().numpy()
    if not (paths["k2b"].reshape(-1, cfg.spp).sum(1) == segs).all():
        raise AssertionError("K2b's trips per pixel are not K1's segments")
    # The whole frame, then bands of 100 rows (pixel 0 is the bottom row).
    row = cfg.num_rays // cfg.ny
    for lo, hi in [(0, cfg.ny)] + [(r, r + 100) for r in range(0, cfg.ny,
                                                                100)]:
        print(json.dumps({"rows": [lo, hi], **stats(
            paths, slice(lo * row, hi * row), cfg.max_depth + 1)}),
            flush=True)
    np.savez_compressed(os.path.join(out_dir, "full.npz"),
                        **{k: v.astype(np.int8) for k, v in paths.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = metrics.wavefront_occupancy(scene, cam, cfg, accel=accel,
                                      num_rays=cfg.num_rays, device=dev)
    torch.cuda.synchronize()
    print(json.dumps({
        "wavefront_occupancy_whole_frame_s": time.perf_counter() - t0,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "avg_path_length": rep["avg_path_length"],
        "k1_segments_over_rays": float(segs.sum()) / cfg.num_rays}),
        flush=True)


def band(dev, out_dir, r0, n):
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    key = rng.base_key(0)
    pack = mk.pack_scene_mega(scene, dev)
    paths = per_ray(scene, cam, cfg, key, pack, None, r0, n, chunk=1 << 14)
    print(json.dumps({"band": [r0, n], "device": str(dev), **stats(
        paths, slice(None), cfg.max_depth + 1)}), flush=True)
    np.savez_compressed(os.path.join(out_dir, f"band_{r0}.npz"), **paths)


def compare(a_path, b_path):
    a, b = np.load(a_path), np.load(b_path)
    paths = {f"{name} {what}": run[key]
             for name, run in (("a", a), ("b", b))
             for what, key in (("wavefront", "brute"), ("K2b", "k2b"))}
    ref = paths["a wavefront"]
    parted = np.nonzero(np.any([p != ref for p in paths.values()],
                               axis=0))[0]
    print(f"{len(parted)} of {ref.size} rays part between the paths; "
          "means: " + ", ".join(f"{k} {v.mean():.6f}"
                                for k, v in paths.items()))
    for x, y in (("a wavefront", "b wavefront"), ("a K2b", "b K2b"),
                 ("a wavefront", "a K2b"), ("b wavefront", "b K2b")):
        d = paths[x] - paths[y]
        print(f"  {x} - {y}: {int((d != 0).sum())} rays, "
              f"{int(d.sum())} segments")
    spread = np.ptp(np.stack([p[parted] for p in paths.values()]), axis=0)
    for i in parted[np.argsort(-spread, kind="stable")][:12]:
        print(f"  ray {i}: " + ", ".join(f"{k} {int(v[i])}"
                                         for k, v in paths.items()))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--small", action="store_true")
    p.add_argument("--full", action="store_true")
    p.add_argument("--band", nargs=2, type=int, metavar=("R0", "N"))
    p.add_argument("--out", default="out/path_length")
    p.add_argument("--compare", nargs=2)
    args = p.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    dev = torch.device(args.device)
    os.makedirs(args.out, exist_ok=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    if args.small:
        small(dev, args.out)
    if args.band:
        band(dev, args.out, *args.band)
    if args.full:
        full(dev, args.out)


if __name__ == "__main__":
    main()
