"""The megakernels' sphere root against other forms of it, on a far field.

The plain K3t (``record_paths_mega_clustered_reference``) records the first
``--rays`` ray ids of ``sphere_field(n)`` (800x450 @ 4, depth 50, seed 0)
with its sphere sweep replaced by each form named, and each tape is held
against the plain wavefront ``record_paths`` on the same rays, in float32
and in float64 (the scene and the camera rays cast to float64):

- ``port``: the port's root (b, c, the discriminant and the roots in
  float64, each root rounded once to float32; ``kernels/megakernel.py::
  _sweep``);
- ``f64bc``: b and c in float64, each rounded once to float32, the
  discriminant and the roots in float32;
- ``f32oc``: the wavefront's oc-form in float32 (``geometry/sphere.py``);
- ``expanded``: the JAX kernels' expanded quadratic, c = |o|^2 - 2 o.C +
  c0, in float32 op by op (the megakernels' earlier root).

One JSON line per form: per-entry agreement and the rays that differ
against each wavefront, and the paths at the depth cap.  Runs on the CPU
or a GPU (``--device``); nothing is timed.

    python probes/sphere_roots.py --n 20000 --rays 4096 --device cpu
"""
import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from first_raytracer_tpu_torch.core import rng, vecmath  # noqa: E402
from first_raytracer_tpu_torch.diff.replay import record_paths  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import record_mega as rm  # noqa: E402
from first_raytracer_tpu_torch.render.camera import generate_rays  # noqa: E402,E501
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501

PORT = mk._sweep


def _roots(tn, tf, t_min):
    """The sweep's winner from per-(ray, column) roots, as ``_sweep``."""
    tall = torch.where(tn > t_min, tn, torch.where(tf > t_min, tf, mk.BIG))
    w = torch.argmin(tall, dim=1)
    t = torch.gather(tall, 1, w[:, None])[:, 0]
    return t, w, torch.zeros_like(w), torch.zeros_like(w, dtype=torch.bool)


def sweep_f64bc(mx, tri, o, d, t_min):
    cx, cy, cz, r = mx[:, 4:8].double().T
    o64, d64 = o.double(), d.double()
    px, py, pz = o64[:, 0:1] - cx, o64[:, 1:2] - cy, o64[:, 2:3] - cz
    b = (d64[:, 0:1] * px + d64[:, 1:2] * py + d64[:, 2:3] * pz).float()
    c = (px * px + py * py + pz * pz - r * r).float()
    disc = b * b - c
    sq = vecmath.sqrt(torch.where(disc >= 0, disc, -1.0))
    return _roots(-b - sq, sq - b, t_min)


def sweep_f32oc(mx, tri, o, d, t_min):
    cx, cy, cz, r = mx[:, 4:8].T
    px, py, pz = o[:, 0:1] - cx, o[:, 1:2] - cy, o[:, 2:3] - cz
    b = d[:, 0:1] * px + d[:, 1:2] * py + d[:, 2:3] * pz
    c = px * px + py * py + pz * pz - r * r
    disc = b * b - c
    sq = vecmath.sqrt(torch.where(disc > 0, disc, -1.0))
    return _roots(-b - sq, sq - b, t_min)


def sweep_expanded(mx, tri, o, d, t_min):
    cx, cy, cz, c0 = mx[:, 0:4].T
    od = (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1] + o[:, 2] * d[:, 2])[:, None]
    oo = (o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1] + o[:, 2] * o[:, 2])[:, None]
    b = od - (cx * d[:, 0:1] + cy * d[:, 1:2] + cz * d[:, 2:3])
    c = oo - 2.0 * (cx * o[:, 0:1] + cy * o[:, 1:2] + cz * o[:, 2:3]) + c0
    sq = vecmath.sqrt(b * b - c)
    return _roots(-b - sq, sq - b, t_min)


FORMS = {"port": PORT, "f64bc": sweep_f64bc, "f32oc": sweep_f32oc,
         "expanded": sweep_expanded}


def to_f64(obj):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).double()
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).is_floating_point()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--chunk", type=int, default=1 << 12)
    ap.add_argument("--forms", default=",".join(FORMS))
    args = ap.parse_args()
    scene, cam, cfg = build_preset("sphere-field", device=args.device,
                                   n=args.n)
    key = rng.base_key(0)
    waves = {"f32": [], "f64": []}
    for lo in range(0, args.rays, args.chunk):
        ids = torch.arange(lo, min(lo + args.chunk, args.rays),
                           device=args.device)
        o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                             rng.camera_uniforms(key, ids))
        waves["f32"].append(record_paths(scene, o, d, ids, key, cfg))
        waves["f64"].append(record_paths(to_f64(scene), o.double(),
                                         d.double(), ids, key, cfg))
    waves = {k: torch.cat(v, dim=1) for k, v in waves.items()}
    pack = mc.pack_scene_mega_clustered(scene, cam)
    out = {"n": args.n, "rays": args.rays, "device": args.device,
           "f32_vs_f64_wavefront": float(
               (waves["f32"] == waves["f64"]).float().mean())}
    print(json.dumps(out), flush=True)
    for name in args.forms.split(","):
        mk._sweep = mc._sweep = FORMS[name]
        try:
            tape, _ = rm.record_paths_mega_clustered_reference(
                pack, cam, cfg, key, num_rays=args.rays)
        finally:
            mk._sweep = mc._sweep = PORT
        row = {"form": name, "capped": int((tape[-1] >= 0).sum())}
        for k, w in waves.items():
            row[f"agree_{k}"] = float((tape == w).float().mean())
            row[f"rays_{k}"] = int((tape != w).any(dim=0).sum())
        row["wavefront_capped"] = {k: int((w[-1] >= 0).sum())
                                   for k, w in waves.items()}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
