"""Command-line entry point: ``render`` a preset, or ``fit`` its parameters.

Examples:
    python -m first_raytracer_tpu_torch.cli render --preset three-spheres \
        --out out/three.png
    python -m first_raytracer_tpu_torch.cli render --preset random-spheres \
        --out out/final.png               # megakernel on the GPU
    python -m first_raytracer_tpu_torch.cli render --preset sphere-field \
        --out out/field.png               # clustered megakernel: 20,004 spheres
    python -m first_raytracer_tpu_torch.cli fit --preset random-spheres \
        --nx 64 --ny 32 --spp 2 --fields albedo --opt adam --lr 0.05 --fast

``render --mode mega`` (the default) renders through the megakernel: the
CUDA kernel on a GPU, its plain PyTorch version on the CPU.  A scene of
more than ``DENSE_MAX`` (1024) spheres or triangles, such as the field
presets, goes to the clustered megakernel, as the fit step's recorder
does; ``--mode mega-clustered`` takes the clustered megakernel at any size.
``--mode wavefront`` runs the chunked wavefront integrator.

``fit`` is the inverse-rendering demo: it perturbs the chosen scene fields,
then recovers them by gradient descent on the per-ray radiance MSE against
a render of the true scene (depth capped at 8), printing a JSON line
``{"step", "loss", "max_param_err"}`` every ``--log-every`` steps and a
last line with the kernel launch counts.  ``--fast`` takes the
record->replay step (the tape recorded by the CUDA kernel on a GPU: the
clustered recorder for scenes past 1024 spheres or triangles).

``--device`` defaults to ``cuda``; ``--device cpu`` runs on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .scene.builders import PRESETS, build_preset

__all__ = ["main"]


def _build(args, device):
    kwargs = {}
    if args.nx:
        kwargs["nx"] = args.nx
    if args.ny:
        kwargs["ny"] = args.ny
    if args.spp:
        kwargs["spp"] = args.spp
    scene, camera, cfg = build_preset(args.preset, device=device, **kwargs)
    if args.max_depth:
        cfg = dataclasses.replace(cfg, max_depth=args.max_depth)
    return scene, camera, cfg


def _cmd_render(args):
    from .render.image import write_png, write_ppm

    from .kernels.megakernel import DENSE_MAX

    device = torch.device(args.device)
    scene, camera, cfg = _build(args, device)
    if args.mode == "mega" and max(scene.num_spheres,
                                   scene.num_triangles) > DENSE_MAX:
        # Informational notes go to stderr: with ``--out -`` stdout is the
        # PPM stream.
        print(f"note: more than {DENSE_MAX} spheres or triangles: "
              "--mode mega-clustered", file=sys.stderr)
        args.mode = "mega-clustered"
    t0 = time.perf_counter()
    if args.mode == "mega":
        from .kernels.megakernel import render_image_mega
        img = render_image_mega(scene, camera, cfg, seed=args.seed,
                                device=device)
    elif args.mode == "mega-clustered":
        from .kernels.megakernel_clustered import render_image_mega_clustered
        img = render_image_mega_clustered(scene, camera, cfg, seed=args.seed,
                                          device=device)
    else:
        from .render.api import render_image
        img = render_image(scene, camera, cfg, seed=args.seed, mode=args.mode,
                           device=device)
    img = img.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    out = args.out or f"{args.preset}.png"
    if out == "-":
        # PPM P3 streamed to stdout, as the reference program writes it.
        write_ppm("-", img)
        return 0
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if out.endswith(".ppm"):
        write_ppm(out, img)
    else:
        write_png(out, img)
    print(f"wrote {out} ({cfg.nx}x{cfg.ny} @ {cfg.spp}spp, {args.mode}, "
          f"{device}) in {dt:.2f}s")
    return 0


def _cmd_fit(args):
    from .core import rng
    from .diff.grad import (make_fit_step, make_fit_step_replay,
                            make_optimizer, ray_radiance, split_params)
    from .kernels.megakernel import render_pixels_mega
    from .kernels.megakernel_clustered import render_pixels_mega_clustered
    from .kernels.record_mega import (record_paths_mega,
                                      record_paths_mega_clustered)

    device = torch.device(args.device)
    scene, camera, cfg = _build(args, device)
    cfg = dataclasses.replace(cfg, max_depth=min(cfg.max_depth, 8),
                              differentiable=True)
    fields = tuple(f for f in args.fields.split(",") if f)
    key = rng.base_key(args.seed)
    ids = torch.arange(cfg.num_rays, dtype=torch.int64, device=device)

    true_params, _ = split_params(scene, fields=fields)
    with torch.no_grad():
        target = ray_radiance(true_params, scene, camera, cfg, key, ids)

    # Perturb each field by a factor in [0.6, 0.9), drawing in sorted key
    # order as the JAX package's tree_map does.
    r = np.random.RandomState(args.seed)
    params = {}
    for k in sorted(true_params):
        p = true_params[k].detach().cpu().numpy()
        p = np.clip(p * (0.6 + 0.3 * r.rand(*p.shape)), 0.02, None)
        params[k] = torch.tensor(p, dtype=torch.float32, device=device,
                                 requires_grad=True)

    opt = make_optimizer(args.opt, params, args.lr)
    make = make_fit_step_replay if args.fast else make_fit_step
    step = make(scene, camera, cfg, ids, target, opt, device=device)
    loss = None
    for i in range(args.steps):
        loss = float(step(params, key))
        if i % args.log_every == 0 or i == args.steps - 1:
            err = {k: float((params[k] - true_params[k]).detach().abs()
                            .amax()) if params[k].numel() else 0.0
                   for k in params}
            print(json.dumps({"step": i, "loss": loss,
                              "max_param_err": err}), flush=True)
        if args.checkpoint and (i % 20 == 0 or i == args.steps - 1):
            os.makedirs(os.path.dirname(args.checkpoint) or ".",
                        exist_ok=True)
            np.savez(args.checkpoint, **{k: v.detach().cpu().numpy()
                                         for k, v in params.items()})
    print(json.dumps({"fit": "done", "steps": args.steps,
                      "final_loss": loss, "device": str(device),
                      "kernel_launches": {
                          "K1": render_pixels_mega.launches,
                          "K2": render_pixels_mega.tape_launches,
                          "K2b": record_paths_mega.launches,
                          "K3": render_pixels_mega_clustered.launches,
                          "K3t": record_paths_mega_clustered.launches}}))
    return 0


def _common(sp):
    sp.add_argument("--preset", default="three-spheres",
                    choices=sorted(PRESETS))
    sp.add_argument("--nx", type=int, default=0)
    sp.add_argument("--ny", type=int, default=0)
    sp.add_argument("--spp", type=int, default=0)
    sp.add_argument("--max-depth", type=int, default=0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the "
                         "host)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="first_raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("render", help="render a preset to PNG or PPM")
    sp.set_defaults(fn=_cmd_render)
    _common(sp)
    sp.add_argument("--out", default="",
                    help="output .png or .ppm; '-' streams PPM to stdout")
    sp.add_argument("--mode", default="mega",
                    choices=("mega", "mega-clustered", "wavefront"),
                    help="mega: the megakernel (CUDA kernel on a GPU), "
                         "clustered past 1024 spheres or triangles; "
                         "mega-clustered: the clustered megakernel at any "
                         "size; wavefront: the chunked wavefront integrator")
    fp = sub.add_parser("fit", help="recover perturbed scene parameters by "
                                    "gradient descent")
    fp.set_defaults(fn=_cmd_fit)
    _common(fp)
    fp.add_argument("--fields", default="albedo",
                    help="comma-separated fields of diff.grad.DIFF_FIELDS")
    fp.add_argument("--opt", default="sgd",
                    choices=("sgd", "adam", "adamw", "rmsprop"),
                    help="torch.optim optimizer (diff.grad.make_optimizer)")
    fp.add_argument("--steps", type=int, default=60)
    fp.add_argument("--lr", type=float, default=0.8)
    fp.add_argument("--log-every", type=int, default=10)
    fp.add_argument("--fast", action="store_true",
                    help="record->replay step: tape recorder (the CUDA "
                         "kernel on a GPU) and depth-bucketed replay")
    fp.add_argument("--checkpoint", default="",
                    help="write the learned parameters to this .npz")
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
