"""Command-line entry point: ``render`` a preset, ``bench`` a ray batch,
``fit`` a preset's parameters, report ``occupancy`` or ``compare`` two
images.

Examples:
    python -m first_raytracer_tpu_torch.cli render --preset three-spheres \
        --out out/three.png
    python -m first_raytracer_tpu_torch.cli render --preset random-spheres \
        --out out/final.png               # megakernel on the GPU
    python -m first_raytracer_tpu_torch.cli render --preset sphere-field \
        --out out/field.png               # clustered megakernel: 20,004 spheres
    python -m first_raytracer_tpu_torch.cli render --preset sphere-field \
        --mode wavefront --clustered      # wavefront, clustered closest hit
    python -m first_raytracer_tpu_torch.cli render --preset random-spheres \
        --mode wavefront --spp 10 --checkpoint out/final.ckpt.npz
    python -m first_raytracer_tpu_torch.cli bench --preset random-spheres \
        --bvh --rays 4096
    python -m first_raytracer_tpu_torch.cli fit --preset random-spheres \
        --nx 64 --ny 32 --spp 2 --fields albedo --opt adam --lr 0.05 --fast
    python -m first_raytracer_tpu_torch.cli occupancy --preset random-spheres
    python -m first_raytracer_tpu_torch.cli compare a.png b.ppm \
        --max-frac-gt-4 0.01
    torchrun --nproc-per-node 2 -m first_raytracer_tpu_torch.cli render \
        --preset random-spheres --mode mega --out out/final.png

``render --mode mega`` (the default) renders through the megakernel: the
CUDA kernel on a GPU, its plain PyTorch version on the CPU.  A scene of
more than ``DENSE_MAX`` (1024) spheres or triangles, such as the field
presets, goes to the clustered megakernel, as the fit step's recorder
does; ``--mode mega-clustered`` (or ``--clustered`` with ``--mode mega``)
takes the clustered megakernel at any size.  ``--mode wavefront`` runs the
chunked wavefront integrator and ``--mode regenerative`` its compacted
ray pool; their closest hit is the dense sweep, the clustered kernel K5
with ``--clustered``, or the flat-BVH walk K6 with ``--bvh``; on a GPU
their loops replay as CUDA graphs with any of the three (the line
``render`` prints ends with the loops' captures, replays, passes and flag
reads).  ``--checkpoint`` renders in resumable batches
of ``--batch-spp`` samples through the wavefront integrator, writing a
running-mean PNG after every batch with ``--preview``.  ``--mode ring``
splits the scene's primitives over every rank and passes the shards
around a ring each bounce (``parallel/ring.py``).

Under ``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``) ``render`` joins the process group
(NCCL when each process has a GPU of its own, else gloo) and shards the
render over all ranks, each on its own GPU (``LOCAL_RANK``): ``mega`` and
``mega-clustered`` by pixel ranges (``render_image_mega_sharded``,
``render_image_mega_clustered_sharded``), ``wavefront`` by blocks of
pixels (``parallel.shard.render_image_sharded``), ``ring`` by the scene;
rank 0 writes the image.  ``regenerative`` and ``--checkpoint`` run in one
process only.

``bench`` times one ``render_ray_batch`` of ``--rays`` rays (best of 3
after a warm run) and prints one JSON line.

``fit`` is the inverse-rendering demo: it perturbs the chosen scene fields,
then recovers them by gradient descent on the per-ray radiance MSE against
a render of the true scene (depth capped at 8), printing a JSON line
``{"step", "loss", "max_param_err"}`` every ``--log-every`` steps and a
last line with the kernel launch counts, the replay's CUDA graphs captured
and replayed (``graphs``) and the recorder loops' (``loops``: captures,
block replays, passes, live passes and flag reads).  Without ``--fast``
it takes the direct step (``make_fit_step``): on a GPU the wavefront
recorder's loop and the value and gradient of the whole tape's replay are
CUDA graphs, replayed every step (``--bvh`` too: K6 walks on the card).
``--fast`` takes the record->replay step (the tape recorded by the CUDA
kernel on a GPU: the clustered recorder for scenes
past 1024 spheres or triangles; on a GPU the replay's value and gradient is
a CUDA graph, captured once per plan shape: a fit that moves geometry
changes its plan, and so captures, every step, about 1.5x slower than
eager).  ``occupancy``'s wavefront scan is the recorder's loop too.

``occupancy`` prints the JAX package's occupancy report as JSON: the
wavefront's rays alive per bounce over the first 2^14 rays, and the
megakernels' lane occupancy (``utils/metrics.py``).  ``compare`` prints
the difference statistics of two images (PPM P3/P6, PNG or npz) and, with
``--max-frac-gt-4``, exits 1 when more than that fraction of pixels differ
by more than 4/255 in a channel.

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
    """The preset's scene, camera and config on ``device``, and the accel
    that ``--clustered`` or ``--bvh`` asks for (None without either)."""
    from .accel.build import build_bvh
    from .kernels.intersect_clustered import pack_scene_clustered

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
    accel = None
    if args.clustered:
        accel = pack_scene_clustered(scene)
    elif args.bvh:
        accel = build_bvh(scene, max_leaf=4)
    return scene, camera, cfg, accel


def _join_group():
    """The process group of a ``torchrun``-style launch (a no-op for one
    process); returns the world size."""
    from .parallel.mesh import initialize_distributed

    world = int(os.environ.get("WORLD_SIZE", "1"))
    initialize_distributed(None, world, int(os.environ.get("RANK", "0")))
    return world


def _render_sharded(args, scene, camera, cfg, accel, device):
    """The render of ``args.mode`` over a mesh of every rank."""
    from .kernels.megakernel import render_image_mega_sharded
    from .kernels.megakernel_clustered import (
        render_image_mega_clustered_sharded)
    from .parallel.mesh import make_render_mesh
    from .parallel.ring import render_image_ring
    from .parallel.shard import render_image_sharded

    mesh = make_render_mesh()
    if args.mode == "mega":
        return render_image_mega_sharded(scene, camera, cfg, mesh,
                                         seed=args.seed, device=device)
    if args.mode == "mega-clustered":
        return render_image_mega_clustered_sharded(
            scene, camera, cfg, mesh, seed=args.seed, device=device)
    if args.mode == "ring":
        return render_image_ring(scene, camera, cfg, mesh, seed=args.seed,
                                 device=device)
    return render_image_sharded(scene, camera, cfg, mesh, seed=args.seed,
                                accel=accel, device=device)


def _cmd_render(args):
    from .render.image import write_png, write_ppm

    from .kernels.megakernel import DENSE_MAX
    from .parallel.mesh import local_device

    world = _join_group()
    if world > 1 and (args.checkpoint or args.mode == "regenerative"):
        raise SystemExit("--checkpoint and --mode regenerative run in one "
                         "process")
    device = local_device(args.device)
    scene, camera, cfg, accel = _build(args, device)
    if args.mode == "mega" and (args.clustered or max(
            scene.num_spheres, scene.num_triangles) > DENSE_MAX):
        # Informational notes go to stderr: with ``--out -`` stdout is the
        # PPM stream.
        why = ("--clustered" if args.clustered else
               f"more than {DENSE_MAX} spheres or triangles")
        print(f"note: {why}: --mode mega-clustered", file=sys.stderr)
        args.mode = "mega-clustered"
    if args.bvh and args.mode.startswith("mega") and not args.checkpoint:
        raise SystemExit("--bvh needs --mode wavefront or regenerative")
    t0 = time.perf_counter()
    if world > 1 or args.mode == "ring":
        img = _render_sharded(args, scene, camera, cfg, accel, device)
    elif args.checkpoint:
        from .render.progressive import progressive_render
        on_batch = None
        if args.preview:
            os.makedirs(os.path.dirname(args.preview) or ".", exist_ok=True)

            def on_batch(state):
                write_png(args.preview, state.image(cfg))
                print(f"preview @ {state.samples_done}/{cfg.spp} spp "
                      f"-> {args.preview}", file=sys.stderr)
        img = torch.from_numpy(progressive_render(
            scene, camera, cfg, seed=args.seed, accel=accel,
            checkpoint_path=args.checkpoint,
            samples_per_batch=args.batch_spp, on_batch=on_batch,
            device=device).copy())
    elif args.mode == "mega":
        from .kernels.megakernel import render_image_mega
        img = render_image_mega(scene, camera, cfg, seed=args.seed,
                                device=device)
    elif args.mode == "mega-clustered":
        from .kernels.megakernel_clustered import render_image_mega_clustered
        img = render_image_mega_clustered(scene, camera, cfg, seed=args.seed,
                                          device=device)
    else:
        from .render.api import render_image
        img = render_image(scene, camera, cfg, seed=args.seed, accel=accel,
                           mode=args.mode, device=device)
    img = img.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    if world > 1:
        rank = torch.distributed.get_rank()
        torch.distributed.destroy_process_group()
        if rank != 0:
            return 0
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
    mode = "progressive wavefront" if args.checkpoint else args.mode
    ranks = f", {world} ranks" if world > 1 else ""
    from .render.graphed import LOOPS
    loops = (f"; loops: {LOOPS.captures} captures, {LOOPS.replays} "
             f"replays, {LOOPS.passes} passes, {LOOPS.syncs} flag reads"
             if LOOPS.passes else "")
    print(f"wrote {out} ({cfg.nx}x{cfg.ny} @ {cfg.spp}spp, {mode}, "
          f"{device.type}{ranks}) in {dt:.2f}s{loops}")
    return 0


def _cmd_bench(args):
    from .core import rng
    from .render.api import render_ray_batch
    from .utils.profiling import throughput, time_fn

    device = torch.device(args.device)
    scene, camera, cfg, accel = _build(args, device)
    key = rng.base_key(args.seed)
    n = min(cfg.num_rays, args.rays or cfg.num_rays)
    ids = torch.arange(n, dtype=torch.int64, device=device)
    secs = time_fn(render_ray_batch, scene, camera, cfg, key, ids, accel)
    _, segs = render_ray_batch(scene, camera, cfg, key, ids, accel,
                               return_stats=True)
    out = throughput(n, int(segs.sum()), secs)
    out.update(preset=args.preset, rays=n, device=str(device),
               accel=type(accel).__name__ if accel is not None else None)
    print(json.dumps(out))
    return 0


def _cmd_fit(args):
    from .bench import read_launches
    from .core import rng
    from .diff.grad import (GRAPHS, make_fit_step, make_fit_step_replay,
                            make_optimizer, ray_radiance, split_params)
    from .render.graphed import LOOPS

    device = torch.device(args.device)
    scene, camera, cfg, accel = _build(args, device)
    cfg = dataclasses.replace(cfg, max_depth=min(cfg.max_depth, 8),
                              differentiable=True)
    fields = tuple(f for f in args.fields.split(",") if f)
    key = rng.base_key(args.seed)
    ids = torch.arange(cfg.num_rays, dtype=torch.int64, device=device)

    true_params, _ = split_params(scene, fields=fields)
    with torch.no_grad():
        target = ray_radiance(true_params, scene, camera, cfg, key, ids,
                              accel)

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
    if args.fast:  # the recorder kernels find their own hits
        step = make_fit_step_replay(scene, camera, cfg, ids, target, opt,
                                    device=device)
    else:
        step = make_fit_step(scene, camera, cfg, ids, target, opt,
                             accel=accel, device=device)
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
                      "kernel_launches": read_launches(),
                      "graphs": {"captures": GRAPHS.captures,
                                 "replays": GRAPHS.replays},
                      "loops": {k: getattr(LOOPS, k) for k in (
                          "captures", "replays", "passes", "live_passes",
                          "syncs")}}))
    return 0


def _cmd_occupancy(args):
    from .utils.metrics import (megakernel_clustered_occupancy,
                                megakernel_occupancy, wavefront_occupancy)

    device = torch.device(args.device)
    scene, camera, cfg, accel = _build(args, device)
    out = wavefront_occupancy(scene, camera, cfg, seed=args.seed,
                              accel=accel, device=device)
    if scene.num_primitives <= (1 << 14):
        out["megakernel"] = megakernel_occupancy(scene, camera, cfg,
                                                 seed=args.seed,
                                                 device=device)
    out["megakernel_clustered"] = megakernel_clustered_occupancy(
        scene, camera, cfg, seed=args.seed, device=device)
    print(json.dumps(out, indent=2))
    return 0


def _cmd_compare(args):
    """Image difference statistics (PPM, PNG or npz); exit 1 above
    ``--max-frac-gt-4``."""
    from .render.image import image_diff_stats, read_image

    stats = image_diff_stats(read_image(args.a), read_image(args.b))
    print(json.dumps(stats))
    if args.max_frac_gt_4 is not None:
        return 0 if stats["frac_pixels_gt_4"] <= args.max_frac_gt_4 else 1
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
    sp.add_argument("--clustered", action="store_true",
                    help="closest hit by the clustered kernel K5 (large "
                         "scenes); with --mode mega: mega-clustered")
    sp.add_argument("--bvh", action="store_true",
                    help="closest hit by the flat-BVH walk (K6 on a GPU)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="first_raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("render", help="render a preset to PNG or PPM")
    sp.set_defaults(fn=_cmd_render)
    _common(sp)
    sp.add_argument("--out", default="",
                    help="output .png or .ppm; '-' streams PPM to stdout")
    sp.add_argument("--mode", default="mega",
                    choices=("mega", "mega-clustered", "wavefront",
                             "regenerative", "ring"),
                    help="mega: the megakernel (CUDA kernel on a GPU), "
                         "clustered past 1024 spheres or triangles; "
                         "mega-clustered: the clustered megakernel at any "
                         "size; wavefront: the chunked wavefront "
                         "integrator; regenerative: its compacted ray pool; "
                         "ring: the wavefront with the scene's primitives "
                         "split over every rank, passed around a ring")
    sp.add_argument("--checkpoint", default="",
                    help="render in resumable batches through the "
                         "wavefront integrator, checkpointed to this .npz")
    sp.add_argument("--batch-spp", type=int, default=1,
                    help="with --checkpoint: samples per pixel per batch")
    sp.add_argument("--preview", default="",
                    help="with --checkpoint: write a running-mean PNG "
                         "after every batch")
    bp = sub.add_parser("bench", help="time one ray batch; one JSON line")
    bp.set_defaults(fn=_cmd_bench)
    _common(bp)
    bp.add_argument("--rays", type=int, default=0,
                    help="rays in the batch (default: the whole image)")
    fp = sub.add_parser("fit", help="recover perturbed scene parameters by "
                                    "gradient descent")
    fp.set_defaults(fn=_cmd_fit)
    _common(fp)
    fp.add_argument("--fields", default="albedo",
                    help="comma-separated fields of diff.grad.DIFF_FIELDS; "
                         "with --fast on a GPU a field that moves geometry "
                         "changes the replay's plan, and so captures a new "
                         "CUDA graph, every step: such a step is about 1.5x "
                         "slower than an eager one")
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
    op = sub.add_parser("occupancy", help="occupancy report as JSON")
    op.set_defaults(fn=_cmd_occupancy)
    _common(op)
    cp = sub.add_parser("compare", help="image difference statistics "
                        "(ppm/png/npz); exit 1 above the threshold")
    cp.set_defaults(fn=_cmd_compare)
    cp.add_argument("a")
    cp.add_argument("b")
    cp.add_argument("--max-frac-gt-4", type=float, default=None,
                    help="fail (exit 1) if more than this fraction of "
                         "pixels differ by >4/255 in any channel")
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
