"""A request is one step of the direct inverse-rendering fit that
``cli fit`` runs (``diff/grad.py::make_fit_step``): the tape recorder over
every ray id (every pixel times spp), the replay's value and gradient, and
the optimizer's update; it ends when the step's loss is read on the host,
as ``cli fit`` reads it.

Set-up, as ``cli fit`` does (``cli.py::_cmd_fit``): the scene on the
device, its accel (the mix's ``accel``: ``"clustered"``, as ``cli fit
--clustered``, is ``pack_scene_clustered`` and K5's closest hit; ``"none"``
is K11's dense sweep), one key, the target rendered with it from the
unperturbed scene, the fitted field's perturbation (a factor in
``perturb`` for each value, clipped below at ``clip_min``, from the seed's
``perturb`` stream), the optimizer and one step object.  Every step takes
that key and that target, as ``cli fit``'s do.  Set-up then runs the first
three steps through the window's own call, which warms and captures every
graph, and records what the check compares (``fit_check.py``); the window
continues from step 3.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import fit_check, program, seeds


class Session:
    first_request = fit_check.STEPS

    def __init__(self, ctx):
        from first_raytracer_tpu_torch.core import rng
        from first_raytracer_tpu_torch.diff import grad

        self.ctx = ctx
        tr, img, dev = ctx.traffic, ctx.image, ctx.device
        self.field, self.lr = tr["field"], float(tr["lr"])
        self.cfg = program.render_config(img, max_depth=tr["max_depth"],
                                         differentiable=True)
        scene = program.scene(ctx.scene_arrays, dev)
        camera = program.camera(ctx.config["camera"], img, dev)
        accel = None
        if tr["accel"] == "clustered":
            from first_raytracer_tpu_torch.kernels.intersect_clustered import (
                pack_scene_clustered)
            with ctx.spans("pack"):
                accel = pack_scene_clustered(scene)
        self.num_rays = self.cfg.num_rays
        self.paths_per_request = self.num_rays
        ids = torch.arange(self.num_rays, dtype=torch.int64, device=dev)
        self.key_seed = seeds.render_seed(ctx.streams["render"], 0)
        self.key = rng.base_key(self.key_seed)
        true = {self.field: getattr(scene, self.field).detach().clone()}
        with torch.no_grad():
            target = grad.ray_radiance(true, scene, camera, self.cfg,
                                       self.key, ids, accel)
        p = getattr(scene, self.field).cpu().numpy()
        lo, hi = tr["perturb"]
        r = np.random.RandomState(ctx.streams["perturb"])
        self.p0 = np.clip(p * (lo + (hi - lo) * r.rand(*p.shape)),
                          tr["clip_min"], None).astype(np.float32)
        self.params = {self.field: torch.tensor(
            self.p0, device=dev, requires_grad=True)}
        opt = grad.make_optimizer(tr["optimizer"], self.params, self.lr)
        self.step = grad.make_fit_step(scene, camera, self.cfg, ids, target,
                                       opt, accel=accel, device=dev)
        self.losses, snaps = [], []
        for i in range(fit_check.STEPS):
            self.losses.append(self.request(i))
            snaps.append(self.params[self.field].detach().cpu().numpy()
                         .copy())
        self.p1, self.p3 = snaps[0], snaps[-1]

    def request(self, i):
        spans = self.ctx.spans
        with spans("request"):
            loss = self.step(self.params, self.key)
            with spans("loss_read"):
                return float(loss)

    def release(self):
        self.step = self.params = None

    def program_numbers(self):
        return dict(losses=self.losses,
                    grad_norm=float(np.linalg.norm(
                        (self.p0.astype(np.float64) - self.p1) / self.lr)),
                    change_norm=float(np.linalg.norm(
                        self.p3.astype(np.float64) - self.p0)))

    def reference_numbers(self, ref, half=False):
        return fit_check.follow(ref, self.key_seed, self.num_rays,
                                self.cfg.max_depth, self.p0, self.lr, half)

    def check(self, ref=None):
        from ..render_check import reference

        ref = ref or reference(self.ctx)
        return fit_check.gaps(self.program_numbers(),
                              self.reference_numbers(ref)), {}
