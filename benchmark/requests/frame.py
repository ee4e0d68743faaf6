"""A request is one whole frame through the entry point that the mix's
``entry`` names, a function of the port's package: ``render_image_mega``
(``cli render --mode mega``: the scene's dense pack on the host, then K1)
or ``render_image_mega_clustered`` (``--mode mega-clustered``: the host's
SAH pack, then K3), over every pixel and sample, the image divided by spp
and flipped.  The request ends when the image is on the device (a
synchronize).  Frame ``i`` takes render seed ``seeds.render_seed(render
stream, i)``."""
from __future__ import annotations

import importlib

from .. import program, render_check, seeds


def entry(name):
    """The port's function ``<module path>.<function>`` (under the port's
    package)."""
    module, fn = name.rsplit(".", 1)
    return getattr(importlib.import_module("first_raytracer_tpu_torch."
                                           + module), fn)


class Session:
    first_request = 0

    def __init__(self, ctx):
        self.ctx, self.render = ctx, entry(ctx.traffic["entry"])
        img = ctx.image
        self.cfg = program.render_config(img)
        self.scene = program.scene(ctx.scene_arrays, ctx.device)
        self.camera = program.camera(ctx.config["camera"], img, ctx.device)
        self.paths_per_request = img["nx"] * img["ny"] * img["spp"]
        self.kept = render_check.Reservoir(ctx.limits["check"]["requests"],
                                           ctx.streams["check"])
        # Warm-up: the library's build or load, the kernel's first launch.
        for i in (-2, -1):
            self._frame(i)
        program.synchronize(ctx.device)

    def _frame(self, i):
        seed = seeds.render_seed(self.ctx.streams["render"], i)
        return seed, self.render(
            self.scene, self.camera, self.cfg, seed=seed,
            device=self.ctx.device)

    def request(self, i):
        spans = self.ctx.spans
        with spans("request"):
            seed, img = self._frame(i)
            with spans("synchronize"):
                program.synchronize(self.ctx.device)
        self.kept.offer((seed, img))

    def release(self):
        self.scene = self.camera = None

    def items(self):
        def rows(img):
            flat = img.flip(0).reshape(-1, 3)  # bottom row first
            return lambda pixels: flat[pixels]

        return [(seed, rows(img)) for seed, img in self.kept.items]

    def check(self, ref=None):
        return render_check.image_numbers(self.ctx, self.items(), ref)
