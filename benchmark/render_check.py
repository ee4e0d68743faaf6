"""What decides ``correct`` in the render cells: the timed requests'
images against the reference's, pixel by pixel.

A request's image is a set of answers that can be checked one by one: the
run keeps a sample of its requests, drawn from the seed as they complete
(a reservoir, so every request of the window is as likely to be kept), and
once the window has closed the reference traces a sample of their pixels,
drawn from the seed, with the same draws.  The number compared is
``image_rel_l1``: the sum over the sampled pixels and channels of
``|program - reference|`` over the sum of ``|reference|``, the largest over
the kept requests.  Float rounding moves a few paths onto another branch
(a near tie, a grazing hit, a coin at its threshold), so the images are not
equal; a stale image, half the samples or an image written one pixel off
differ by the Monte Carlo noise of whole paths.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from .reference.tracer import Reference


class Reservoir:
    """``k`` requests kept uniformly from those offered, by the seed."""

    def __init__(self, k: int, word: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(word), 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def sample_pixels(word: int, k: int, count: int, total: int, device):
    """``count`` distinct pixels of ``total`` for the ``k``-th kept
    request, drawn from the check's stream."""
    rng = np.random.RandomState((word + 7919 * k) % (1 << 32))
    pix = rng.choice(total, size=min(count, total), replace=False)
    return torch.from_numpy(np.sort(pix)).to(device)


def reference(ctx, dtype=torch.float64):
    return Reference(ctx.scene_arrays, ctx.config["camera"], ctx.image,
                     ctx.device, dtype)


def image_numbers(ctx, items, ref=None, variant=None):
    """``({"image_rel_l1": x}, {"segments_per_path": s})`` of kept requests
    ``items``, each ``(render seed, rows)``: ``rows(pixels)`` gives the
    program's (n, 3) mean radiance at those pixels (bottom row first).
    ``variant(ref, seed, pixels)``, where given, is put in the program's
    place (the control, or a planted fault)."""
    ref = ref or reference(ctx)
    img, chk = ctx.image, ctx.limits["check"]
    total = img["nx"] * img["ny"]
    rels, segs, paths = [], 0, 0
    for k, (seed, rows) in enumerate(items):
        pixels = sample_pixels(ctx.streams["check"], k, chk["pixels"], total,
                               ctx.device)
        want, s = ref.pixel_means(seed, pixels, img["max_depth"])
        got = (rows(pixels) if variant is None
               else variant(ref, seed, pixels)).double()
        want = want.double()
        rels.append(float((got - want).abs().sum() / want.abs().sum()))
        segs, paths = segs + s, paths + pixels.numel() * img["spp"]
    worst = (float("nan") if any(r != r for r in rels) else max(rels))
    return {"image_rel_l1": worst}, {"segments_per_path": segs / paths}


def faults(ctx):
    """The render faults, put in the program's place as variants of the
    reference: a stale image (another request's draws), half the samples
    (the mean over the first half), an image one pixel off."""
    spp = ctx.image["spp"]
    total = ctx.image["nx"] * ctx.image["ny"]
    half = max(1, spp // 2)

    def stale(ref, seed, pixels):
        return ref.pixel_means((seed + 1) & 0x7FFFFFFF, pixels,
                               ctx.image["max_depth"])[0]

    def half_samples(ref, seed, pixels):
        s = torch.arange(half, device=pixels.device)
        ids = (pixels[:, None] * spp + s).reshape(-1)
        out = ref.trace(seed, ids, ctx.image["max_depth"])["radiance"]
        return out.reshape(-1, half, 3).mean(1)

    def pixel_off(ref, seed, pixels):
        return ref.pixel_means(seed, (pixels + 1) % total,
                               ctx.image["max_depth"])[0]

    return {"stale_image": stale, "half_samples": half_samples,
            "pixel_off": pixel_off}
