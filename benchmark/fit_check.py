"""What decides ``correct`` in the fit cells: the first three steps against
the reference's.

Set-up drives the fit through its first three steps by the window's own
call, on the fit's one key and target as every step of ``cli fit`` is,
and records the loss of each and the albedo before the first step, after
it and after the third.  Once the window has closed the reference traces
the same rays' paths with the same draws and follows the three steps:
the loss (the mean of squared errors against its own target, rendered
from the unperturbed albedo along its own paths), its gradient by autograd
and the SGD update.  The numbers compared, one leaf (``albedo``) so its
worst leaf is itself:

- ``loss_gap``: the largest ``|loss - loss_ref| / loss_ref`` of the steps;
- ``grad_gap``: ``| |g| - |g_ref| | / |g_ref|`` of the first gradient, the
  program's worked out from its state after one step, ``(p0 - p1) / lr``;
- ``change_gap``: ``| |p3 - p0| - |q3 - q0| | / |q3 - q0|``, the change
  after the three steps, as the fourth step would take them.

With albedo the only field, a path's radiance is its sky times the product
of the albedos it hit (the geometry of a path does not depend on albedo),
so the reference records each path's materials once and differentiates
that product at each step.
"""
from __future__ import annotations

import sys
import time

import torch

from .reference.tracer import path_radiance

STEPS = 3


def _loss_and_grad(albedo, albedo_true, paths, lo, hi, chunk=1 << 20):
    """Mean squared error over rays ``[lo, hi)`` and its gradient in
    ``albedo``.  A path's radiance is ``sky * prod_k albedo[m_k]``, so the
    gradient of an entry ``(ray, k)`` is the ray's error times ``sky``
    times the product of the path's other albedos (prefix and suffix
    products); ``torch.bincount`` sums the entries by material.  The test
    holds it to autograd's."""
    m = albedo.shape[0]
    grad = torch.zeros((m, 3), dtype=torch.float64, device=albedo.device)
    total = torch.zeros((), dtype=albedo.dtype, device=albedo.device)
    ones = torch.ones((1, 3), dtype=albedo.dtype, device=albedo.device)
    table = torch.cat([albedo, ones])
    for a in range(lo, hi, chunk):
        b = min(hi, a + chunk)
        mats, sky = paths["mats"][a:b], paths["sky"][a:b]
        fac = table[mats]                                  # (R, D, 3)
        err = path_radiance(albedo, mats, sky) - path_radiance(
            albedo_true, mats, sky)
        total += (err * err).sum()
        pre = torch.cumprod(torch.cat([ones.expand(fac.shape[0], 1, 3),
                                       fac[:, :-1]], 1), 1)
        suf = torch.cumprod(torch.cat([fac[:, 1:], ones.expand(
            fac.shape[0], 1, 3)], 1).flip(1), 1).flip(1)
        w = (2 * err * sky)[:, None, :] * pre * suf        # (R, D, 3)
        used = mats >= 0
        idx = mats[used]
        for c in range(3):
            grad[:, c] += torch.bincount(idx, weights=w[..., c][used].double(),
                                         minlength=m)
    n = 3 * (hi - lo)
    return total / n, (grad / n).to(albedo.dtype)


def follow(ref, key_seed, num_rays, max_depth, p0, lr, half=False):
    """The reference's first ``STEPS`` steps from albedo ``p0`` on the
    rays of key ``key_seed``: losses, the first gradient's norm and the
    change's norm.  ``half`` leaves out the second half of the rays (a
    planted fault)."""
    ids = torch.arange(num_rays, device=ref.device)
    hi = num_rays // 2 if half else num_rays
    albedo = torch.as_tensor(p0).to(device=ref.device, dtype=ref.dtype)
    start, losses, g0 = albedo.clone(), [], None
    t0 = time.perf_counter()
    paths = ref.trace(key_seed, ids[:hi], max_depth, record_mats=True)
    print(f"reference paths: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    for k in range(STEPS):
        t1 = time.perf_counter()
        loss, grad = _loss_and_grad(albedo, ref.albedo, paths, 0, hi)
        print(f"reference step {k}: loss and gradient "
              f"{time.perf_counter() - t1:.2f} s", file=sys.stderr)
        losses.append(float(loss))
        g0 = grad if g0 is None else g0
        albedo = albedo - lr * grad
    del paths
    return dict(losses=losses, grad_norm=float(g0.double().norm()),
                change_norm=float((albedo - start).double().norm()))


def gaps(got, want):
    """The compared numbers of ``got`` (the program's, or a variant's)
    against ``want`` (the reference's)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"]))
    return {"loss_gap": loss,
            "grad_gap": abs(got["grad_norm"] - want["grad_norm"])
            / want["grad_norm"],
            "change_gap": abs(got["change_norm"] - want["change_norm"])
            / want["change_norm"]}
