"""How torch rounds the few ops of the flat-BVH walk's, the camera
rays' and the wavefront pass's plain versions.

The plain walk (``accel/traverse.py::intersect_bvh_plain``) takes its dot
products from ``torch.sum`` over a (R, 3) tensor and its cross products
from ``torch.linalg.cross``; ``render/camera.py::generate_rays`` normalizes
through the same sum, in float32 or, for a float64 camera, in float64.  The
order of that sum and whether the cross product contracts into a fused
multiply-add are choices of torch's own kernels, and K6
(``kernels/csrc/bvh_walk.cu``) and K8 (``kernels/csrc/rng_rays.cu``) must
make the same ones to be bit-equal to their plain versions.  For 2^20
random rows this prints, per device, how many results differ from each
candidate form: the form with 0 is the one torch uses.  The fused forms are
computed in float64 and rounded once more (a double rounding, wrong on
about 2^-29 of inputs).  It also counts torch's float32 and float64 square
roots that differ from the correctly rounded ones (numpy's).

For the wavefront pass (K9 and K10, ``kernels/csrc/wavefront_pass.cu``)
it also counts: ``torch.prod`` over a row of three (the checker texture's
sines) against its three orders; ``x ** 5`` (Schlick's term) against the
float64 power rounded once and against the chain of four products;
``torch.pow`` of a float64 tensor by 1/3 rounded to float32 (the ball
sample's radius) against the float64 power of the C library (numpy's)
rounded once; and the two true divisions (``a / b`` of two tensors,
``1.0 / x``) against the float64 quotient rounded once; and
``index_add_`` of subnormal values into zeros, against the values (the
card's atomic add flushes them to zero).

For the dense closest hit (K11, ``kernels/csrc/dense_hit.cu``) it counts
the same sum and cross product on the broadcast (R, N, 3) shapes of
``geometry/sphere.py::sphere_hit_all`` and ``triangle.py::
triangle_hit_all`` (rays (R, 1, 3) against primitives (1, N, 3)).

    python probes/torch_arith.py            # the CPU, and the card if any
"""
import json
import sys

import numpy as np
import torch


def forms(dev):
    g = torch.Generator().manual_seed(0)
    n = 1 << 20
    scale = torch.tensor([1e3, 1.0, 1e-3])
    a = torch.randn(n, 3, generator=g) * scale[torch.randperm(3,
                                                             generator=g)]
    b = torch.randn(n, 3, generator=g)
    x = (a * b).to(dev)
    s = torch.sum(x, dim=-1).cpu()
    x = x.cpu()
    out = {"sum (x+y)+z": int((s != (x[:, 0] + x[:, 1]) + x[:, 2]).sum()),
           "sum (x+z)+y": int((s != (x[:, 0] + x[:, 2]) + x[:, 1]).sum()),
           "sum x+(y+z)": int((s != x[:, 0] + (x[:, 1] + x[:, 2])).sum())}
    xd = a.double() * b.double() * torch.rand(n, 3, generator=g).double()
    sd = torch.sum(xd.to(dev), dim=-1, keepdim=True).cpu()[:, 0]
    out.update({
        "float64 sum (x+y)+z": int((sd != (xd[:, 0] + xd[:, 1])
                                    + xd[:, 2]).sum()),
        "float64 sum (x+z)+y": int((sd != (xd[:, 0] + xd[:, 2])
                                    + xd[:, 1]).sum()),
        "float64 sum x+(y+z)": int((sd != xd[:, 0] + (xd[:, 1]
                                                      + xd[:, 2])).sum())})
    p, q = torch.randn(n, 3, generator=g), torch.randn(n, 3, generator=g)
    c = torch.linalg.cross(p.to(dev), q.to(dev), dim=-1).cpu()
    pd, qd = p.double(), q.double()
    for k, (i, j) in enumerate(((1, 2), (2, 0), (0, 1))):
        plain = p[:, i] * q[:, j] - p[:, j] * q[:, i]
        first = pd[:, i] * qd[:, j] - (p[:, j] * q[:, i]).double()
        second = (p[:, i] * q[:, j]).double() - pd[:, j] * qd[:, i]
        fma_first, fma_second = first.float(), second.float()
        out[f"cross[{k}] a*b-c*d"] = int((c[:, k] != plain).sum())
        out[f"cross[{k}] fma(a,b,-(c*d))"] = int((c[:, k] != fma_first).sum())
        out[f"cross[{k}] fma(-c,d,a*b)"] = int((c[:, k] != fma_second).sum())
    r = torch.randn(n, generator=g)
    out["reciprocal vs 1/x in float64"] = int(
        (torch.reciprocal(r.to(dev)).cpu()
         != (1.0 / r.double()).float()).sum())
    r = torch.rand(n, generator=g) * 100
    out["sqrt vs float64 root"] = int(
        (torch.sqrt(r.to(dev)).cpu() != torch.sqrt(r.double()).float()).sum())
    for dtype in (torch.float32, torch.float64):
        r = (torch.rand(n, generator=g, dtype=torch.float64) * 100).to(dtype)
        out[f"{dtype} sqrt vs numpy's (correctly rounded)"] = int(
            (torch.sqrt(r.to(dev)).cpu().numpy() != np.sqrt(r.numpy())).sum())
    x = (torch.rand(n, 3, generator=g) * 2 - 1) * 3
    pr = torch.prod(x.to(dev), dim=-1).cpu()
    out.update({
        "prod (x*y)*z": int((pr != (x[:, 0] * x[:, 1]) * x[:, 2]).sum()),
        "prod (x*z)*y": int((pr != (x[:, 0] * x[:, 2]) * x[:, 1]).sum()),
        "prod x*(y*z)": int((pr != x[:, 0] * (x[:, 1] * x[:, 2])).sum())})
    om = torch.rand(n, generator=g) * 2.5 - 0.5
    p5 = (om.to(dev) ** 5).cpu()
    chain = om * om * om * om * om
    out.update({
        "x ** 5 vs float64 power rounded once": int(
            (p5 != (om.double() ** 5).float()).sum()),
        "x ** 5 vs x*x*x*x*x": int((p5 != chain).sum())})
    u = (torch.randint(0, 1 << 24, (n,), generator=g).float()
         * (1.0 / (1 << 24)))
    cb = torch.pow(u.double().to(dev), 1.0 / 3.0).float().cpu()
    out["pow(float64, 1/3) to float32 vs libm's pow rounded once"] = int(
        (cb.numpy() != np.power(u.double().numpy(), 1.0 / 3.0).astype(
            np.float32)).sum())
    a, b = torch.randn(n, generator=g), torch.rand(n, generator=g) + 0.5
    out["a / b vs float64 quotient rounded once"] = int(
        ((a.to(dev) / b.to(dev)).cpu()
         != (a.double() / b.double()).float()).sum())
    out["1.0 / x vs float64 quotient rounded once"] = int(
        ((1.0 / b.to(dev)).cpu() != (1.0 / b.double()).float()).sum())
    tiny = torch.rand(n, generator=g) * 1e-38  # subnormal below 1.18e-38
    added = torch.zeros(n, device=dev).index_add_(
        0, torch.arange(n, device=dev), tiny.to(dev)).cpu()
    out["index_add_ of subnormals into zeros vs the values"] = int(
        (added != tiny).sum())
    out.update(broadcast_forms(dev, g))
    return out


def broadcast_forms(dev, g):
    """The sum and cross product on the dense sweep's broadcast shapes."""
    R, N = 1 << 12, 300
    o = torch.randn(R, 1, 3, generator=g) * 5
    d = torch.nn.functional.normalize(torch.randn(R, 1, 3, generator=g),
                                      dim=-1)
    c = torch.randn(1, N, 3, generator=g) * 5
    oc = o.to(dev) - c.to(dev)
    s = torch.sum(oc * d.to(dev), dim=-1).cpu()
    x = (oc * d.to(dev)).cpu()
    out = {"(R, N, 3) sum (x+y)+z": int((s != (x[..., 0] + x[..., 1])
                                         + x[..., 2]).sum()),
           "(R, N, 3) sum (x+z)+y": int((s != (x[..., 0] + x[..., 2])
                                         + x[..., 1]).sum())}
    e = torch.randn(1, N, 3, generator=g)
    cr = torch.linalg.cross(d.to(dev), e.to(dev), dim=-1).cpu()
    dd, ed = d.double(), e.double()
    first = torch.stack([
        (dd[..., i] * ed[..., j] - (d[..., j] * e[..., i]).double()).float()
        for i, j in ((1, 2), (2, 0), (0, 1))], dim=-1)
    out["(R, N, 3) cross fma(a,b,-(c*d))"] = int((cr != first).sum())
    return out


def main():
    devs = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}))
    for dev in devs:
        print(json.dumps({"device": dev, **forms(dev)}))


if __name__ == "__main__":
    main()
