"""How torch rounds the few ops of the flat-BVH walk's and the camera
rays' plain versions.

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
    return out


def main():
    devs = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0]}))
    for dev in devs:
        print(json.dumps({"device": dev, **forms(dev)}))


if __name__ == "__main__":
    main()
