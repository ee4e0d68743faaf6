"""Vector math on ``(..., 3)`` tensors.

Port of ``first_raytracer_tpu.core.vecmath``: every helper works on tensors
whose trailing axis has length 3, so one ray and a million-ray batch share
the code.  Rays are ``(origin, direction)`` pairs.
"""
from __future__ import annotations

import torch

__all__ = [
    "dot",
    "cross",
    "length",
    "squared_length",
    "normalize",
    "point_at",
    "reflect",
    "refract",
    "schlick",
    "divide",
    "constant",
    "bound",
    "sqrt",
    "sin",
    "cos",
]


def dot(a, b):
    """Batched 3-vector dot product -> (...,)."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """Batched cross product on the trailing axis."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


_CONSTANTS = {}


def constant(value, dtype, device):
    """A constant tensor of ``value`` (a number or a tuple of numbers),
    made once per (value, dtype, device) and shared by every later call.
    Code that runs on every ray batch takes its constants here, so that it
    copies nothing from the host after its first call and a CUDA graph can
    capture it.  Callers must not write into the result."""
    key = (value, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def bound(x, device):
    """A distance bound (``t_min``, ``t_max``) as a tensor on ``device``: a
    tensor moved there, a Python number as a float32 ``constant``, so that
    a per-batch call makes no tensor from host data."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return constant(float(x), torch.float32, device)


def divide(x, n):
    """``x / n`` for a Python number ``n``, correctly rounded on every
    device.  On CUDA, torch divides by a Python number as a multiplication
    by its reciprocal, which can round one ulp away from the kernels' (and
    XLA's) division; a 0-d tensor on ``x``'s device keeps the division."""
    return x / constant(n, x.dtype, x.device)


def _rounded_once(fn, x):
    """``fn(x)``, for a float32 CPU tensor computed in float64 and rounded
    once.  torch's float32 sqrt, sin and cos on the CPU are vectorised
    approximations an ulp off on a fraction of inputs, where the kernels'
    sqrtf, sinf and cosf (CUDA's, and the host build's) are (nearly)
    correctly rounded; on the card torch's float32 ops round as the
    kernels do."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return fn(x.double()).float()
    return fn(x)


def sqrt(x):
    return _rounded_once(torch.sqrt, x)


def sin(x):
    return _rounded_once(torch.sin, x)


def cos(x):
    return _rounded_once(torch.cos, x)


def squared_length(v):
    return torch.sum(v * v, dim=-1)


def length(v):
    return torch.sqrt(squared_length(v))


def normalize(v, eps: float = 0.0):
    """Unit vector; zero where ``|v| == 0``.

    ``eps`` floors the squared length for padded or dead lanes.
    """
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    if eps:
        n2 = torch.clamp(n2, min=eps)
    pos = n2 > 0
    inv = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)
    return v * inv


def point_at(origin, direction, t):
    """``A + t*B``."""
    return origin + t[..., None] * direction


def reflect(v, n):
    """``v - 2*dot(v,n)*n``."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, ni_over_nt):
    """Snell refraction with a total-internal-reflection mask.

    Returns ``(refracted, ok)``; ``refracted`` is zero where ``ok`` is
    False.
    """
    uv = normalize(v)
    dt = dot(uv, n)
    discriminant = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = discriminant > 0
    safe_disc = torch.where(ok, discriminant, 0.0)
    refracted = (ni_over_nt[..., None] * (uv - n * dt[..., None])
                 - n * torch.sqrt(safe_disc)[..., None])
    return torch.where(ok[..., None], refracted, 0.0), ok


def schlick(cosine, ref_idx):
    """Schlick's reflectance ``r0 + (1-r0)(1-cos)^5``."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    return r0 + (1.0 - r0) * one_minus ** 5
