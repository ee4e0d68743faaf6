"""Counter-based stateless RNG: Threefry-2x32-20 keyed by (ray id, domain).

Port of ``first_raytracer_tpu.core.rng``.  Every random draw of a render is
a pure function of ``(seed, ray_id, domain)``, so the stream needs no
``torch.Generator`` and gives the same bits as the JAX package: the
arithmetic is plain 32-bit integer work.  CPU PyTorch has no ``uint32``
add, so the words ride in ``int64`` tensors masked with ``0xFFFFFFFF``
after every add and shift.

Draw layout per ray (one ray = one (pixel, sample) pair):

- domain 0 (``DOMAIN_CAMERA``): pixel jitter (u, v) + lens disk (u1, u2);
- domain ``1 + d`` for bounce ``d``: unit-ball sample (u1, u2, u3) +
  dielectric reflect/refract coin.

Each domain's 4 uniforms come from two Threefry calls with counters
``(id, 2 * dom)`` and ``(id, 2 * dom + 1)``; a uniform is the top 24 bits
of a word scaled by 2^-24.

``uniforms`` dispatches by the ids' device.  On a CUDA device it launches
K7 (``kernels/csrc/rng_rays.cu``): one thread draws one ray's four
uniforms and writes them as one 16-byte row, the key read from its device
tensor, so a draw is one node of a CUDA graph where the plain version is
~350.  On the CPU it runs
``uniforms_plain``, the Threefry of int64 torch ops; K7 is bit-equal to it.
A failed build or launch raises; nothing falls back.
"""
from __future__ import annotations

import math

import torch

from . import vecmath

__all__ = [
    "base_key",
    "key_words",
    "device_key",
    "uniforms",
    "uniforms_plain",
    "camera_uniforms",
    "bounce_uniforms",
    "unit_disk_sample",
    "unit_ball_sample",
    "precompute_uniforms",
]

DOMAIN_CAMERA = 0

# Threefry-2x32-20 rotation schedule (public Random123 constants).
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def base_key(seed: int) -> torch.Tensor:
    """Root key of a render: ``[0, seed mod 2^32]`` as a (2,) int64 tensor.

    This is what ``jax.random.key_data(jax.random.key(seed))`` gives for a
    32-bit seed, so a seed keys the same stream in both packages.  The key
    always lives on the CPU: it is two integers the kernels take by value.
    """
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def key_words(key):
    """The key's two uint32 words as Python ints (the kernels take them by
    value)."""
    k0, k1 = (int(k) for k in torch.as_tensor(key).reshape(2).tolist())
    return k0 & _MASK, k1 & _MASK


def device_key(key, device):
    """The key as a contiguous (2,) int64 tensor on ``device`` (the key
    itself where it already is one)."""
    return torch.as_tensor(key, dtype=torch.int64,
                           device=device).reshape(2).contiguous()


def _key_schedule(key, device):
    """Threefry's key injections, from the key as data on ``device``: the
    words ``ks = (k0, k1, k0 ^ k1 ^ PARITY)`` and, for each of the five
    rounds ``g``, ``(ks[(g + 1) % 3], ks[(g + 2) % 3] + g + 1)``, all 0-d
    int64 tensors.  Nothing is read back to the host, so a CUDA graph that
    captures a draw reads the key from its buffer on every replay."""
    k = device_key(key, device) & _MASK
    ks = (k[0], k[1], k[0] ^ k[1] ^ PARITY)
    return ks, [(ks[(g + 1) % 3], ks[(g + 2) % 3] + (g + 1))
                for g in range(5)]


def _threefry2x32(schedule, c0, c1):
    """Threefry-2x32-20 on int64 tensors (or Python ints) holding uint32
    words, keyed by ``_key_schedule``."""
    ks, inject = schedule
    x0 = (c0 + ks[0]) & _MASK
    x1 = (c1 + ks[1]) & _MASK
    for g in range(5):
        for j in range(4):
            r = ROTATIONS[(4 * g + j) % 8]
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + inject[g][0]) & _MASK
        x1 = (x1 + inject[g][1]) & _MASK
    return x0, x1


def _bits_to_unit_float(bits):
    """uint32 word -> f32 in [0, 1) from its top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


REPLACES = "first_raytracer_tpu/core/rng.py:97"


def uniforms_plain(key, ray_ids, domain):
    """K7's plain version: (..., 4) f32 uniforms for ray ids and a domain
    (a Python int, or an integer tensor that broadcasts against the ids).
    The key (a (2,) tensor) is read as data on the ids' device; an integer
    domain is a scalar operand, so no tensor is made from host data."""
    ids = ray_ids.to(torch.int64) & _MASK
    schedule = _key_schedule(key, ids.device)
    if isinstance(domain, torch.Tensor):
        domain = domain.to(torch.int64)
    d2 = (domain * 2) & _MASK
    a0, a1 = _threefry2x32(schedule, ids, d2)
    b0, b1 = _threefry2x32(schedule, ids, (d2 + 1) & _MASK)
    return torch.stack([_bits_to_unit_float(w) for w in (a0, a1, b0, b1)],
                       dim=-1)


def _launch_cuda(key, ids, domain, offset):
    """K7 over the ids (a CUDA tensor) in domain ``domain + offset``: the
    (..., 4) f32 uniforms.  Makes no host read and allocates through torch,
    so a CUDA graph can capture it."""
    from ..kernels import megakernel

    dev = ids.device
    k = device_key(key, dev)
    dom, stride = None, 0
    if isinstance(domain, torch.Tensor):
        dom = domain.to(device=dev, dtype=torch.int64)
        if dom.dim():
            shape = torch.broadcast_shapes(ids.shape, dom.shape)
            ids, dom, stride = ids.expand(shape), dom.expand(shape), 1
        dom = dom.contiguous()
    else:
        offset += int(domain)
    ids = ids.to(torch.int64).contiguous()
    out = torch.empty(ids.shape + (4,), dtype=torch.float32, device=dev)
    if out.data_ptr() % 16:
        raise RuntimeError("K7 writes a row as one 16-byte store; its output "
                           f"at {out.data_ptr():#x} is not 16-byte aligned")
    n = ids.numel()
    megakernel.launch_entry(
        dev, "frt_uniforms", k.data_ptr(), ids.data_ptr(),
        None if dom is None else dom.data_ptr(), stride, offset, n,
        out.data_ptr())
    if n:
        uniforms.launches += 1
    return out


def uniforms(key, ray_ids, domain, offset: int = 0):
    """(..., 4) f32 uniforms of ray ids in RNG domain ``domain + offset``
    (``domain`` a Python int, or an integer tensor that broadcasts against
    the ids: 0-d, or one per ray).  Launches K7 for CUDA ids and runs
    ``uniforms_plain`` for CPU ids; bit-equal either way."""
    ids = torch.as_tensor(ray_ids)
    if ids.device.type == "cpu":
        return uniforms_plain(key, ids,
                              domain + offset if offset else domain)
    if ids.device.type != "cuda":
        raise ValueError(f"no Threefry kernel for device {ids.device}")
    return _launch_cuda(key, ids, domain, offset)


uniforms.launches = 0  # K7 launches (CUDA path only)


def camera_uniforms(key, ray_ids):
    """(R, 4) uniforms for AA jitter and lens sampling."""
    return uniforms(key, ray_ids, DOMAIN_CAMERA)


def bounce_uniforms(key, ray_ids, depth):
    """(R, 4) uniforms for bounce ``depth`` (0-based; scalar or per-ray)."""
    if not isinstance(depth, torch.Tensor):
        depth = int(depth)
    return uniforms(key, ray_ids, depth, offset=1)


def unit_disk_sample(u1, u2):
    """Uniform point in the unit disk from two uniforms; (..., 2)."""
    r = vecmath.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return torch.stack([r * vecmath.cos(theta), r * vecmath.sin(theta)],
                       dim=-1)


def unit_ball_sample(u1, u2, u3):
    """Uniform point in the unit ball from three uniforms; (..., 3).

    Uniform direction times a cube-root radius: the bounded replacement of
    the reference's rejection loop, as in the JAX package.
    """
    z = 1.0 - 2.0 * u1
    r = vecmath.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u2
    # torch has no cbrt: the f64 power rounded to f32 is the cube root to
    # within an ulp, like ``jnp.cbrt`` and CUDA's ``cbrtf``.
    radius = torch.pow(u3.to(torch.float64), 1.0 / 3.0).to(u3.dtype)
    return radius[..., None] * torch.stack(
        [r * vecmath.cos(phi), r * vecmath.sin(phi), z], dim=-1)


def precompute_uniforms(key, ray_ids, max_depth: int):
    """All uniforms a set of rays can consume: (R, max_depth + 2, 4).

    Slot 0 is the camera domain, slot ``1 + d`` is bounce ``d``.
    """
    ids = torch.as_tensor(ray_ids)
    domains = torch.arange(max_depth + 2, device=ids.device)
    return uniforms(key, ids[:, None], domains[None, :])
