"""Threefry-2x32-20 draws keyed by (ray id, domain): the reference's copy.

Frozen copy of ``first_raytracer_tpu_torch/core/rng.py`` (``base_key``,
``_key_schedule``, ``_threefry2x32``, ``_bits_to_unit_float``,
``uniforms_plain``), so that a change to the port's stream cannot move the
reference with it.  A draw is a pure function of (seed, ray id, domain):
domain 0 is the camera (pixel jitter u, v and lens u1, u2), domain
``1 + d`` bounce ``d`` (ball u1, u2, u3 and the dielectric's coin).  Each
domain's four uniforms come from two Threefry calls with counters
``(id, 2 dom)`` and ``(id, 2 dom + 1)``; a uniform is a word's top 24 bits
times 2^-24.  The words ride in int64 tensors masked to 32 bits.
"""
from __future__ import annotations

import torch

ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
PARITY = 0x1BD11BDA
MASK = 0xFFFFFFFF


def key_words(seed: int):
    """The root key of a render seed: ``(0, seed mod 2^32)``, as the port's
    ``base_key`` makes it (and JAX's ``key_data(key(seed))``)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit in int32, got {seed}")
    return 0, seed & MASK


def _threefry2x32(k0: int, k1: int, c0, c1):
    """Threefry-2x32-20 of counters ``(c0, c1)`` (int64 tensors of uint32
    words) under the key ``(k0, k1)``."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for g in range(5):
        for j in range(4):
            r = ROTATIONS[(4 * g + j) % 8]
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK
    return x0, x1


def uniforms(seed: int, ray_ids: torch.Tensor, domain: int,
             dtype=torch.float64) -> torch.Tensor:
    """(R, 4) uniforms of ``ray_ids`` in RNG domain ``domain``.  The draws
    are exact multiples of 2^-24, so every float type of 24 or more
    significand bits holds them exactly; ``dtype`` rounds them otherwise."""
    k0, k1 = key_words(seed)
    ids = ray_ids.to(torch.int64) & MASK
    d2 = (2 * int(domain)) & MASK
    a0, a1 = _threefry2x32(k0, k1, ids, torch.full_like(ids, d2))
    b0, b1 = _threefry2x32(k0, k1, ids, torch.full_like(ids, (d2 + 1) & MASK))
    words = torch.stack([a0, a1, b0, b1], dim=-1)
    return ((words >> 8).to(torch.float64) * (1.0 / (1 << 24))).to(dtype)
