"""The port's counter-based RNG against the JAX package's.

Uniforms are plain 32-bit integer work, so they must be bit-equal; the disk
and ball samples go through sin/cos/sqrt/cbrt and are held to 1e-6 abs.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu_torch.core import rng as trng

SEEDS = (0, 7, 123456)
MAX_ID = 9_600_000  # the final scene's ray count (1200 x 800 x 10)


def _ids():
    r = np.random.RandomState(0)
    return np.concatenate([
        np.arange(64), r.randint(0, MAX_ID, 192),
        [MAX_ID - 1, MAX_ID, (1 << 24) + 1, (1 << 31) - 1]]).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + (-1, (1 << 31) - 1))
def test_base_key_matches(seed):
    np.testing.assert_array_equal(trng.base_key(seed).numpy(),
                                  np.asarray(jrng.base_key(seed), np.int64))


def test_base_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        trng.base_key(1 << 32)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bit_equal_all_domains(seed):
    """Every domain a depth-50 render draws from: 0 (camera) .. 51."""
    ids = _ids()
    want = np.asarray(jrng.precompute_uniforms(
        jrng.base_key(seed), jnp.asarray(ids.astype(np.int32)), 50))
    got = trng.precompute_uniforms(trng.base_key(seed),
                                   torch.from_numpy(ids), 50).numpy()
    assert got.shape == (len(ids), 52, 4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# Base keys by seed, and raw key words with the top bits set: the key is
# read as data (0-d int64 tensors), masked to 32 bits.
KEYS = SEEDS + (-1, pytest.param((0x9E3779B9, 0xDEADBEEF), id="raw"),
                pytest.param((0xFFFFFFFF, 0xFFFFFFFF), id="ones"))


def _keys(seed):
    """(JAX key, port key) of a seed or of two raw key words."""
    if isinstance(seed, int):
        return jrng.base_key(seed), trng.base_key(seed)
    return (jnp.asarray(np.array(seed, np.uint32)),
            torch.tensor(seed, dtype=torch.int64))


@pytest.mark.parametrize("seed", KEYS)
def test_camera_and_bounce_uniforms_bit_equal(seed):
    ids = _ids()
    jk, tk = _keys(seed)
    jids, tids = jnp.asarray(ids.astype(np.int32)), torch.from_numpy(ids)
    np.testing.assert_array_equal(
        trng.camera_uniforms(tk, tids).numpy(),
        np.asarray(jrng.camera_uniforms(jk, jids)))
    for depth in (0, 3, 49, 50):
        np.testing.assert_array_equal(
            trng.bounce_uniforms(tk, tids, depth).numpy(),
            np.asarray(jrng.bounce_uniforms(jk, jids, depth)))


@pytest.mark.parametrize("seed", KEYS)
def test_per_ray_depth_bounce_uniforms_bit_equal(seed):
    """A depth per ray (the replay's buckets) against JAX's
    ``bounce_uniforms_var``."""
    ids = _ids()
    jk, tk = _keys(seed)
    depths = np.random.RandomState(5).randint(0, 51, len(ids))
    np.testing.assert_array_equal(
        trng.bounce_uniforms(tk, torch.from_numpy(ids),
                             torch.from_numpy(depths)).numpy(),
        np.asarray(jrng.bounce_uniforms_var(
            jk, jnp.asarray(ids.astype(np.int32)), jnp.asarray(depths))))


def test_int32_ray_ids_match_int64():
    ids = torch.arange(1000, dtype=torch.int64)
    k = trng.base_key(7)
    np.testing.assert_array_equal(
        trng.camera_uniforms(k, ids.to(torch.int32)).numpy(),
        trng.camera_uniforms(k, ids).numpy())


def test_disk_and_ball_samples_match():
    """Tolerance 1e-6 abs: transcendentals round differently per libm."""
    r = np.random.RandomState(1)
    u = r.rand(4096, 3).astype(np.float32)
    u[:4] = [[0.0, 0.0, 0.0], [0.999999, 0.5, 1e-7], [0.5, 0.25, 0.125],
             [1e-7, 0.999999, 0.999999]]
    ju = [jnp.asarray(u[:, k]) for k in range(3)]
    tu = [torch.from_numpy(u[:, k]) for k in range(3)]
    np.testing.assert_allclose(trng.unit_disk_sample(*tu[:2]).numpy(),
                               np.asarray(jrng.unit_disk_sample(*ju[:2])),
                               rtol=0, atol=1e-6)
    ball = trng.unit_ball_sample(*tu).numpy()
    np.testing.assert_allclose(ball, np.asarray(jrng.unit_ball_sample(*ju)),
                               rtol=0, atol=1e-6)
    assert (np.linalg.norm(ball, axis=1) <= 1.0 + 1e-6).all()
