"""``first_raytracer_tpu_torch.entry``, the twin of the JAX package's
``__graft_entry__.entry()``: the same forward step (8192 ray ids of the
final scene at 128x64 @ 2 through the BVH walk) on the same inputs, per-ray
radiance within the image bound ``(|a - b| > 1e-3).mean() < 0.01``."""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import __graft_entry__  # noqa: E402
from first_raytracer_tpu_torch.accel.build import FlatBVH  # noqa: E402
from first_raytracer_tpu_torch.entry import entry  # noqa: E402


def test_entry_matches_jax_entry():
    fn_j, args_j = __graft_entry__.entry()
    want = np.asarray(jax.jit(fn_j)(*args_j))
    fn, args = entry(device="cpu")
    got = fn(*args).numpy()
    assert got.shape == want.shape == (8192, 3)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) > 1e-3).mean() < 0.01


def test_entry_args_are_on_the_asked_device():
    _, (scene, camera, key, ray_ids, accel) = entry(device="cpu")
    assert isinstance(accel, FlatBVH)
    assert scene.device.type == ray_ids.device.type == "cpu"
    assert torch.equal(ray_ids, torch.arange(8192))
    assert key.tolist() == [0, 0]
    assert (scene.num_spheres, camera.origin.shape) == (486, (3,))
