"""Carry scenes, cameras and parameters across from numpy arrays.

``scene_from_numpy(jax_scene.as_numpy())`` and ``camera_from_numpy(...)``
turn the JAX package's scene and camera, given as numpy arrays, into the
port's tensors, and ``params_from_numpy`` does the same for a dict of
differentiable parameters (``diff.grad.split_params``), so a test can feed
both packages the same state.  This module imports no JAX: any object with
the same field names works.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .render.camera import Camera
from .scene.soa import Scene

__all__ = ["scene_from_numpy", "camera_from_numpy", "camera_to_numpy",
           "params_from_numpy", "params_to_numpy"]

_INT_FIELDS = {"sphere_mat", "tri_mat", "mat_type", "tex_type"}


def _field_names(cls):
    return [f.name for f in dataclasses.fields(cls)]


def _tensor(x, name, device):
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def scene_from_numpy(s, device="cpu") -> Scene:
    """A port ``Scene`` from an object with ``Scene``'s array fields."""
    return Scene(**{n: _tensor(getattr(s, n), n, device)
                    for n in _field_names(Scene)})


def camera_from_numpy(c, device="cpu") -> Camera:
    """A port ``Camera`` from an object with ``Camera``'s array fields."""
    return Camera(**{n: _tensor(getattr(c, n), n, device)
                     for n in _field_names(Camera)})


def camera_to_numpy(camera: Camera) -> dict:
    """The camera's fields as a dict of numpy arrays (``Scene`` has
    ``as_numpy``)."""
    return {n: getattr(camera, n).detach().cpu().numpy()
            for n in _field_names(Camera)}


def params_from_numpy(params: dict, device="cpu") -> dict:
    """A parameter dict of f32 leaf tensors with ``requires_grad`` from a
    dict of arrays."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            .requires_grad_(True) for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """The parameter (or gradient) dict as numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
