"""The benchmark's inputs handed to the program under test.

The scene arrays (``scenes.py``) become the port's ``Scene`` and its
camera frame is made by the port's ``make_camera`` from the configuration's
parameters; the reference works out its own frame from the same
parameters.  The port is imported inside the functions, so that importing
the benchmark loads none of it.
"""
from __future__ import annotations

import numpy as np
import torch


def scene(arrays, device):
    """The port's ``Scene`` of the benchmark's sphere arrays: no triangles,
    constant textures."""
    from first_raytracer_tpu_torch.scene.soa import Scene

    m = arrays["mat_type"].shape[0]
    host = dict(
        sphere_center=arrays["sphere_center"],
        sphere_radius=arrays["sphere_radius"],
        sphere_mat=arrays["sphere_mat"],
        tri_v0=np.zeros((0, 3), np.float32),
        tri_v1=np.zeros((0, 3), np.float32),
        tri_v2=np.zeros((0, 3), np.float32),
        tri_mat=np.zeros((0,), np.int32),
        mat_type=arrays["mat_type"],
        tex_type=np.zeros((m,), np.int32),
        albedo=arrays["albedo"],
        albedo2=np.zeros((m, 3), np.float32),
        tex_scale=np.full((m,), 10.0, np.float32),
        fuzz=arrays["fuzz"],
        ref_idx=arrays["ref_idx"])
    return Scene(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in host.items()})


def camera(params, image, device):
    """The port's camera frame of the configuration's camera."""
    from first_raytracer_tpu_torch.render.camera import make_camera

    return make_camera(params["lookfrom"], params["lookat"], params["vup"],
                       float(params["vfov"]), image["nx"] / image["ny"],
                       aperture=float(params["aperture"]),
                       focus_dist=float(params["focus_dist"]), device=device)


def render_config(image, **kw):
    """The port's ``RenderConfig`` of the configuration's image."""
    from first_raytracer_tpu_torch.render.integrator import RenderConfig

    return RenderConfig(nx=int(image["nx"]), ny=int(image["ny"]),
                        spp=int(image["spp"]),
                        max_depth=int(kw.pop("max_depth", image["max_depth"])),
                        t_min=float(image["t_min"]), **kw)


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
