"""first_raytracer_tpu_torch: the path tracer ported to PyTorch and CUDA.

Port of ``first_raytracer_tpu`` (JAX + Pallas for TPU) for one NVIDIA
Hopper GPU.  Sub-packages and modules keep the JAX package's names, so each
module's counterpart is found by path.  Plain functions work on tensors;
entry points take a ``device``, ``"cuda"`` unless the caller asks for
``"cpu"``.  The forward megakernel renders (dense, and clustered for large
scenes) and the differentiable pass's tape recorders run through
hand-written CUDA kernels (``kernels/csrc/``) on a GPU
and through their plain PyTorch versions on the CPU; ``diff/`` replays the
tape under ``torch.autograd``.  This package never imports JAX.
"""
from .kernels.megakernel import render_image_mega
from .kernels.megakernel_clustered import render_image_mega_clustered
from .render.api import render_image, render_ray_batch
from .render.camera import Camera, make_camera
from .render.integrator import RenderConfig
from .scene.builders import PRESETS, build_preset
from .scene.soa import Scene, SceneBuilder

__version__ = "0.1.0"

__all__ = [
    "Camera", "make_camera", "RenderConfig", "Scene", "SceneBuilder",
    "PRESETS", "build_preset", "render_image", "render_ray_batch",
    "render_image_mega", "render_image_mega_clustered", "__version__",
]
