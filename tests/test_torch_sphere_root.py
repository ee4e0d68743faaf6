"""The megakernels' sphere root (``kernels/csrc/mega_common.cuh::
sphere_group`` and its plain version ``kernels/megakernel.py::_sweep``)
against the JAX package's recorders on far fields, and its padding rows.

The root takes b = d.(o - C), c = |o - C|^2 - r^2, the discriminant and the
roots in float64 from the float32 inputs and rounds each root once to
float32.  The JAX kernels' expanded quadratic (c = |o|^2 - 2 o.C + c0 in
float32) re-hit a sphere just past t_min far from the origin when rounded
op by op; XLA on the CPU, which runs JAX's kernels in interpret mode here,
does not show that fault.  Bounds:

- field5000 at 800x450 @ 4 (the far field of chip_smoke.py's phases 9 and
  10, camera ~60 units out), ray ids [0, 4096): the plain K3t's tape agrees
  with JAX's K3t's at 0.9985 or above per entry (measured 0.99912, where
  JAX's own wavefront recorder agrees with its K3t at 0.99901), with at
  most one path more than JAX's at the depth cap (measured 0 against 1);
- sphere_field(2500) at 64x32 @ 2 (camera ~40 units out): the plain K2b
  parts from JAX's K2b on no more rays than JAX's K2b and wavefront
  recorders part on, plus one (the two packages round the camera ray, the
  normal and the scatter in different orders: 137 rays against JAX's own
  169), with at most one path more than JAX's K2b at the depth cap
  (measured 0 against 5);
- padding rows (the dense pack's columns past the spheres and the
  clustered pack's sentinel slots: radius NaN) never hit, for rays through
  the origin and rays aimed at the sentinels' centre, nor when their
  centres are moved to the origin, where rows of radius 0.01 are hit.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff.replay import record_paths as jax_record
from first_raytracer_tpu.kernels import megakernel_clustered as jmc
from first_raytracer_tpu.kernels.record_mega import (
    pack_scene_mega as jax_pack, record_paths_mega as jax_k2b,
    record_paths_mega_clustered as jax_k3t)
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (camera_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.core import rng as trng
from first_raytracer_tpu_torch.kernels import megakernel as tmk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as tmc
from first_raytracer_tpu_torch.kernels import record_mega as trm
from first_raytracer_tpu_torch.render.integrator import RenderConfig
from first_raytracer_tpu_torch.scene.soa import SceneBuilder


def _port(js, jc, cfg):
    return (scene_from_numpy(js.as_numpy()), camera_from_numpy(jc),
            RenderConfig(nx=cfg.nx, ny=cfg.ny, spp=cfg.spp,
                         max_depth=cfg.max_depth, t_min=cfg.t_min))


def _capped(tape):
    """Paths still hitting at the last row: those at the depth cap."""
    return int((tape[-1] >= 0).sum())


def test_plain_k3t_agrees_with_jax_k3t_on_field5000():
    rays = 4096
    js, jc, cfg = jb.build_preset("sphere-field", n=5000)
    assert (cfg.nx, cfg.ny, cfg.spp, cfg.max_depth) == (800, 450, 4, 50)
    ts, tc, tcfg = _port(js, jc, cfg)
    got, _ = trm.record_paths_mega_clustered_reference(
        tmc.pack_scene_mega_clustered(ts, tc), tc, tcfg, trng.base_key(0),
        num_rays=rays)
    got = got.numpy()
    want = np.asarray(jax_k3t(
        jmc.pack_scene_mega_clustered(js, sort_from=jc.origin), jc, cfg,
        jrng.base_key(0), num_rays=rays, interpret=True))
    agree = float((got == want).mean())
    assert agree >= 0.9985, agree
    assert _capped(got) <= _capped(want) + 1, (_capped(got), _capped(want))


def test_plain_k2b_against_jax_k2b_on_a_far_field():
    js, jc, cfg = jb.build_preset("sphere-field", n=2500, nx=64, ny=32,
                                  spp=2)
    assert float(np.linalg.norm(np.asarray(jc.origin))) > 35.0
    ts, tc, tcfg = _port(js, jc, cfg)
    key = jrng.base_key(0)
    got = trm.record_paths_mega(tmk.pack_scene_mega(ts), tc, tcfg,
                                trng.base_key(0)).numpy()
    want = np.asarray(jax_k2b(jax_pack(js), jc, cfg, key, interpret=True))
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = jax_rays(jc, cfg.nx, cfg.ny, cfg.spp, ids,
                    jrng.camera_uniforms(key, ids))
    wave = np.asarray(jax_record(js, o, d, ids, key, cfg))
    differ = int((got != want).any(axis=0).sum())
    spread = int((want != wave).any(axis=0).sum())
    assert differ <= spread + 1, (differ, spread)
    assert _capped(got) <= _capped(want) + 1, (_capped(got), _capped(want))


def _one_sphere_scene():
    """One small sphere away from the origin: every other row of either
    pack is padding."""
    b = SceneBuilder()
    b.sphere((3.0, 2.0, -7.0), 0.5, b.lambertian((0.5, 0.5, 0.5)))
    return b.build("cpu")


def _probe_rays():
    """Rays through the origin along the axes and a diagonal, from the
    origin, and from the origin towards the sentinels' centre (BIG, BIG,
    BIG)."""
    dirs = torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                         [1.0, 1.0, 1.0], [-1.0, 2.0, 0.5]])
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    o = torch.cat([-5.0 * dirs, torch.zeros_like(dirs)])
    return o, torch.cat([dirs, dirs])


@pytest.mark.parametrize("packer", ["dense", "clustered"])
def test_padding_rows_never_hit(packer):
    scene = _one_sphere_scene()
    if packer == "dense":
        pack = tmk.pack_scene_mega(scene)
    else:
        pack = tmc._pack(scene, None)
    ns = scene.num_spheres
    pad = torch.isnan(pack.sph_mx[:, 7])
    assert int((~pad).sum()) == ns and int(pad.sum()) >= 3
    o, d = _probe_rays()
    # Every row of the table, as the kernels may read it (K1's past its
    # staged rows, K3's whole clusters).
    t, _, _, _ = tmk._sweep(pack.sph_mx, None, o, d, 1e-3)
    assert (t == tmk.BIG).all(), t
    # The NaN radius alone keeps the rows out: moved to the origin they
    # still miss every ray through it, and with a radius of 0.01 there
    # instead they are hit, 0.01 before the origin: the sweep reads them.
    moved = pack.sph_mx.clone()
    moved[pad, 4:7] = 0.0
    t0, _, _, _ = tmk._sweep(moved, None, o, d, 1e-3)
    assert (t0 == tmk.BIG).all(), t0
    moved[pad, 7] = 0.01
    t1, w1, _, _ = tmk._sweep(moved, None, o, d, 1e-3)
    assert torch.allclose(t1[:5], torch.full((5,), 4.99), atol=2e-4), t1
    assert bool(pad[w1[:5]].all())
