"""The tape replay's value (K14) and gradient (K15), behind one
``torch.autograd.Function``, and their plain version.

The replay (``diff/replay.py::trace_rays_replay``) walks a recorded tape:
at each row a live ray's hit is re-solved from the recorded primitive's
payload row, shaded and scattered, and a ray that misses adds throughput x
sky.  The JAX package runs it as one jitted ``lax.scan`` and differentiates
it with ``jax.value_and_grad``.

- ``replay_plain`` is the port's op-by-op loop (~586 torch ops a tape row),
  differentiated by autograd through ``_Extract``'s exact gather of the
  payload tables (``_payload_tables``): the CPU's route, and the card's
  yardstick for the kernels.
- ``replay`` runs it on the CPU and launches the kernels on a CUDA device:
  K14 (``kernels/csrc/replay.cu``, forward) walks each ray's tape column
  in registers and, when a gradient will be taken, keeps each bounce's
  (o, dr, throughput) in a dense (rows, R, 9) scratch; K15 (backward)
  takes the radiance's adjoint and sums the payload tables' gradients in
  float64 over the rays, rounded once to the tables' type, as
  ``_Extract`` does.  The gradient then flows from the tables to the
  scene's leaves through ``_payload_tables``' torch ops.  K14's float32
  radiance is bit-equal to the plain loop's as torch runs it on the card;
  the gradients agree within float64 summation order.

The wrapper takes float32 or float64 rays and tables of the same type, a
tape of int32 rows that may be a column slice of a wider tape (its row
stride is passed on), and the key as a device tensor (``rng.device_key``),
so a captured graph reads the key from its buffer on every replay.  The
camera rays are no parameter (``diff.grad.DIFF_FIELDS``): an origin or
direction that requires a gradient is refused.  A failed build or launch
raises, and nothing falls back.
"""
from __future__ import annotations

import torch

from ..core import rng
from ..core.vecmath import constant, point_at
from ..geometry.sphere import BIG, sphere_hit_one, sphere_normal
from ..geometry.triangle import triangle_hit_one, triangle_normal
from ..materials.scatter import scatter_from_params
from ..render.integrator import UP, RenderConfig, sky_color
from ..render.wavefront_pass import _check
from ..scene.textures import texture_from_params

__all__ = ["replay", "replay_plain", "replay_kernels", "launch_forward",
           "launch_backward", "REPLACES", "SAVE_COLS", "scratch_bytes"]

REPLACES = "first_raytracer_tpu/diff/replay.py:392"
# Values K14 keeps of a bounce for K15: o, dr and the throughput.
SAVE_COLS = 9


def _mat_block(scene, mat_ids):
    """(N, 11) f32 material payload rows for per-primitive material ids:
    mtype, fuzz, ref_idx, albedo (3), albedo2 (3), tex_scale, tex_type.
    The integer types ride as f32 (exact) and are cast back on use."""
    m = mat_ids.long()
    return torch.cat([
        scene.mat_type[m].to(torch.float32)[:, None],
        scene.fuzz[m][:, None],
        scene.ref_idx[m][:, None],
        scene.albedo[m],
        scene.albedo2[m],
        scene.tex_scale[m][:, None],
        scene.tex_type[m].to(torch.float32)[:, None],
    ], dim=1)


def _payload_tables(scene):
    """Per-primitive payload tables: (Ns, 4 + 11) spheres, (Nt, 9 + 11)
    triangles; geometry and the material row in one table, differentiable
    in every scene leaf."""
    sph = tri = None
    if scene.num_spheres:
        sph = torch.cat([scene.sphere_center, scene.sphere_radius[:, None],
                         _mat_block(scene, scene.sphere_mat)], dim=1)
    if scene.num_triangles:
        tri = torch.cat([scene.tri_v0, scene.tri_v1, scene.tri_v2,
                         _mat_block(scene, scene.tri_mat)], dim=1)
    return sph, tri


class _Extract(torch.autograd.Function):
    """Payload rows ``table[idx]``: an exact gather forward, an
    ``index_add`` into a float64 buffer backward.

    The backward sums each row's gradient over the rays that read it in
    float64 and rounds it once: a row that many rays read (the ground
    sphere's, a hundred thousand at 2^17 rays) otherwise accumulates
    float32 rounding in proportion to their count, 3e-4 of the final
    scene's largest albedo gradient at 2^17 rays, so that the same rays
    summed in another grouping (the sharded step's ranks) gave another
    gradient.  The forward gathers in the table's own type."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        acc = grad.new_zeros((ctx.rows, grad.shape[1]), dtype=torch.float64)
        return acc.index_add_(0, idx, grad.double()).to(grad.dtype), None


_extract = _Extract.apply


def _resolve_from_tape(scene, sph_t, tri_t, o, dr, rec, t_min):
    """Differentiable hit record and material payload from recorded ids.

    Mirrors ``render.integrator.recompute_hit`` branch for branch (clamped
    ids, masked mixed select).  Returns ``(t, p, n, mat_payload)``, the
    payload being the (R, 11) material block.
    """
    ns, nt = scene.num_spheres, scene.num_triangles
    rec0 = rec.long().clamp(min=0)
    if nt == 0:
        pay = _extract(sph_t, rec0.clamp(max=ns - 1))
        c, r = pay[:, 0:3], pay[:, 3]
        t = sphere_hit_one(o, dr, c, r, t_min, BIG)
        p, n = sphere_normal(o, dr, t, c, r)
        return t, p, n, pay[:, 4:]
    if ns == 0:
        pay = _extract(tri_t, rec0.clamp(max=nt - 1))
        v0, v1, v2 = pay[:, 0:3], pay[:, 3:6], pay[:, 6:9]
        t = triangle_hit_one(o, dr, v0, v1, v2, t_min, BIG)
        return t, point_at(o, dr, t), triangle_normal(v0, v1, v2), pay[:, 9:]
    is_sph = rec0 < ns
    pay_s = _extract(sph_t, rec0.clamp(0, ns - 1))
    pay_t = _extract(tri_t, (rec0 - ns).clamp(0, nt - 1))
    c, r = pay_s[:, 0:3], pay_s[:, 3]
    v0, v1, v2 = pay_t[:, 0:3], pay_t[:, 3:6], pay_t[:, 6:9]
    t_s = sphere_hit_one(o, dr, c, r, t_min, BIG)
    t_t = triangle_hit_one(o, dr, v0, v1, v2, t_min, BIG)
    t = torch.where(is_sph, t_s, t_t)
    p = point_at(o, dr, t)
    _, n_s = sphere_normal(o, dr, t, c, r)
    n = torch.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    mat = torch.where(is_sph[:, None], pay_s[:, 4:], pay_t[:, 9:])
    return t, p, n, mat


def replay_plain(scene, origin, direction, ray_ids, key, cfg: RenderConfig,
                 tape):
    """K14's and K15's plain version: the differentiable (R, 3) radiance
    of a recorded tape, torch ops on any device, differentiated by
    autograd.

    The masked math of ``trace_rays`` with the intersector replaced by a
    tape lookup; one trip per tape row.  Dead and missing lanes get
    sanitized hit data before shading, so their t = BIG points feed no Inf
    or NaN into the gradients.
    """
    dev = origin.device
    R = origin.shape[0]
    sph_t, tri_t = _payload_tables(scene)
    up = constant(UP, torch.float32, dev)
    o, dr = origin, direction
    throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    for d in range(tape.shape[0]):
        rec = tape[d]
        t, p, n, matp = _resolve_from_tape(scene, sph_t, tri_t, o, dr, rec,
                                           cfg.t_min)
        hit = (rec >= 0) & (t < BIG)
        p = torch.where(hit[:, None], p, 0.0)
        n = torch.where(hit[:, None], n, up)

        miss_now = alive & ~hit
        radiance = radiance + torch.where(
            miss_now[:, None], throughput * sky_color(dr), 0.0)

        uniforms = rng.bounce_uniforms(key, ray_ids, d)
        tex = texture_from_params(matp[:, 10].to(torch.int32), matp[:, 3:6],
                                  matp[:, 6:9], matp[:, 9], p)
        new_dir, attenuation, scattered_ok = scatter_from_params(
            matp[:, 0].to(torch.int32), matp[:, 1], matp[:, 2], tex, dr, p,
            n, uniforms)
        cont = alive & hit & scattered_ok & (d < cfg.max_depth)

        throughput = torch.where(cont[:, None], throughput * attenuation,
                                 throughput)
        o = torch.where(cont[:, None], p, o)
        dr = torch.where(cont[:, None], new_dir, dr)
        alive = cont
    return radiance


def scratch_bytes(rows, num_rays, dtype=torch.float32):
    """Bytes of the scratch K14 keeps for K15: (rows, R, 9) of the rays'
    type, and the (R,) int32 rows of the rays' misses."""
    size = torch.tensor([], dtype=dtype).element_size()
    return rows * num_rays * SAVE_COLS * size + 4 * num_rays


def _ptr(t):
    return None if t is None else t.data_ptr()


def _rows(t):
    return 0 if t is None else t.shape[0]


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def launch_forward(sph, tri, origin, direction, ray_ids, key, tape,
                   max_depth, t_min, grads=True):
    """K14 once over the rays, on checked inputs (``replay_kernels``): the
    payload tables ``sph`` and ``tri`` (None where the scene has none), the
    rays, their ids, the key on their device and the tape.  Returns the
    (R, 3) radiance and, with ``grads``, the scratch (rows, R, 9) and the
    (R,) int32 row of each ray's miss (-1: no radiance) that K15 reads;
    else None for both."""
    from ..kernels import megakernel

    dev, dtype = origin.device, origin.dtype
    R, rows = origin.shape[0], tape.shape[0]
    radiance = torch.empty((R, 3), dtype=dtype, device=dev)
    save = end = None
    if grads:
        save = torch.empty((rows, R, SAVE_COLS), dtype=dtype, device=dev)
        end = torch.empty((R,), dtype=torch.int32, device=dev)
    megakernel.launch_entry(
        dev, f"frt_replay_forward_{_suffix(dtype)}", _ptr(sph),
        _rows(sph), _ptr(tri), _rows(tri), origin.data_ptr(),
        direction.data_ptr(), ray_ids.data_ptr(), key.data_ptr(),
        tape.data_ptr(), tape.stride(0), rows, int(max_depth),
        float(t_min), R, radiance.data_ptr(), _ptr(save), _ptr(end))
    if R:
        replay.launches += 1
    return radiance, save, end


def launch_backward(sph, tri, ray_ids, key, tape, max_depth, t_min, save,
                    end, grad):
    """K15 once: the payload tables' gradients (None where the scene has
    no such table) from ``launch_forward``'s scratch and ``end`` and the
    radiance's adjoint ``grad`` (R, 3)."""
    from ..kernels import megakernel

    dev, dtype = save.device, save.dtype
    R, rows = end.shape[0], tape.shape[0]
    ns, nt = _rows(sph), _rows(tri)
    grad = grad.to(dtype).contiguous()
    total = torch.empty((ns * 15 + nt * 20,), dtype=torch.float64,
                        device=dev)
    g_sph = None if sph is None else torch.empty_like(sph)
    g_tri = None if tri is None else torch.empty_like(tri)
    megakernel.launch_entry(
        dev, f"frt_replay_backward_{_suffix(dtype)}", _ptr(sph), ns,
        _ptr(tri), nt, ray_ids.data_ptr(), key.data_ptr(), tape.data_ptr(),
        tape.stride(0), rows, int(max_depth), float(t_min), R,
        save.data_ptr(), end.data_ptr(), grad.data_ptr(), total.data_ptr(),
        _ptr(g_sph), _ptr(g_tri))
    if R:
        replay.backward_launches += 1
    return g_sph, g_tri


class _Replay(torch.autograd.Function):
    """K14 forward, K15 backward: the radiance of the rays from the payload
    tables ``sph`` and ``tri`` (None where the scene has none), and the
    tables' gradients from the radiance's."""

    @staticmethod
    def forward(ctx, sph, tri, origin, direction, ray_ids, key, tape,
                max_depth, t_min):
        grads = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        radiance, save, end = launch_forward(
            sph, tri, origin, direction, ray_ids, key, tape, max_depth,
            t_min, grads)
        if grads:
            ctx.save_for_backward(sph, tri, ray_ids, key, tape, save, end)
            ctx.scalars = (max_depth, t_min)
        return radiance

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        sph, tri, ray_ids, key, tape, save, end = ctx.saved_tensors
        g_sph, g_tri = launch_backward(sph, tri, ray_ids, key, tape,
                                       *ctx.scalars, save, end, grad)
        return g_sph, g_tri, None, None, None, None, None, None, None


def replay_kernels(scene, origin, direction, ray_ids, key,
                   cfg: RenderConfig, tape):
    """``replay`` through K14 and K15 on the rays' device, whatever it is
    (the card; the tests' host build of the source on the CPU).  Checks
    what the kernels take and refuses the rest."""
    dev, dtype = origin.device, origin.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K14 takes float32 or float64 rays, not {dtype}")
    if origin.dim() != 2:
        raise ValueError(f"origin: expected (R, 3), got {tuple(origin.shape)}")
    R = origin.shape[0]
    if R >= 2 ** 31:
        raise ValueError(f"{R} rays: K14 indexes a launch in 32 bits")
    _check("origin", origin, dtype, (R, 3), dev)
    _check("direction", direction, dtype, (R, 3), dev)
    for name, t in (("origin", origin), ("direction", direction)):
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the camera rays are no "
                             "parameter of the replay")
    if not ray_ids.dtype.is_floating_point and ray_ids.dtype != torch.int64:
        ray_ids = ray_ids.to(torch.int64)
    _check("ray_ids", ray_ids, torch.int64, (R,), dev)
    if tape.dtype != torch.int32 or tape.dim() != 2 or \
            tape.shape[1] != R or tape.device != dev:
        raise ValueError(f"tape: {tape.dtype} {tuple(tape.shape)} on "
                         f"{tape.device}, expected int32 (rows, {R}) on "
                         f"{dev}")
    if tape.shape[0] and R and (tape.stride(1) != 1 or tape.stride(0) < R):
        raise ValueError(f"tape: strides {tape.stride()}, expected its "
                         "columns contiguous in each row")
    sph, tri = _payload_tables(scene)
    if sph is None and tri is None:
        raise ValueError("K14 needs a scene with a primitive")
    for name, t, cols in (("sphere", sph, 15), ("triangle", tri, 20)):
        if t is not None:
            _check(f"{name} payload table", t, dtype, (t.shape[0], cols), dev)
    k = rng.device_key(key, dev)
    return _Replay.apply(sph, tri, origin, direction, ray_ids, k, tape,
                         cfg.max_depth, cfg.t_min)


def replay(scene, origin, direction, ray_ids, key, cfg: RenderConfig, tape):
    """The differentiable (R, 3) radiance of a recorded tape
    (``diff/replay.py::trace_rays_replay``): on a CUDA device K14, and K15
    for its gradient (``replay_kernels``); on the CPU ``replay_plain``.  A
    tensor on any other device is refused."""
    dev = origin.device
    if dev.type == "cpu":
        return replay_plain(scene, origin, direction, ray_ids, key, cfg,
                            tape)
    if dev.type != "cuda":
        raise ValueError(f"no replay kernel for device {dev}")
    return replay_kernels(scene, origin, direction, ray_ids, key, cfg, tape)


replay.launches = 0  # K14 launches (the kernels' route only)
replay.backward_launches = 0  # K15 launches
