"""K16 and K17, the differentiable scan's row gathers and their sums, on
the CPU (``first_raytracer_tpu_torch/kernels/gather_rows.py``).

- ``row_sum_plain`` (K17's plain version) against NumPy's float64
  ``np.add.at`` on indices with heavy duplication: one row read by most
  rays, rows no ray reads, dead rays (zero gradients, +0.0 and -0.0) on
  row 0, NaN and infinities, subnormals, float32 and float64.  Bound per
  (row, column): K17's own, n_row 2^(E - 1024 - F) before its conversion
  (``row_sum_bound``: each value rounded to F = 61 bits under the column's
  largest exponent E), plus ``np.add.at``'s own float64 error (n_row 2^-52
  times the sum of the magnitudes, a sequential sum's bound), plus two
  units in the last place of the table's type (the conversion back rounds
  up to three times); NaN and the infinities where ``np.add.at`` has them.
- ``gather_rows`` against ``jax.vjp`` of JAX's own gather (``table[idx]``)
  on the same seeded float32 inputs: the rows equal, and the table's
  gradient within JAX's float32 sequential scatter-add's bound (n_row
  2^-23 times the sum of the magnitudes) plus K17's.
- One trip's hit record and scatter through the scan's route
  (``recompute_hit_rows`` on ``row_tables``, ``scatter_rows``) against
  ``jax.vjp`` of JAX's ``recompute_hit`` and ``scatter``
  (``first_raytracer_tpu/render/integrator.py:129-164``,
  ``materials/scatter.py:62``) at the same primitives, on the camera rays
  and their first bounce of three-spheres, triangle-mesh (spheres and
  triangles: three tables) and random-spheres (the ground's row read by
  most rays): the outputs within ``rtol=1e-5, atol=1e-5`` and the
  gradients of seeded cotangents within ``rtol=1e-4, atol=1e-5``, the
  bounds tests/test_torch_replay.py holds the shallow presets' replay to.
- K16 and K17 built by g++ through the host emulation
  (``kernels/host_emu``), reached through ``megakernel.launch_entry``, bit
  for bit against their plain versions, in float32 and float64 with one,
  two and three tables, and the same bits with the rays permuted and with
  dead rays (zero gradients) moved onto row 0 or added; the differentiable
  scan through them ``torch.equal`` to the plain route on two presets.
- The wrapper's refusals and counters, and the CPU's route to the plain
  versions.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import contextlib
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from first_raytracer_tpu.core import rng as jrng
from first_raytracer_tpu.diff.grad import (merge_params as jax_merge,
                                           split_params as jax_split)
from first_raytracer_tpu.materials.scatter import scatter as jax_scatter
from first_raytracer_tpu.render.camera import generate_rays as jax_rays
from first_raytracer_tpu.render.integrator import (
    recompute_hit as jax_recompute_hit)
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.convert import (params_from_numpy,
                                               scene_from_numpy)
from first_raytracer_tpu_torch.diff import grad as tg
from first_raytracer_tpu_torch.kernels import gather_rows as gr
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.materials.scatter import scatter_rows
from first_raytracer_tpu_torch.render import integrator as tint
from first_raytracer_tpu_torch.scene.payload import row_tables
from test_torch_replay import CASES, _case, _port_rays

DTYPES = [torch.float32, torch.float64]
BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _bits(t):
    """A tensor's bits, so that NaNs compare equal."""
    return t.view(BITS[t.dtype])


def _rows_case(rs, R, rows, cols, dtype, specials=True):
    """Seeded (R,) int64 indices and (R, cols) gradients: 70% of the rays
    on row 0, the rest spread over the first rows - 2 rows (the last two
    read by none), magnitudes over 2^-60 to 2^40, a sixth of the rays dead
    (zero gradients, +0.0 and -0.0, on row 0); with ``specials`` (and 64
    rays or more) NaN, +Inf, -Inf and subnormals."""
    idx = np.where(rs.rand(R) < 0.7, 0, rs.randint(0, rows - 2, R))
    g = rs.randn(R, cols) * np.exp2(rs.randint(-60, 40, (R, cols)))
    dead = rs.rand(R) < 1 / 6
    idx[dead] = 0
    g[dead] = np.where(rs.rand(int(dead.sum()), cols) < 0.5, 0.0, -0.0)
    if specials and R >= 64:
        sub = np.finfo(np.float32 if dtype == torch.float32
                       else np.float64).smallest_subnormal
        live = np.flatnonzero(~dead)
        g[live[0], 0] = np.nan
        g[live[1], 1 % cols], g[live[2], 1 % cols] = np.inf, -np.inf
        g[live[3], 2 % cols] = np.inf
        g[live[4], 3 % cols] = -np.inf
        g[live[5:40], 4 % cols] = sub * rs.randint(1, 9, 35)
        idx[live[1:3]] = idx[live[1]]
    grad = torch.from_numpy(g).to(dtype)
    return torch.from_numpy(idx.astype(np.int64)), grad


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,rows,cols", [(1, 3, 4), (200, 7, 15),
                                         (5000, 40, 20)])
def test_row_sum_plain_against_numpy(dtype, R, rows, cols):
    idx, grad = _rows_case(np.random.RandomState(R), R, rows, cols, dtype)
    got = gr.row_sum_plain(grad, idx, rows)
    assert got.dtype == dtype and got.shape == (rows, cols)
    g = grad.double().numpy()
    want = np.zeros((rows, cols))
    with np.errstate(invalid="ignore"):  # +Inf + -Inf: NaN, as wanted
        np.add.at(want, idx.numpy(), g)
    mags = np.zeros((rows, cols))
    np.add.at(mags, idx.numpy(), np.abs(np.nan_to_num(g, posinf=0.0,
                                                      neginf=0.0)))
    count = np.bincount(idx.numpy(), minlength=rows)[:, None]
    a = got.double().numpy()
    assert np.array_equal(np.isnan(a), np.isnan(want))
    assert np.array_equal(np.isposinf(a), np.isposinf(want))
    assert np.array_equal(np.isneginf(a), np.isneginf(want))
    fin = np.isfinite(want)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    bound = (gr.row_sum_bound(grad, idx, rows).numpy()
             + count * 2.0 ** -52 * mags
             + 2 * np.spacing(np.abs(want).astype(np_dtype)).astype(float))
    assert (np.abs(a[fin] - want[fin]) <= bound[fin]).all()
    # Unread rows and rows of zeros are +0.0, as a float sum into zeros.
    unread = count[:, 0] == 0
    assert unread.any() and (_bits(got[torch.from_numpy(unread)]) == 0).all()


def test_row_sum_plain_dead_rays_change_nothing():
    rs = np.random.RandomState(3)
    idx, grad = _rows_case(rs, 3000, 30, 15, torch.float32)
    want = gr.row_sum_plain(grad, idx, 30)
    zero = (grad == 0).all(1)
    # The dead rays' rows moved, and more dead rays added on row 0.
    moved = torch.where(zero, torch.from_numpy(rs.randint(0, 30, 3000)),
                        idx)
    extra = torch.zeros((700, 15)), torch.zeros(700, dtype=torch.int64)
    for i, g in ((moved, grad),
                 (torch.cat([idx, extra[1]]), torch.cat([grad, extra[0]]))):
        assert torch.equal(_bits(gr.row_sum_plain(g, i, 30)), _bits(want))
    perm = torch.from_numpy(rs.permutation(3000))
    assert torch.equal(_bits(gr.row_sum_plain(grad[perm], idx[perm], 30)),
                       _bits(want))


def test_gather_rows_against_jax_gather_vjp():
    rs = np.random.RandomState(11)
    rows, cols, R = 60, 15, 4000
    table = rs.randn(rows, cols).astype(np.float32)
    idx, grad = _rows_case(rs, R, rows, cols, torch.float32,
                           specials=False)
    t = torch.from_numpy(table).requires_grad_(True)
    out = gr.gather_rows(t, idx)
    out.backward(grad)
    j_out, vjp = jax.vjp(lambda x: x[jnp.asarray(idx.numpy())],
                         jnp.asarray(table))
    (j_grad,) = vjp(jnp.asarray(grad.numpy()))
    assert np.array_equal(out.detach().numpy(), np.asarray(j_out))
    mags = np.zeros((rows, cols))
    np.add.at(mags, idx.numpy(), np.abs(grad.double().numpy()))
    count = np.bincount(idx.numpy(), minlength=rows)[:, None]
    bound = (count * 2.0 ** -23 * mags
             + gr.row_sum_bound(grad, idx, rows).numpy()
             + np.spacing(np.abs(np.asarray(j_grad))).astype(float))
    assert (np.abs(t.grad.double().numpy() - np.asarray(j_grad))
            <= bound).all()


_UP = (0.0, 0.0, 1.0)
_FIELDS = ("sphere_center", "sphere_radius", "albedo", "albedo2", "fuzz",
           "ref_idx", "tri_v0", "tri_v1", "tri_v2")


def _trip_port(params, scene, o, d, prim, hit, u):
    s = tg.merge_params(scene, params)
    t, p, n, rows = tint.recompute_hit_rows(s, row_tables(s), o, d, prim,
                                            1e-3)
    h = hit & (t < tint.BIG)
    p = torch.where(h[:, None], p, 0.0)
    n = torch.where(h[:, None], n, torch.tensor(_UP))
    new_dir, att, ok = scatter_rows(rows, d, p, n, u)
    return torch.where(h, t, 0.0), p, n, new_dir, att, ok


def _trip_jax(params, js, o, d, prim, hit, u):
    s = jax_merge(js, params)
    t, p, n, mat = jax_recompute_hit(s, o, d, prim, 1e-3)
    h = hit & (t < tint.BIG)
    p = jnp.where(h[:, None], p, 0.0)
    n = jnp.where(h[:, None], n, jnp.asarray(_UP))
    new_dir, att, ok = jax_scatter(s, mat, d, p, n, u)
    return jnp.where(h, t, 0.0), p, n, new_dir, att, ok


def _scene(name):
    if name == "random-spheres":
        return jb.random_scene(nx=16, ny=8, spp=2)
    return jb.build_preset(name, nx=12, ny=6, spp=2)


@pytest.mark.parametrize("bounce", [0, 1])
@pytest.mark.parametrize("name", ["three-spheres", "triangle-mesh",
                                  "random-spheres"])
def test_trip_matches_jax_recompute_hit_and_scatter(name, bounce):
    js, jc, cfg = _scene(name)
    scene = scene_from_numpy(js.as_numpy())
    key = jrng.base_key(1)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    o, d = (torch.from_numpy(np.asarray(x)) for x in jax_rays(
        jc, cfg.nx, cfg.ny, cfg.spp, ids, jrng.camera_uniforms(key, ids)))
    rs = np.random.RandomState(bounce)
    u = torch.from_numpy(rs.rand(cfg.num_rays, 4).astype(np.float32))
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jax_split(js)[0].items()})
    prim, _, hit = tint.intersect_brute(scene, o, d, 1e-3)
    if bounce:  # the first bounce's rays, from the first trip
        with torch.no_grad():
            _, p, _, new_dir, _, ok = _trip_port(params, scene, o, d, prim,
                                                 hit, u)
        keep = hit & ok
        o, d = p[keep], new_dir[keep]
        u = u[keep]
        prim, _, hit = tint.intersect_brute(scene, o, d, 1e-3)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    outs = _trip_port(leaves, scene, o, d, prim, hit, u)
    cts = [torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
           for x in outs[:5]]
    loss = sum((x * c).sum() for x, c in zip(outs[:5], cts))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                 allow_unused=True)))
    jp = {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()}
    args = [jnp.asarray(x.numpy()) for x in (o, d)] + [
        jnp.asarray(prim.numpy()), jnp.asarray(hit.numpy()),
        jnp.asarray(u.numpy())]
    j_outs, vjp = jax.vjp(lambda q: _trip_jax(q, js, *args), jp)
    for a, b in zip(outs, j_outs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    ok_ct = np.zeros(np.asarray(j_outs[5]).shape, jax.dtypes.float0)
    (j_grads,) = vjp((*(jnp.asarray(c.numpy()) for c in cts), ok_ct))
    if name == "random-spheres":  # the ground's row: most rays read it
        assert int((prim == 0).sum()) > prim.shape[0] // 3
    moved = 0
    for k in _FIELDS:
        want = np.asarray(j_grads[k])
        got = np.zeros(want.shape, np.float32) if grads[k] is None \
            else grads[k].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
        moved += bool((want != 0).any())
    assert moved >= 4


@pytest.fixture(scope="module")
def host_lib():
    """``gather_rows.cu`` built by g++ for the host, bound as the card's
    library and reached through ``megakernel.launch_entry``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    from first_raytracer_tpu_torch.kernels.host_emu.build import (
        build_host_library)

    lib = mk.bind_gather_rows(build_host_library(units=("gather_rows.cu",)))

    def host_entry(dev, name, *args):
        assert dev.type == "cpu"
        err = getattr(lib, name)(*args, None)
        assert err == 0, (name, err)

    saved = mk.launch_entry
    mk.launch_entry = host_entry
    yield lib
    mk.launch_entry = saved


def _tables(rs, count, dtype, R=900):
    shapes = [(41, 4), (7, 9), (12, 11)][:count]
    tables = [torch.from_numpy(rs.randn(*s)).to(dtype) for s in shapes]
    cases = [_rows_case(rs, R, r, c, dtype) for r, c in shapes]
    return tables, [c[0] for c in cases], [c[1] for c in cases]


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_host_kernels_bit_equal_to_plain(host_lib, dtype, count):
    rs = np.random.RandomState(count)
    tables, idxs, grads = _tables(rs, count, dtype)
    shapes = [tuple(t.shape) for t in tables]
    k16, k17 = gr.gather_rows.launches, gr.gather_rows.backward_launches
    rows = gr.launch_gather(tables, idxs)
    assert all(torch.equal(a, b)
               for a, b in zip(rows, gr.gather_plain(tables, idxs)))
    sums = gr.launch_row_sum(grads, idxs, shapes)
    want = [gr.row_sum_plain(g, i, s[0])
            for g, i, s in zip(grads, idxs, shapes)]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(sums, want))
    assert gr.gather_rows.launches == k16 + 1
    assert gr.gather_rows.backward_launches == k17 + 1
    # The rays permuted; the dead rays moved off row 0; dead rays added.
    R = idxs[0].shape[0]
    perm = torch.from_numpy(rs.permutation(R))
    dead = [(g == 0).all(1) for g in grads]
    away = [torch.where(z, torch.from_numpy(rs.randint(0, s[0], R)), i)
            for z, i, s in zip(dead, idxs, shapes)]
    more = [torch.cat([i, torch.zeros(300, dtype=torch.int64)])
            for i in idxs]
    zeros = [torch.cat([g, -torch.zeros((300, g.shape[1]), dtype=dtype)])
             for g in grads]
    for gs, ids in (([g[perm] for g in grads], [i[perm] for i in idxs]),
                    (grads, away), (zeros, more)):
        again = gr.launch_row_sum(gs, ids, shapes)
        assert all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(again, want))


def test_host_kernels_edges(host_lib):
    """No rays (the tables' gradients are zeros), one ray, a column of
    subnormals alone, a row whose sum cancels exactly, int64 indices past
    2^31 refused by nothing (they are clamped) but here in range."""
    for dtype in DTYPES:
        t = torch.arange(12, dtype=dtype).reshape(4, 3)
        empty = torch.zeros(0, dtype=torch.int64)
        assert gr.launch_gather([t], [empty])[0].shape == (0, 3)
        out = gr.launch_row_sum([torch.zeros((0, 3), dtype=dtype)], [empty],
                                [(4, 3)])[0]
        assert torch.equal(_bits(out), _bits(torch.zeros((4, 3),
                                                         dtype=dtype)))
        tiny = torch.finfo(dtype).smallest_normal / 8
        g = torch.tensor([[1.5, tiny, -2.0], [-1.5, tiny, 2.0]], dtype=dtype)
        i = torch.tensor([2, 2])
        got = gr.launch_row_sum([g], [i], [(4, 3)])[0]
        assert torch.equal(_bits(got), _bits(gr.row_sum_plain(g, i, 4)))
        want = torch.zeros((4, 3), dtype=dtype)
        want[2, 1] = 2 * tiny
        assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["three-spheres", "triangle-mesh"])
def test_scan_through_host_kernels_equals_plain(host_lib, monkeypatch,
                                                name):
    p, _ = _case(name)
    params = params_from_numpy(p["params"])
    args = (p["scene"], p["camera"], p["cfg"], p["key"], p["ids"],
            p["target"])
    want = tg.render_loss_and_grads(params, *args, method="scan")
    monkeypatch.setattr(tint, "gather_rows", gr.gather_rows_kernels)
    k16, k17 = gr.gather_rows.launches, gr.gather_rows.backward_launches
    got = tg.render_loss_and_grads(params, *args, method="scan")
    # K16 once a trip; K17 once a trip but the last, whose rows reach no
    # output (its scatter only makes the carry of a trip that never runs).
    trips = p["cfg"].max_depth + 1
    assert gr.gather_rows.launches - k16 == trips
    assert gr.gather_rows.backward_launches - k17 == trips - 1
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k


def test_wrapper_refuses_and_routes():
    t = torch.randn(5, 4)
    i = torch.tensor([0, 4, 4])
    k16, k17 = gr.gather_rows.launches, gr.gather_rows.backward_launches
    tt = t.clone().requires_grad_(True)
    out = gr.gather_rows(tt, i)  # the CPU: the plain versions, no count
    out.sum().backward()
    assert torch.equal(out, t[i])
    assert torch.equal(tt.grad, torch.tensor([1.0, 0, 0, 0, 2.0])[:, None]
                       .expand(5, 4))
    assert (gr.gather_rows.launches, gr.gather_rows.backward_launches) == \
        (k16, k17)
    a, b = gr.gather_rows((t, t[:2].clone()), (i, i.clamp(max=1)))
    assert torch.equal(a, t[i]) and torch.equal(b, t[:2][i.clamp(max=1)])
    bad = [((t.int(), i), "float32 or float64"),
           ((t, i.int()), "int64"),
           ((t, i[:, None]), "int64"),
           (((t, t.double()), (i, i)), "expected 2-D torch.float32"),
           (((t, t), (i, i[:2])), "int64"),
           (((t,) * 4, (i,) * 4), "1-3 tables"),
           (((t, t), (i,)), "1-3 tables")]
    for (table, idx), msg in bad:
        with pytest.raises(ValueError, match=msg):
            gr.gather_rows_kernels(table, idx)
    with pytest.raises(ValueError, match="no row-gather kernel"):
        gr.gather_rows(t.to("meta"), i.to("meta"))


@pytest.mark.parametrize("name", CASES)
def test_scan_rows_route_against_the_scene_route(name):
    """The scan through the row tables against the same trips with the hit
    record and scatter gathered from the scene's tensors (the route before
    K16 and K17): radiance and loss bit-equal (a gather is exact), every
    gradient within ``rtol=1e-5, atol=1e-7`` (float32 sums in another
    order) and finite."""
    p, _ = _case(name)
    params = params_from_numpy(p["params"])
    cfg = dataclasses.replace(p["cfg"], differentiable=True)
    o, d = _port_rays(p)

    def radiance(q, resolve_fn=None):
        return tint.trace_rays(tg.merge_params(p["scene"], q), o, d,
                               p["ids"], p["key"], cfg,
                               resolve_fn=resolve_fn)

    def loss(resolve_fn):
        return lambda q: torch.mean((radiance(q, resolve_fn)
                                     - p["target"]) ** 2)

    scene_route = tint._resolver(tint.default_intersect)
    with torch.no_grad():
        assert torch.equal(radiance(params), radiance(params, scene_route))
    got = tg.value_and_grad(loss(None), params)
    want = tg.value_and_grad(loss(scene_route), params)
    assert torch.equal(got[0], want[0])
    for k, g in want[1].items():
        assert bool(torch.isfinite(got[1][k]).all()), k
        np.testing.assert_allclose(got[1][k].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------
# K17's single launch: ranges by ticket, the block's table in shared memory
# or the global one, the waits, the conversion shared out; K16's tiles.
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _interleaved(lib, resident, seed):
    """The emulation's launches with ``resident`` blocks in flight at once
    (0: one after another), their fibers swept in orders drawn from
    ``seed``; yields a function that returns the spin-waits since."""
    lib.frt_emu_interleave(resident, seed)
    try:
        yield lambda: int(lib.frt_emu_spins())
    finally:
        lib.frt_emu_interleave(0, 0)


def _sum_case(rs, shapes, R, dtype):
    cases = [_rows_case(rs, R, r, c, dtype) for r, c in shapes]
    return [c[0] for c in cases], [c[1] for c in cases]


def _path(lib, shapes):
    """The path K17's launcher takes for tables of ``shapes``."""
    entries = sum(r * c for r, c in shapes)
    return "shared" if lib.frt_row_sum_shared(entries) else "global"


def _same_sums(grads, idxs, shapes):
    got = gr.launch_row_sum(grads, idxs, shapes)
    want = [gr.row_sum_plain(g, i, s[0])
            for g, i, s in zip(grads, idxs, shapes)]
    return all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


# The emulation reports 2 x 2 resident blocks: 4100 rays are 5 ranges of
# at most 1024 (a thread's one ray; the last range 4), 2049 rays 3 ranges
# of 683, 1025 rays 2 ranges of 513 (the last partial).  In flight: one
# after another (a block takes every range), two of the four, all four,
# more than the grid.
SHARED_TABLES = [(41, 4), (7, 9), (12, 11)]
GLOBAL_TABLES = [(900, 4), (40, 9), (900, 11)]  # 14,860 entries


@pytest.mark.parametrize("resident,seed", [(0, 0), (2, 1), (4, 2), (4, 7),
                                           (9, 3)])
@pytest.mark.parametrize("path", ["shared", "global"])
def test_host_k17_interleaved_bit_equal(host_lib, path, resident, seed):
    shapes = SHARED_TABLES if path == "shared" else GLOBAL_TABLES
    assert _path(host_lib, shapes) == path
    rs = np.random.RandomState(100 * resident + seed)
    for count, dtype, R in ((3, torch.float32, 4100), (2, torch.float64, 2049),
                            (1, torch.float32, 1025)):
        idxs, grads = _sum_case(rs, shapes[:count], R, dtype)
        with _interleaved(host_lib, resident, seed) as spins:
            assert _same_sums(grads, idxs, shapes[:count])
            if resident > 1 and R == 4100:  # a block waited on the others
                assert spins() > 0


@pytest.mark.parametrize("path", ["shared", "global"])
def test_host_k17_order_and_dead_rays_interleaved(host_lib, path):
    """The same bits with the rays permuted, the dead rays moved and dead
    rays added, with four blocks in flight."""
    shapes = SHARED_TABLES if path == "shared" else GLOBAL_TABLES
    rs = np.random.RandomState(17)
    R = 2600
    idxs, grads = _sum_case(rs, shapes, R, torch.float32)
    want = [gr.row_sum_plain(g, i, s[0])
            for g, i, s in zip(grads, idxs, shapes)]
    perm = torch.from_numpy(rs.permutation(R))
    dead = [(g == 0).all(1) for g in grads]
    away = [torch.where(z, torch.from_numpy(rs.randint(0, s[0], R)), i)
            for z, i, s in zip(dead, idxs, shapes)]
    more = [torch.cat([i, torch.zeros(1000, dtype=torch.int64)])
            for i in idxs]
    zeros = [torch.cat([g, torch.zeros((1000, g.shape[1]))]) for g in grads]
    with _interleaved(host_lib, 4, 5):
        for gs, ids in ((grads, idxs),
                        ([g[perm] for g in grads], [i[perm] for i in idxs]),
                        (grads, away), (zeros, more)):
            got = gr.launch_row_sum(gs, ids, shapes)
            assert all(torch.equal(_bits(a), _bits(b))
                       for a, b in zip(got, want))


@pytest.mark.parametrize("R", [0, 1, 31, 1023, 1024, 1025, 4097])
def test_host_k17_ray_counts(host_lib, R):
    """No rays (zeros), one, less than a warp, around a block's 1024
    threads and past the four ranges' multiple, on both paths, with the
    blocks interleaved."""
    rs = np.random.RandomState(R)
    for shapes in (SHARED_TABLES[:2], GLOBAL_TABLES[:1]):
        idxs, grads = _sum_case(rs, shapes, R, torch.float64)
        with _interleaved(host_lib, 3, R):
            assert _same_sums(grads, idxs, shapes)


def test_host_k17_paths_and_scratch(host_lib):
    """The launcher's path: shared for the final scene's tables (486
    spheres and materials) and triangle-mesh's, global past a block's
    budget, one boundary between; the wrapper's scratch taken and a word
    less refused."""
    assert _path(host_lib, [(486, 4), (486, 11)]) == "shared"
    assert _path(host_lib, [(2, 4), (10, 9), (4, 11)]) == "shared"
    assert _path(host_lib, [(5000, 4), (5000, 11)]) == "global"
    shared = [bool(host_lib.frt_row_sum_shared(e)) for e in
              range(1, 20001, 7)]
    assert shared[0] and not shared[-1]
    assert shared == sorted(shared, reverse=True)
    rs = np.random.RandomState(5)
    shapes = [(41, 4), (12, 11)]
    idxs, grads = _sum_case(rs, shapes, 300, torch.float32)
    assert gr.row_sum_words(shapes) == 3 * (41 * 4 + 12 * 11) + 5
    outs = [torch.empty(s) for s in shapes]
    desc = gr._desc([(g.data_ptr(), i.data_ptr(), o.data_ptr(), *s)
                     for g, i, o, s in zip(grads, idxs, outs, shapes)])
    words = gr.row_sum_words(shapes)
    work = torch.empty(words, dtype=torch.int64)
    assert host_lib.frt_row_sum_f32(desc, 2, 300, work.data_ptr(),
                                    words - 1, None) != 0
    assert host_lib.frt_row_sum_f32(desc, 2, 300, work.data_ptr(), words,
                                    None) == 0
    assert all(torch.equal(_bits(o), _bits(gr.row_sum_plain(g, i, s[0])))
               for o, g, i, s in zip(outs, grads, idxs, shapes))


def _gather_desc(tables, idxs, outs):
    return gr._desc([(t.data_ptr(), i.data_ptr(), o.data_ptr(), t.shape[0],
                      t.shape[1]) for t, i, o in zip(tables, idxs, outs)])


def _host_gather(lib, tables, idxs, bits, R):
    """K16 through the host build into outputs 16-byte aligned (``bits``
    32: the launcher's 32-bit path) or 8 bytes off (64: its int64 path);
    the launcher's choice checked, then its error code and the outputs."""
    off = 0 if bits == 32 else 8 // tables[0].element_size()
    outs = [torch.full((R * t.shape[1] + off,), float("nan"),
                       dtype=t.dtype)[off:].view(R, t.shape[1])
            for t in tables]
    desc = _gather_desc(tables, idxs, outs)
    assert lib.frt_gather_rows_bits(desc, len(tables), R) == bits
    name = "frt_gather_rows_" + ("f32" if tables[0].dtype == torch.float32
                                 else "f64")
    return getattr(lib, name)(desc, len(tables), R, None), outs


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_host_k16_paths_equal_index_select(host_lib, dtype, bits):
    """K16 on its 32-bit path (tiles of 256 rays written 16 bytes a thread,
    cut mid-row at 9 and 11 columns and at a partial last tile) and its
    int64 path, ``torch.equal`` to ``index_select``, indices out of range
    clamped, with the blocks one after another and interleaved."""
    rs = np.random.RandomState(bits + len(str(dtype)))
    shapes = [(41, 4), (7, 9), (12, 11)]
    for R in (1, 255, 256, 1000):
        tables = [torch.from_numpy(rs.randn(*s)).to(dtype) for s in shapes]
        idxs = [torch.from_numpy(rs.randint(-2, s[0] + 2, R)) for s in shapes]
        err, outs = _host_gather(host_lib, tables, idxs, bits, R)
        assert err == 0
        for o, t, i in zip(outs, tables, idxs):
            assert torch.equal(o, t.index_select(0, i.clamp(0, t.shape[0] - 1)))
    with _interleaved(host_lib, 4, bits):
        err, outs = _host_gather(host_lib, tables, idxs, bits, R)
    assert err == 0 and all(torch.equal(o, t.index_select(0, i.clamp(
        0, t.shape[0] - 1))) for o, t, i in zip(outs, tables, idxs))


@pytest.mark.parametrize("cols", [1, 2, 3, 5, 16, 37, 4095])
def test_host_k16_tile_columns(host_lib, cols):
    """The 32-bit path's tile at column counts up to its largest, 4095."""
    rs = np.random.RandomState(cols)
    R = 300 if cols < 100 else 40
    table = torch.from_numpy(rs.randn(17, cols).astype(np.float32))
    idx = torch.from_numpy(rs.randint(0, 17, R))
    err, (out,) = _host_gather(host_lib, [table], [idx], 32, R)
    assert err == 0 and torch.equal(out, table.index_select(0, idx))


def test_k16_tile_division_is_exact():
    """The 32-bit path's ray and column of a tile element, the high word of
    e (2^32 // cols + 1), equal e // cols for every tile element at every
    column count it takes (checked where floor(e / cols) steps)."""
    ks = np.arange(1, 257, dtype=np.uint64)
    for cols in range(1, 4096):
        magic = np.uint64(0xFFFFFFFF // cols + 1)
        c = np.uint64(cols)
        e = np.concatenate([ks * c - np.uint64(1), ks * c])
        e = e[e < np.uint64(256 * cols)]
        assert np.array_equal((e * magic) >> np.uint64(32), e // c), cols


def test_host_k16_launcher_choice(host_lib):
    """The index width K16's launcher takes: 32 bits where every segment's
    n cols and rows cols are under 2^31, its cols under 4096 and its output
    16-byte aligned; 64 bits otherwise."""
    def bits(n, rows, cols, out=1 << 12):
        desc = gr._desc([(1 << 12, 1 << 12, out, rows, cols)])
        return host_lib.frt_gather_rows_bits(desc, 1, n)
    assert bits(1 << 17, 486, 11) == 32
    assert bits((1 << 31) // 11, 486, 11) == 32
    assert bits((1 << 31) // 11 + 1, 486, 11) == 64
    assert bits(10, (1 << 31) // 9 + 1, 9) == 64
    assert bits(10, 3, 4095) == 32 and bits(10, 3, 4096) == 64
    assert bits(10, 3, 4, out=(1 << 12) + 8) == 64
    assert bits(0, 3, 4) == 32
    # Two segments: one that needs 64 bits takes the launch there.
    two = gr._desc([(1 << 12, 1 << 12, 1 << 12, 3, 4),
                    (1 << 12, 1 << 12, (1 << 12) + 4, 3, 4)])
    assert host_lib.frt_gather_rows_bits(two, 2, 10) == 64
    assert host_lib.frt_gather_rows_bits(two, 1, 10) == 32
