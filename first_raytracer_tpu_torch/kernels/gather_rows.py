"""K16 and K17: the differentiable scan's row gathers and their sums, behind
one ``torch.autograd.Function``, and their plain versions.

Each trip of the scan (``render/integrator.py``, ``cfg.differentiable``)
re-solves its hits from the primitives' rows: a sphere's centre and
radius, a triangle's vertices and the material's row
(``scene/payload.py::row_tables``), gathered at the rays' clamped ids.
The JAX package gathers them from the scene's arrays
(``first_raytracer_tpu/render/integrator.py:155-156``,
``materials/scatter.py:62``, ``scene/textures.py:29-31``) and
``jax.value_and_grad`` transposes each gather into a scatter-add, which
XLA fused into the scan.  The port's op-by-op gathers took torch's
indexing backward, which sorts a gather's indices and adds each row's rays
one after another: the ground sphere's row, which most rays read, made it
98.9% of the scan's time on the card (PERF.md section 5, PR 25).

- ``gather_rows(table, idx)``: ``table[idx]`` for a table and its (R,)
  int64 indices, or for tuples of up to three of each (one launch for a
  trip's tables).  Its backward sums each table row's gradient over the
  rays that read it, deterministically: the same bits whatever the rays'
  order, in a graph or eagerly, and adding zeros (the dead rays' rows)
  changes nothing.  On a CUDA tensor it launches K16 (the gather) and K17
  (the sum), ``kernels/csrc/gather_rows.cu``, and raises if either fails
  to build or launch; on the CPU it runs ``gather_rows_plain``.
- ``gather_rows_plain``: the same function in torch ops on any device:
  ``gather_plain`` (``index_select``) forward, ``row_sum_plain`` backward,
  which takes K17's sum in int64 torch ops, bit-equal to it.
- ``gather_rows_kernels``: the kernels' route on the tensors' device,
  whatever it is (the card; the tests' host build on the CPU).

K17's sum: for each (row, column), E the largest exponent field of the
float64 values added (a zero adds nothing), each value rounded to a
multiple of 2^(E - 1023 - F), F = ``FRAC_BITS`` = 61 fraction bits under
it, and summed exactly in integers (its high and low 32 bits in two int64
sums, which hold fewer than 2^31 rays), then converted back: the two sums
to float64 and added, the power of two back, the table's type.  So the sum
is within n_row 2^(E - 1024 - F) of the exact sum before its conversion
(each value rounded by at most half a unit), and NaN, +Inf and -Inf reach
the row as a float sum gives them (NaN, or both infinities: NaN; one
infinity: it).  Nothing of it depends on the launch: neither the rays'
order nor zeros added change a bit.
Counters: ``gather_rows.launches`` (K16) and
``gather_rows.backward_launches`` (K17), one a launch.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["gather_rows", "gather_rows_plain", "gather_rows_kernels",
           "gather_plain", "row_sum_plain", "launch_gather",
           "launch_row_sum", "row_sum_bound", "REPLACES",
           "REPLACES_BACKWARD", "MAX_TABLES", "FRAC_BITS"]

# The JAX scan's row gathers (recompute_hit) and the transposes that
# jax.value_and_grad makes of them.
REPLACES = "first_raytracer_tpu/render/integrator.py:155"
REPLACES_BACKWARD = "first_raytracer_tpu/diff/grad.py:107"
MAX_TABLES = 3  # gather_rows.cu's kMaxSegments
FRAC_BITS = 61  # gather_rows.cu's kFracBits


def gather_plain(tables, idxs):
    """K16's plain version: each ``table.index_select(0, idx)``."""
    return tuple(t.index_select(0, i) for t, i in zip(tables, idxs))


def _pow2(k):
    """2^k as float64 for an int64 tensor k in [-1022, 1023]."""
    return ((k + 1023) << 52).view(torch.float64)


def _halves(emax):
    """The shift 2^(F - E + 1023) of a (row, column) of largest exponent
    field E, as two int64 halves (each power of two a normal float64)."""
    k = FRAC_BITS + 1023 - emax
    k1 = torch.div(k, 2, rounding_mode="trunc")
    return k1, k - k1


def row_sum_plain(grad, idx, rows):
    """K17's plain version for one table: the (rows, cols) sums of the
    (R, cols) ``grad``'s rows by ``idx``, in int64 torch ops as K17 takes
    them (module docstring), in ``grad``'s type."""
    n, cols = grad.shape
    g = grad.double().contiguous()
    bits = g.view(torch.int64)
    field = (bits >> 52) & 0x7FF
    nonfinite = field == 0x7FF
    nan = nonfinite & ((bits & 0xFFFFFFFFFFFFF) != 0)
    pos = nonfinite & ~nan & (bits >= 0)
    neg = nonfinite & ~nan & (bits < 0)
    e = torch.where(nonfinite | (g == 0), 0, field.clamp(min=1))
    at = idx[:, None].expand(n, cols)
    zeros = torch.zeros((rows, cols), dtype=torch.int64, device=g.device)
    emax = zeros.scatter_reduce(0, at, e, "amax")
    k1, k2 = _halves(emax.index_select(0, idx))
    q = torch.where(e > 0, torch.round(g * _pow2(k1) * _pow2(k2)),
                    0.0).to(torch.int64)
    hi = zeros.index_add(0, idx, q >> 32)
    lo = zeros.index_add(0, idx, q & 0xFFFFFFFF)
    hi = hi + (lo >> 32)
    k1, k2 = _halves(emax)
    y = (hi.double() * 4294967296.0 + (lo & 0xFFFFFFFF).double()) * \
        _pow2(-k1) * _pow2(-k2)
    y = torch.where(emax > 0, y, 0.0)
    seen = [zeros.index_add(0, idx, m.to(torch.int64)) > 0
            for m in (nan, pos, neg)]
    y = torch.where(seen[1], float("inf"), y)
    y = torch.where(seen[2], float("-inf"), y)
    y = torch.where(seen[0] | (seen[1] & seen[2]), float("nan"), y)
    return y.to(grad.dtype)


def row_sum_bound(grad, idx, rows):
    """The bound K17's sum keeps against the exact sum of ``grad``'s rows
    by ``idx``, per (row, column), before the conversion to the table's
    type: n_row 2^(E - 1024 - F) (module docstring); float64."""
    n, cols = grad.shape
    g = grad.double()
    field = (g.view(torch.int64) >> 52) & 0x7FF
    e = torch.where(g == 0, 0, field.clamp(min=1))
    zeros = torch.zeros((rows, cols), dtype=torch.int64, device=g.device)
    emax = zeros.scatter_reduce(0, idx[:, None].expand(n, cols), e, "amax")
    count = zeros[:, 0].index_add(0, idx, torch.ones_like(idx))
    x = emax - 1024 - FRAC_BITS
    h = torch.div(x, 2, rounding_mode="trunc")
    return count[:, None].double() * _pow2(h) * _pow2(x - h)


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


def _desc(parts):
    """The C launchers' host descriptor: five int64 a segment (table or
    gradient, indices, output, rows, columns)."""
    flat = [v for p in parts for v in p]
    return (ctypes.c_int64 * len(flat))(*flat)


def launch_gather(tables, idxs):
    """K16 once over the tables (checked: ``gather_rows_kernels``): the
    (R, cols) rows of each table at its indices."""
    from . import megakernel

    dev, dtype = tables[0].device, tables[0].dtype
    n = idxs[0].shape[0]
    outs = tuple(torch.empty((n, t.shape[1]), dtype=dtype, device=dev)
                 for t in tables)
    desc = _desc([(t.data_ptr(), i.data_ptr(), o.data_ptr(), t.shape[0],
                   t.shape[1]) for t, i, o in zip(tables, idxs, outs)])
    megakernel.launch_entry(dev, f"frt_gather_rows_{_suffix(dtype)}", desc,
                            len(tables), n)
    if n and any(t.numel() for t in tables):
        gather_rows.launches += 1
    return outs


def launch_row_sum(grads, idxs, shapes):
    """K17 once: each table's (rows, cols) gradient, ``shapes`` its shape,
    from the (R, cols) gradients of its gathered rows.  The scratch comes
    from torch's allocator on the current stream and the launch zeroes
    it."""
    from . import megakernel

    dev, dtype = grads[0].device, grads[0].dtype
    n = idxs[0].shape[0]
    outs = tuple(torch.empty(s, dtype=dtype, device=dev) for s in shapes)
    desc = _desc([(g.data_ptr(), i.data_ptr(), o.data_ptr(), *s)
                  for g, i, o, s in zip(grads, idxs, outs, shapes)])
    words = sum(3 * r * c for r, c in shapes)
    work = torch.empty((words,), dtype=torch.int64, device=dev)
    megakernel.launch_entry(dev, f"frt_row_sum_{_suffix(dtype)}", desc,
                            len(grads), n, work.data_ptr())
    if words:
        gather_rows.backward_launches += 1
    return outs


class _GatherRows(torch.autograd.Function):
    """K16 forward and K17 backward (``kernels``), or their plain versions:
    the rows of ``count`` tables at their indices, and the tables'
    gradients from the rows'."""

    @staticmethod
    def forward(ctx, kernels, count, *args):
        tables, idxs = args[:count], args[count:]
        ctx.save_for_backward(*idxs)
        ctx.kernels = kernels
        ctx.shapes = tuple(tuple(t.shape) for t in tables)
        if kernels:
            return launch_gather(tables, idxs)
        return gather_plain(tables, idxs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        idxs = ctx.saved_tensors
        dtype = grads[0].dtype
        grads = tuple(g.to(dtype).contiguous() for g in grads)
        if ctx.kernels:
            sums = launch_row_sum(grads, idxs, ctx.shapes)
        else:
            sums = tuple(row_sum_plain(g, i, s[0])
                         for g, i, s in zip(grads, idxs, ctx.shapes))
        return (None, None, *sums, *([None] * len(idxs)))


def _pairs(table, idx):
    """(tables, indices, one): a table and its indices, or tuples of
    them."""
    if isinstance(table, torch.Tensor):
        return (table,), (idx,), True
    return tuple(table), tuple(idx), False


def _checked(tables, idxs):
    """``tables`` and ``idxs`` as the kernels take them (contiguous);
    refuses the rest."""
    if not 1 <= len(tables) <= MAX_TABLES or len(idxs) != len(tables):
        raise ValueError(f"K16 takes 1-{MAX_TABLES} tables and as many "
                         f"index vectors, not {len(tables)} and {len(idxs)}")
    dev, dtype = tables[0].device, tables[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K16 takes float32 or float64 tables, not {dtype}")
    n = idxs[0].shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: K17's sums hold fewer than 2^31")
    for t, i in zip(tables, idxs):
        if t.dim() != 2 or t.dtype != dtype or t.device != dev:
            raise ValueError(f"table: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, expected 2-D {dtype} on {dev}")
        if i.dim() != 1 or i.shape[0] != n or i.device != dev or \
                i.dtype != torch.int64:
            raise ValueError(f"indices: {i.dtype} {tuple(i.shape)} on "
                             f"{i.device}, expected int64 ({n},) on {dev}")
    return (tuple(t.contiguous() for t in tables),
            tuple(i.contiguous() for i in idxs))


def _apply(kernels, table, idx):
    tables, idxs, one = _pairs(table, idx)
    if kernels:
        tables, idxs = _checked(tables, idxs)
    out = _GatherRows.apply(kernels, len(tables), *tables, *idxs)
    return out[0] if one else tuple(out)


def gather_rows_plain(table, idx):
    """``gather_rows`` in torch ops on any device (``gather_plain``
    forward, ``row_sum_plain`` backward)."""
    return _apply(False, table, idx)


def gather_rows_kernels(table, idx):
    """``gather_rows`` through K16 and K17 on the tensors' device, whatever
    it is (the card; the tests' host build of the source on the CPU).
    Checks what the kernels take and refuses the rest."""
    return _apply(True, table, idx)


def gather_rows(table, idx):
    """``table[idx]`` for one table and its (R,) int64 indices, or for
    tuples of up to three of each (a tuple out), with a deterministic
    backward: K16 and K17 on a CUDA device (``gather_rows_kernels``),
    ``gather_rows_plain`` on the CPU.  A tensor on any other device is
    refused."""
    tables, _, _ = _pairs(table, idx)
    dev = tables[0].device
    if dev.type == "cpu":
        return gather_rows_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"no row-gather kernel for device {dev}")
    return gather_rows_kernels(table, idx)


gather_rows.launches = 0  # K16 launches (the kernels' route only)
gather_rows.backward_launches = 0  # K17 launches
