"""Phase 23 of ``chip_smoke.py`` alone (K14 and K15, the tape replay on the
card), the time split of a checkout's K14 and K15 by variants, or one
checkout's K14, K15 and direct step for turns with another.

Without arguments: builds the kernels' library (phase 2: ptxas's
registers and spills of each kernel) and runs
``chip_smoke.replay_pass_path``: K14's float32 radiance ``torch.equal`` to
the plain loop's and K15's float64 gradients within 1e-8 of the plain
loop's autograd on 2^17 rays of the final scene (K2b's tape and JAX's
golden tape) and of field5000 (K3t's tape); the direct and bucketed steps'
launches with the counters reset; K14 and K15 alone (CUDA graphs, median
of 5) and the plain loop's forward and backward; their bounds; the
whole-tape replay's graph nodes through the kernels and on the plain loop;
and the graphed replay, direct step and bucketed step through the kernels
in turns with the plain loop's graphs.  Prints the phase's log and K14's
and K15's entries of the kernels line (about a minute with the build).

With ``--split CHECKOUT``: builds variants of ``CHECKOUT``'s
``kernels/csrc/replay.cu`` with the first design's C interface (one
thread a ray in K14; K15's warps in ray order, a shared copy of the
tables), each patched here and nowhere else, and times each at 2^17
rays of the final scene on K2b's tape (each call in a CUDA graph, median
of 5): K14 and K15 as they are; K15 with the column sum left out (its
values folded into a sink); K15 with the re-shade reduced to the saved
values (the payload row gathered, no draw, recompute or scatter); K15 on
its inputs permuted by miss row, deepest first (the same kernel); K14
with the next row's tape entry, payload row and draw issued ahead of the
row's chain.  Prints each variant's registers and spills, the blocks an
SM holds by them, the deepest ray's rows and the warp-rows each order
sweeps.

With ``--turns CHECKOUT``: imports the package of ``CHECKOUT`` (a
directory holding ``first_raytracer_tpu_torch``, e.g. a parent unpacked
with ``git archive`` under ``out/``) and prints one JSON line of its K14
(with the scratch) and K15 at 2^17 rays of the final scene on K2b's tape
(each call in a CUDA graph, median of 5), the whole-tape replay's graph
nodes and the graphed direct step (s, median of 3 after a warm call).
Run in turns, parent and change:

    mkdir -p out/parent && git archive <parent> | tar -x -C out/parent
    python probes/replay_pass.py --split out/parent
    for t in out/parent . . out/parent; do
        python probes/replay_pass.py --turns $t; done
"""
import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_DIR = os.path.join(ROOT, "out", "replay_split")
RAYS = 1 << 17


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def graph_ms(torch, fn, repeats=5):
    """Median ms of one call of ``fn`` captured in a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_nodes(torch, fn):
    """Nodes of a CUDA graph of one call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return count.value


def host_s(torch, fn, repeats=3):
    """Median seconds of ``fn`` and what it queued, after a warm call."""
    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out)


def final_scene(torch, pkg_root):
    """The final scene, its camera rays and K2b's tape at 2^17 rays (the
    package at ``pkg_root``)."""
    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.kernels import megakernel as mk
    from first_raytracer_tpu_torch.kernels import record_mega as rm
    from first_raytracer_tpu_torch.render.camera import camera_rays
    from first_raytracer_tpu_torch.scene.builders import build_preset

    import first_raytracer_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(
            os.path.abspath(pkg_root)):
        raise SystemExit(f"imported {pkg.__file__}, not {pkg_root}'s")
    dev = torch.device("cuda")
    key = rng.base_key(0).to(dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    ids = torch.arange(RAYS, device=dev)
    o, d = camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    tape = rm.record_paths_mega(mk.pack_scene_mega(scene), cam, cfg, key,
                                num_rays=RAYS)
    return dict(scene=scene, cam=cam, cfg=cfg, key=key, ids=ids, o=o, d=d,
                tape=tape, dev=dev)


# --------------------------------------------------------------------------
# --split: the first design's variants, patched into a copy of its source.
# --------------------------------------------------------------------------

# K15 without the column sum: each lane folds its row's gradient into a
# sink that one impossible test keeps alive.
_NO_SUM = ("""    // The lanes of this row's payload row, summed by the lowest of them in
    // lane order, a column at a time through the warp's stage.
    const unsigned peers = __match_any_sync(kFullMask, key);
    const bool lead = on && lane == __ffs(static_cast<int>(peers)) - 1;
    double* dst = table + (on ? row_offset(key, a.ns) : 0);
    const int ncols = sphere ? kSphereCols : kTriCols;
#pragma unroll
    for (int c = 0; c < kTriCols; ++c) {
      stage[lane] = on && c < ncols ? static_cast<double>(
                                          grad_col(gr, sphere, c))
                                    : 0.0;
      __syncwarp();
      if (lead && c < ncols) {
        double total = 0.0;
        for (unsigned m = peers; m != 0; m &= m - 1)
          total += stage[__ffs(static_cast<int>(m)) - 1];
        if (total != 0.0) atomicAdd(dst + c, total);
      }
      __syncwarp();
    }
  }
""", """    if (on) {
      double folded = 0.0;
#pragma unroll
      for (int c = 0; c < kTriCols; ++c)
        folded += static_cast<double>(grad_col(gr, sphere, c));
      sink += folded + static_cast<double>(key);
    }
  }
  if (sink == 1234.5) atomicAdd(sum, sink);
""")
_SINK = ("  for (int row = deepest - 1; row >= 0; --row) {\n",
         "  double sink = 0.0;\n"
         "  for (int row = deepest - 1; row >= 0; --row) {\n")

# K15 with the re-shade reduced to the saved values: the payload row is
# gathered (the adjoint reads it), the hit point and the scattered
# direction are the next row's saved origin and direction.
_SAVED = ("""      Bounce<T> b;
      shade_row(a, rec, o, d, k0, k1, id, row, b);
""", """      Bounce<T> b;
      b.w = gather_row(a, rec);
      const T* sn = save_row(a, row + 1, i);
      b.h.t = T(1);
      b.h.p = state3(sn, 0);
      b.h.n = d;
      b.ball = V3{0.25f, 0.25f, 0.25f};
      b.s.ok = true;
      b.s.alt = b.s.outside = b.s.reflected = false;
      b.s.dir = state3(sn, 1);
      b.s.att = Vec3<T>{T(0.5), T(0.5), T(0.5)};
""")

# K14 with the next row's tape entry (two rows ahead), payload row, draw
# and ball issued before the row's recompute and scatter.
_HOIST = ("""  int end = -1;
  for (int row = 0; row < a.rows; ++row) {
    if (a.save != nullptr) {
      T* s = save_row(a, row, i);
      store3(s, 0, o);
      store3(s, 1, d);
      store3(s, 2, tp);
    }
    const int rec = __ldg(a.tape + row * a.stride + i);
    Bounce<T> b;
    if (!shade_row(a, rec, o, d, k0, k1, id, row, b)) {
      rad = sky(tp, d);
      end = row;
      break;
    }
    if (!b.s.ok || row >= a.max_depth) break;
    tp = mul(tp, b.s.att);
    o = b.h.p;
    d = b.s.dir;
  }
""", """  int end = -1;
  int rec = a.rows > 0 ? __ldg(a.tape + i) : -1;
  int rec_next = a.rows > 1 ? __ldg(a.tape + a.stride + i) : -1;
  Row<T> w = gather_row(a, rec);
  float u[4];
  frt::draws4(k0, k1, id, 1u, u);
  V3 ball = ball_sample(u);
  for (int row = 0; row < a.rows; ++row) {
    if (a.save != nullptr) {
      T* s = save_row(a, row, i);
      store3(s, 0, o);
      store3(s, 1, d);
      store3(s, 2, tp);
    }
    const int rec_after =
        row + 2 < a.rows ? __ldg(a.tape + (row + 2) * a.stride + i) : -1;
    const Row<T> w_next = gather_row(a, rec_next);
    float u_next[4];
    frt::draws4(k0, k1, id, static_cast<uint32_t>(row + 2), u_next);
    const V3 ball_next = ball_sample(u_next);
    bool miss = rec < 0;
    Surface<T> h;
    if (!miss) {
      h = recompute(w.g, o, d, a.t_min);
      miss = !(h.t < Lim<T>::big);
    }
    if (miss) {
      rad = sky(tp, d);
      end = row;
      break;
    }
    const Scattered<T> s = scatter(w.m, d, h.p, h.n, ball, u[3]);
    if (!s.ok || row >= a.max_depth) break;
    tp = mul(tp, s.att);
    o = h.p;
    d = s.dir;
    rec = rec_next;
    rec_next = rec_after;
    w = w_next;
    ball = ball_next;
    u[3] = u_next[3];
  }
""")

SPLIT_VARIANTS = {
    "first design": [],
    "K15 without the column sum": [_SINK, _NO_SUM],
    "K15 re-shade from the saved values": [_SAVED],
    "K14 next row hoisted": [_HOIST],
}


# Variants of this checkout's design (``--variants``), with its C interface.
_GLOBAL_SUM = ("  double* hot = size >= kHotPeers ? hot_row(sh, w, key) "
               ": nullptr;", "  double* hot = nullptr;")
_FOLD = """    double folded[kFields];
    row_fields(%s, folded);
    double total = 0.0;
#pragma unroll
    for (int q = 0; q < kFields; ++q) total += folded[q];
    if (key >= 0 && total == 1234.5) atomicAdd(sum, 1.0);
"""
_NO_ADD = [("    add_row(sh, w, sum, a.ns, key, sphere, gr, lane);\n",
            _FOLD % "gr"),
           ("    add_row(sh, w, sum, a.ns, key, sphere, mine, lane);\n",
            _FOLD % "mine")]
_FROM_SAVED = ("      shade_row(a, x, o, d, b);\n", """      b.w = x.w;
      const T* sn = save_row(a, row + 1, i);
      b.h.t = T(1);
      b.h.p = load3(sn, 0);
      b.h.n = d;
      b.ball = x.ball;
      b.s.ok = true;
      b.s.alt = b.s.outside = b.s.reflected = false;
      b.s.dir = load3(sn, 1);
      b.s.att = Vec3<T>{T(0.5), T(0.5), T(0.5)};
""")
_TWO_BLOCKS = ("__launch_bounds__(kThreads)\n    replay_backward_kernel(",
               "__launch_bounds__(kThreads, 2)\n    replay_backward_kernel(")
_INDEX_ORDER = [("  const int rays = sh.rays, deep = sh.deep;",
                 "  const int rays = static_cast<int>(a.n), deep = 0;"),
                ("place < rays ? __ldg(order + place) : -1",
                 "place < rays ? place : -1")]


def _deep_rows(n):
    return ("constexpr int kDeepRows = 12;", f"constexpr int kDeepRows = {n};")


# K14's: its draw issued a row ahead too; its row loop with nothing issued
# ahead; capped at 64 registers (four blocks an SM, one wave at 2^17
# rays); without its histogram.
_K14_DRAW_AHEAD = [
    ("      Ahead<T> x;\n      x.rec = rec;\n      x.w = w;\n"
     "      float u[4];\n"
     "      frt::draws4(k0, k1, id, static_cast<uint32_t>(row + 1), u);\n"
     "      x.ball = ball_sample(u);\n      x.coin = u[3];\n",
     "      Ahead<T> x;\n      x.rec = rec;\n      x.w = w;\n"
     "      x.ball = ball;\n      x.coin = coin;\n      {\n"
     "        float u[4];\n"
     "        frt::draws4(k0, k1, id, static_cast<uint32_t>(row + 2), u);\n"
     "        ball = ball_sample(u);\n        coin = u[3];\n      }\n"),
    ("    Row<T> w = gather_row(a, rec);\n",
     "    Row<T> w = gather_row(a, rec);\n    V3 ball;\n    float coin;\n"
     "    {\n      float u[4];\n      frt::draws4(k0, k1, id, 1u, u);\n"
     "      ball = ball_sample(u);\n      coin = u[3];\n    }\n")]
_K14_IN_ROW = [
    ("      const int rec_after = tape_at(a, row + 2, i);\n"
     "      const Row<T> w_next = gather_row(a, rec_next);\n", ""),
    ("      x.rec = rec;\n      x.w = w;\n",
     "      x.rec = tape_at(a, row, i);\n      x.w = gather_row(a, x.rec);\n"),
    ("      rec = rec_next;\n      rec_next = rec_after;\n      w = w_next;\n",
     "")]
_K14_64 = ("__launch_bounds__(kThreads)\n    replay_forward_kernel(",
           "__launch_bounds__(kThreads, 4)\n    replay_forward_kernel(")
_K14_NO_HIST = ("  if (hist != nullptr) {\n    // The rays by miss row",
                "  if (false) {\n    // The rays by miss row")

DESIGN_VARIANTS = {
    "as shipped": [],
    "K15 sum into the global rows only": [_GLOBAL_SUM],
    "K15 without the sum": _NO_ADD,
    "K15 packed rows re-shaded from the saved values": [_FROM_SAVED],
    "K15 at two blocks an SM": [_TWO_BLOCKS],
    "K15 in ray order, no deep warps": _INDEX_ORDER,
    "K15 no deep warps": [_deep_rows(100000)],
    "K15 deep warps from 8 rows": [_deep_rows(8)],
    "K15 deep warps from 16 rows": [_deep_rows(16)],
    "K15 deep warps from 24 rows": [_deep_rows(24)],
    "K14 the draw a row ahead too": _K14_DRAW_AHEAD,
    "K14 nothing issued ahead": _K14_IN_ROW,
    "K14 at 64 registers": [_K14_64],
    "K14 without its histogram": [_K14_NO_HIST],
}


def patched(src, patches):
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"patch target found {src.count(old)} times: "
                             f"{old[:80]!r}")
        src = src.replace(old, new)
    return src


def build_variants(checkout, variants, tag):
    """Each of ``variants`` of ``checkout``'s replay.cu built by nvcc into
    its own library under ``out/replay_split`` (one nvcc each, all at
    once).  Returns {variant: (path, ptxas log)}."""
    from first_raytracer_tpu_torch.kernels import build as kb
    from first_raytracer_tpu_torch.kernels import megakernel as mk

    csrc = os.path.join(os.path.abspath(checkout), "first_raytracer_tpu_torch",
                        "kernels", "csrc")
    with open(os.path.join(csrc, "replay.cu")) as f:
        src = f.read()
    os.makedirs(SPLIT_DIR, exist_ok=True)
    procs = {}
    for i, (name, patches) in enumerate(variants.items()):
        cu = os.path.join(SPLIT_DIR, f"{tag}{i}.cu")
        with open(cu, "w") as f:
            f.write(patched(src, patches))
        lib = os.path.join(SPLIT_DIR, f"lib{tag}{i}.so")
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, *mk.NVCC_EXTRA_FLAGS, "-I", csrc,
               "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        out[name] = (lib, log)
    return out


def first_design(lib):
    """``lib``'s K14 and K15 entry points with the first design's C
    interface."""
    ptr, i32, i64, f64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_double)
    head = [ptr, i64, ptr, i64]
    tail = [ptr] * 3 + [i64, i32, i32, f64, i64]
    fwd, bwd = lib.frt_replay_forward_f32, lib.frt_replay_backward_f32
    fwd.argtypes = head + [ptr] * 2 + tail + [ptr] * 4
    bwd.argtypes = head + tail + [ptr] * 7
    fwd.restype = bwd.restype = i32
    return fwd, bwd


def ptxas(log):
    """(kernel, registers, shared bytes, spill line) of each entry."""
    out, entry, smem, spill = [], None, 0, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry, smem, spill = line.split("'")[1], 0, ""
        elif "spill" in line and entry:
            spill = line.strip()
        elif "registers" in line and entry:
            regs = int(line.split("Used", 1)[1].split("registers")[0])
            m = re.search(r"(\d+) bytes smem", line)
            smem = int(m.group(1)) if m else 0
            name = next((k for k in ("replay_forward", "replay_backward",
                                     "replay_order", "round_kernel")
                         if k in entry), entry)
            kind = "double" if "IdE" in entry else "float"
            out.append((f"{name}<{kind}>", regs, smem, spill))
            entry = None
    return out


def blocks_an_sm(regs, dyn_smem, threads=256):
    """Blocks of ``threads`` an H100 SM holds at ``regs`` registers a
    thread (allocated 8 at a time) and ``dyn_smem`` bytes of shared memory
    a block (1 KB reserved a block of the SM's 228 KB)."""
    by_regs = 65536 // (((regs + 7) // 8) * 8 * threads)
    by_smem = (228 * 1024) // (dyn_smem + 1024)
    return min(by_regs, by_smem, 2048 // threads)


def warp_rows(end):
    """Warp-rows a lockstep sweep of 32 consecutive rays takes (each warp
    from its deepest ray's miss row) over ``end``, and the lane-rows of
    real work."""
    import torch
    e = end.clamp(min=0).long()
    pad = (-e.numel()) % 32
    w = torch.cat([e, e.new_zeros(pad)]).view(-1, 32)
    return int(w.max(dim=1).values.sum()), int(e.sum())


def split(checkout):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.diff import replay_pass as rp

    if not torch.cuda.is_available():
        raise SystemExit("replay_pass --split: no CUDA device")
    built = build_variants(checkout, SPLIT_VARIANTS, "first")
    c = final_scene(torch, checkout)
    scene, cfg, dev = c["scene"], c["cfg"], c["dev"]
    sph = rp._payload_tables(scene)[0].detach()
    key = rng.device_key(c["key"], dev)
    ns, n = sph.shape[0], RAYS
    rows = c["tape"].shape[0]
    cols = ns * 15
    radiance = torch.empty((n, 3), device=dev)
    save = torch.empty((rows, n, 9), device=dev)
    end = torch.empty((n,), dtype=torch.int32, device=dev)
    total = torch.empty((cols,), dtype=torch.float64, device=dev)
    g_sph = torch.empty_like(sph)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def forward(fwd, tape, o, d, ids, grads=True):
        err = fwd(sph.data_ptr(), ns, None, 0, o.data_ptr(), d.data_ptr(),
                  ids.data_ptr(), key.data_ptr(), tape.data_ptr(),
                  tape.stride(0), rows, cfg.max_depth, cfg.t_min, n,
                  radiance.data_ptr(), save.data_ptr() if grads else None,
                  end.data_ptr() if grads else None, stream())
        assert err == 0, err

    def backward(bwd, tape, ids, sv, en, grad):
        err = bwd(sph.data_ptr(), ns, None, 0, ids.data_ptr(),
                  key.data_ptr(), tape.data_ptr(), tape.stride(0), rows,
                  cfg.max_depth, cfg.t_min, n, sv.data_ptr(), en.data_ptr(),
                  grad.data_ptr(), total.data_ptr(), g_sph.data_ptr(), None,
                  stream())
        assert err == 0, err

    o, d, ids, tape = c["o"], c["d"], c["ids"], c["tape"]
    libs = {name: first_design(ctypes.CDLL(path))
            for name, (path, _) in built.items()}
    base_fwd, base_bwd = libs["first design"]
    forward(base_fwd, tape, o, d, ids)
    grad = (2.0 * radiance / radiance.numel()).contiguous()
    end0, save0 = end.clone(), save.clone()
    ms = {}
    for name, (fwd, bwd) in libs.items():
        if name != "K14 next row hoisted":
            ms[f"K15, {name}"] = graph_ms(torch, lambda bwd=bwd: backward(
                bwd, tape, ids, save0, end0, grad))
        if name in ("first design", "K14 next row hoisted"):
            ms[f"K14, {name}"] = graph_ms(torch, lambda fwd=fwd: forward(
                fwd, tape, o, d, ids))
            ms[f"K14 without the scratch, {name}"] = graph_ms(
                torch, lambda fwd=fwd: forward(fwd, tape, o, d, ids, False))
            forward(fwd, tape, o, d, ids)
            if not torch.equal(end, end0):
                raise SystemExit(f"{name}: K14's end rows differ")
    forward(base_fwd, tape, o, d, ids)
    backward(base_bwd, tape, ids, save0, end0, grad)
    want = g_sph.clone()
    # The same K15 on its inputs permuted by miss row, deepest first.
    perm = torch.argsort(end0.long(), descending=True, stable=True)
    sorted_in = dict(tape=tape[:, perm].contiguous(), ids=ids[perm],
                     sv=save0[:, perm].contiguous(), en=end0[perm],
                     grad=grad[perm].contiguous())
    ms["K15, first design, rays sorted by miss row"] = graph_ms(
        torch, lambda: backward(base_bwd, **sorted_in))
    backward(base_bwd, **sorted_in)
    sorted_err = float(((g_sph.double() - want.double()).norm()
                        / want.double().norm()))
    swept, work = warp_rows(end0)
    swept_sorted, _ = warp_rows(end0[perm])
    hist = torch.bincount(end0[end0 >= 0].long(), minlength=rows)
    regs = {}
    for name, (_, log) in built.items():
        for kernel, r, smem, spill in ptxas(log):
            dyn = (256 + cols) * 8 if kernel.startswith(
                "replay_backward") else 0
            regs[f"{name}: {kernel}"] = dict(
                registers=r, spill=spill,
                blocks_an_sm=blocks_an_sm(r, smem + dyn))
    print(json.dumps({
        "checkout": checkout, "card": card(), "ms": ms,
        "sorted_grad_rel_err": sorted_err,
        "deepest_rows": int(end0.max()), "end_histogram": hist.tolist(),
        "warp_rows_ray_order": swept, "warp_rows_sorted": swept_sorted,
        "lane_rows_of_work": work, "ptxas": regs}), flush=True)


def variants():
    """This checkout's K15 by ``DESIGN_VARIANTS`` and K14 on the tape cut
    to its first 11 and 26 rows (the depth cap 10 and 25)."""
    sys.path.insert(0, ROOT)
    import torch

    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.diff import replay_pass as rp
    from first_raytracer_tpu_torch.kernels import megakernel as mk

    built = build_variants(ROOT, DESIGN_VARIANTS, "design")
    c = final_scene(torch, ROOT)
    scene, cfg, dev, tape = c["scene"], c["cfg"], c["dev"], c["tape"]
    sph = rp._payload_tables(scene)[0].detach()
    k = rng.device_key(c["key"], dev)
    fwd_args = (sph, None, c["o"], c["d"], c["ids"], k, tape, cfg.max_depth,
                cfg.t_min)
    out = rp.launch_forward(*fwd_args)
    g_rad = (2.0 * out[0] / out[0].numel()).contiguous()
    want = rp.launch_backward(sph, None, c["ids"], k, tape, cfg.max_depth,
                              cfg.t_min, *out[1:], g_rad)[0].clone()
    ms, err, regs, k14_ms = {}, {}, {}, {}
    saved = mk.launch_entry
    try:
        for name, (path, log) in built.items():
            lib = mk.bind_replay(ctypes.CDLL(path))

            def entry(dev_, fn, *args, lib=lib):
                e = getattr(lib, fn)(*args,
                                     torch.cuda.current_stream().cuda_stream)
                if e != 0:
                    raise RuntimeError(f"{fn} failed ({e})")
            mk.launch_entry = entry

            def k15():
                return rp.launch_backward(sph, None, c["ids"], k, tape,
                                          cfg.max_depth, cfg.t_min,
                                          *out[1:], g_rad)
            ms[name] = graph_ms(torch, k15)
            k14_ms[name] = graph_ms(torch, lambda: rp.launch_forward(
                *fwd_args))
            if not torch.equal(rp.launch_forward(*fwd_args)[0], out[0]):
                raise SystemExit(f"{name}: K14's radiance differs")
            got = k15()[0]
            err[name] = float((got.double() - want.double()).norm()
                              / want.double().norm())
            blocks = ctypes.c_int(0)
            lib.frt_replay_blocks(1, 0, ctypes.byref(blocks))
            regs[name] = [dict(kernel=kn, registers=r, spill=sp)
                          for kn, r, _, sp in ptxas(log)
                          if kn.startswith(("replay_backward",
                                            "replay_forward"))] + [
                dict(resident_blocks=blocks.value)]
    finally:
        mk.launch_entry = saved
    cut = {}
    for rows in (11, 26, tape.shape[0]):
        args = (sph, None, c["o"], c["d"], c["ids"], k, tape[:rows],
                min(cfg.max_depth, rows - 1), cfg.t_min)
        cut[rows] = [graph_ms(torch, lambda a=args: rp.launch_forward(*a)),
                     graph_ms(torch, lambda a=args: rp.launch_forward(
                         *a, grads=False))]
    end, hist = out[2], out[3]
    cursor = torch.zeros_like(hist)
    perm = torch.empty_like(end)

    def order():
        cursor.zero_()
        mk.launch_entry(dev, "frt_replay_order", end.data_ptr(),
                        hist.data_ptr(), hist.shape[0], end.shape[0],
                        cursor.data_ptr(), perm.data_ptr())
    order_ms = graph_ms(torch, order)
    print(json.dumps({"card": card(), "k15_ms": ms, "k15_rel_err": err,
                      "k14_ms": k14_ms, "ptxas": regs,
                      "k14_ms_by_rows": cut,
                      "order_ms": order_ms}), flush=True)


# --------------------------------------------------------------------------
# --turns: one checkout's K14, K15, replay nodes and direct step.
# --------------------------------------------------------------------------

def turns(checkout):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.diff import grad as dg
    from first_raytracer_tpu_torch.diff import replay_pass as rp

    c = final_scene(torch, checkout)
    scene, cam, cfg, key, ids = (c[k] for k in ("scene", "cam", "cfg", "key",
                                                "ids"))
    sph, tri = (t if t is None else t.detach()
                for t in rp._payload_tables(scene))
    k = rng.device_key(key, c["dev"])
    fwd_args = (sph, tri, c["o"], c["d"], ids, k, c["tape"], cfg.max_depth,
                cfg.t_min)
    out = rp.launch_forward(*fwd_args)
    g_rad = (2.0 * out[0] / out[0].numel()).contiguous()
    bwd_head = (sph, tri, ids, k, c["tape"], cfg.max_depth, cfg.t_min)
    ms = {"K14": graph_ms(torch, lambda: rp.launch_forward(*fwd_args)),
          "K14 without the scratch": graph_ms(
              torch, lambda: rp.launch_forward(*fwd_args, grads=False)),
          "K15": graph_ms(torch, lambda: rp.launch_backward(
              *bwd_head, *out[1:], g_rad))}
    target = torch.zeros((RAYS, 3), device=c["dev"])
    params, _ = dg.split_params(scene)
    nodes = graph_nodes(torch, lambda: dg.tape_loss_and_grads(
        params, scene, cam, key, ids, target, c["tape"], cfg=cfg))
    step = host_s(torch, lambda: dg.render_loss_and_grads(
        params, scene, cam, cfg, key, ids, target))
    print(json.dumps({"checkout": checkout, "card": card(), "ms": ms,
                      "replay_nodes": nodes, "direct_step_s": step}),
          flush=True)


def phase23():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from first_raytracer_tpu_torch.core import rng

    if not torch.cuda.is_available():
        raise SystemExit("replay_pass: no CUDA device")
    line = chip_smoke.card_line()
    chip_smoke.log(line)
    chip_smoke.build()
    entries = chip_smoke.replay_pass_path(torch.device("cuda"),
                                          rng.base_key(0), line)
    print(json.dumps({"kernels": entries}), flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", metavar="CHECKOUT")
    ap.add_argument("--turns", metavar="CHECKOUT")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if args.variants:
        variants()
    elif args.split:
        split(args.split)
    elif args.turns:
        turns(args.turns)
    else:
        return phase23()
    return 0


if __name__ == "__main__":
    sys.exit(main())
