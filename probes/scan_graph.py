"""The differentiable scan (``method="scan"``) of ``chip_smoke.py`` phase 20
alone, at one or more ray counts.

Builds the kernels' library (phase 2), records the final scene's direct
step at each ray count (``render_loss_and_grads``, the replay's graph:
the yardstick of ``test_replay_matches_scan``'s bounds), then runs
``chip_smoke.scan_path`` on the same rays: the scan's graph captured
(warm-up and capture seconds, pool bytes, peak memory), a replay's K7,
K8 and K11 launches (K11 given the liveness mask), the graph against the
eager body (the loss within one float32 ulp, gradients within
``rtol=1e-6``), against the replay's step, and the eager and graphed scan
in turns with the peak memory of each.  Prints the phase's log and one
JSON line of the readings a ray count.  The seed, zero target and every
``DIFF_FIELDS`` leaf are phase 20's.

``--profile``: at each ray count also the eager body once under
``torch.profiler`` (the card's kernels by total device time, the top
``--top``), the nodes of its CUDA graph (``cuGraphGetNodes``), and the
graphed scan in turns with the same scan whose closest hit takes five
arguments (K11 sweeping every ray, dead or alive): seconds in turns
(masked, five, five, masked) after a capture each, in a cache that keeps
both graphs, and whether the two routes' results are ``torch.equal``.

``--rows``: then ``chip_smoke.py`` phase 24 (K16 and K17 on the scan's
real trips at 2^17 rays against their plain versions, timed beside their
bounds and the library calls), its launches those of the last ray count's
scan.

``--turns CHECKOUT``: imports ``CHECKOUT``'s ``chip_smoke.py`` and
package (a directory holding both, e.g. a parent unpacked with ``git
archive`` under ``out/``), builds its library and prints one JSON line:
K16's and K17's ms on the final scene's scan trips at 2^17 rays (trips 0
and 1 in float32, trip 0 in float64 and its first 2^14 rays,
triangle-mesh's trip 0; phase 24's
``rows_times``, each call in a CUDA graph of 20, median of 5) beside the
plain versions and library calls, K16's and K17's graph nodes a call
(``cuGraphGetNodes``), and the graphed scan at 2^14 and 2^17 rays (s,
median of 3 after its capture) with its graph's nodes.  Run parent,
change, change, parent in one call.

``--split CHECKOUT``: copies of ``CHECKOUT``'s ``gather_rows.cu`` with
parts of K17 cut (``SPLITS``: for the design of two passes, the global
atomics, the exponent pass, both passes but the conversion; for the
single launch, its flush, its step 2's gradient reads, the conversion by
the last block instead of by ticket, blocks of 512), one nvcc each, all at
once, each timed through the checkout's ``launch_row_sum`` at the final
scene's first two trips and triangle-mesh's first trip at 2^17 rays (20
calls a graph, median of 7, two rounds in alternating order); the
uncut copy is held bit-equal to ``row_sum_plain``, and so is each variant
that keeps the function; ``--only VARIANT`` (repeated) builds those
alone.

    python probes/scan_graph.py --rays 16384 131072
    python probes/scan_graph.py --rays 16384 --profile
    python probes/scan_graph.py --rays 16384 131072 --profile --rows
    mkdir -p out/parent && git archive <parent> | tar -x -C out/parent
    for t in out/parent . . out/parent; do
        python probes/scan_graph.py --turns $t; done
    python probes/scan_graph.py --split out/parent --split .
"""
import argparse
import ctypes
import functools
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --split: K17's parts cut, by string edits of a checkout's gather_rows.cu
# (a variant whose edits do not apply to the checkout is skipped), and
# whether the cut copy keeps the function (then it is held bit-equal).
_LEADER = "    if (ray && tree.leader) {"
_STEP3 = ("  if (t == 0) *head = static_cast<long long>(atomicAdd(q.count + 4, "
          "1ull));\n  arrive_and_wait(q, q.count + 3, taken);")
SPLITS = {
    # The earlier design: three kernels and a memset.
    "two passes: as built": (
        [("row_exponent_kernel<T><<<", "row_exponent_kernel<T><<<")], True),
    "two passes: no global atomics": (
        [("row_exponent_kernel<T><<<", "row_exponent_kernel<T><<<"),
         (_LEADER, "    if (ray && tree.leader && a.n < 0) {")], False),
    "two passes: no exponent pass": (
        [("    row_exponent_kernel<T><<<grid, kThreads, 0, st>>>(a);\n",
          "")], False),
    "two passes: the conversion alone": (
        [("    row_exponent_kernel<T><<<grid, kThreads, 0, st>>>(a);\n",
          ""),
         ("    row_accumulate_kernel<T><<<grid, kThreads, 0, st>>>(a);\n",
          "")], False),
    # The single launch.
    "one launch: as built": ([("int frt_row_sum_shared", "int frt_row_sum_shared")],
                             True),
    "one launch: no global flush": (
        [("      if (e) atomicMax(q.meta + 2 * j, e);",
          "      if (e && q.chunks < 0) atomicMax(q.meta + 2 * j, e);"),
         ("            if (hi) atomicAdd(q.acc + 2 * j,",
          "            if (hi && q.chunks < 0) atomicAdd(q.acc + 2 * j,"),
         ("            if (lo) atomicAdd(q.acc + 2 * j + 1, lo);",
          "            if (lo && q.chunks < 0) atomicAdd(q.acc + 2 * j + 1, "
          "lo);")],
        False),
    "one launch: step 2 reads no gradient": (
        [("      load_chunk(g, c0, s.cols, ray, x);\n"
          "#pragma unroll\n"
          "      for (int u = 0; u < kColChunk; ++u) {\n"
          "        const int c = c0 + u;\n"
          "        if (c >= s.cols) break;  // the same on every lane\n"
          "        // q in",
          "#pragma unroll\n"
          "      for (int u = 0; u < kColChunk; ++u)\n"
          "        x[u] = ray ? T(1 + (i & 7)) : T(0);\n"
          "#pragma unroll\n"
          "      for (int u = 0; u < kColChunk; ++u) {\n"
          "        const int c = c0 + u;\n"
          "        if (c >= s.cols) break;  // the same on every lane\n"
          "        // q in")],
        False),
    "one launch: step 2 adds nothing to its table": (
        [("        if (ray && (hot.lead || (tree.leader && !hot.in))) {\n"
          "          if (kShared) {",
          "        if (ray && (hot.lead || (tree.leader && !hot.in)) &&\n"
          "            q.chunks < 0) {\n          if (kShared) {")],
        False),
    "one launch: no largest group apart": (
        [("    const Hot hot = hot_group(peers);",
          "    const Hot hot{false, false};")], True),
    "one launch: nothing but the launch": (
        [("  // Step 1: the exponents and flags.\n",
          "  if (q.chunks > 0) return;\n")], False),
    "one launch: step 1 alone": (
        [("  // Step 2's first ticket, then the wait for every range of step "
          "1.\n", "  if (q.chunks > 0) return;\n")], False),
    "one launch: no conversion": (
        [("  // Step 3: the entries back to the tables' type, in tiles by "
          "ticket.\n", "  if (q.chunks > 0) return;\n")], False),
    "one launch: no waits": (
        [("    while (peek(count) < static_cast<unsigned long long>(q.chunks))"
          "\n      __nanosleep(64);\n", "")], False),
    "one launch: columns one at a time": (
        [("constexpr int kColChunk = 4;", "constexpr int kColChunk = 1;")],
        True),
    "one launch: chunks of 8 columns": (
        [("constexpr int kColChunk = 4;", "constexpr int kColChunk = 8;")],
        True),
    "one launch: the last block converts": (
        [(_STEP3,
          "  __threadfence();\n  __syncthreads();\n  if (t == 0) {\n"
          "    const unsigned long long before = atomicAdd(q.count + 3, "
          "static_cast<unsigned long long>(taken));\n"
          "    *head = taken && before + taken == static_cast<unsigned long "
          "long>(q.chunks) ? 0 : (1ll << 62);\n    __threadfence();\n  }\n"
          "  __syncthreads();"),
         ("    if (t == 0) next = atomicAdd(q.count + 4, 1ull);",
          "    if (t == 0) next = tile + 1;")], True),
    "one launch: blocks of 512": (
        [("constexpr int kSumThreads = 1024;",
          "constexpr int kSumThreads = 512;")], True),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, nargs="+", default=[1 << 17])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--turns", metavar="CHECKOUT")
    ap.add_argument("--split", metavar="CHECKOUT", action="append")
    ap.add_argument("--only", metavar="VARIANT", action="append",
                    help="--split: these variants of SPLITS alone")
    args = ap.parse_args()
    if args.turns:
        return turns(args.turns)
    if args.split:
        return split(args.split, args.only)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        raise SystemExit("probes/scan_graph.py: no CUDA device")
    card = cs.card_line()
    cs.log(card)
    cs.build()
    dev = torch.device("cuda")
    key = cs.rng.base_key(0)
    scene, cam, cfg = cs.build_preset("random-spheres", device=dev)
    params, _ = cs.dg.split_params(scene)
    for rays in args.rays:
        ids = torch.arange(rays, device=dev)
        target = torch.zeros((rays, 3), device=dev)
        step = cs.dg.render_loss_and_grads(params, scene, cam, cfg, key,
                                           ids, target)
        scan = cs.scan_path(params, scene, cam, cfg, key, ids, target, step,
                            card)
        print(json.dumps(dict(scan, card=card)), flush=True)
        cs.dg.SCAN_GRAPHS.clear()
        torch.cuda.empty_cache()
        if args.profile:
            profile(cs, torch, params, scene, cam, cfg, key, ids, target,
                    args.top, card)
    if args.rows:
        rows = cs.gather_rows_path(dev, key, card, scan)
        print(json.dumps({"kernels": rows, "card": card}), flush=True)


def profile(cs, torch, params, scene, cam, cfg, key, ids, target, top,
            card):
    """The eager scan's kernels by device time, its graph's nodes, and the
    graphed scan with and without the liveness mask in turns."""
    dkey = key.to(ids.device)  # a capture copies nothing from the host

    def eager():
        return cs.dg.scan_loss_and_grads(
            params, scene, cam, dkey, ids, target, None, cfg=cfg,
            intersect_fn=cs.default_intersect)

    eager()
    rows, total = cs.scan_profile(eager, card, top)
    nodes = cs.graph_nodes(eager)
    cs.log(f"  the scan's graph: {nodes} nodes")

    fns = {
        "masked": lambda: cs.dg.render_loss_and_grads(
            params, scene, cam, cfg, key, ids, target, method="scan"),
        "five arguments": lambda: cs.dg.render_loss_and_grads(
            params, scene, cam, cfg, key, ids, target,
            intersect_fn=cs.five_arguments,
            method="scan", graphed=True),
    }
    kept, cs.dg.SCAN_GRAPHS = cs.dg.SCAN_GRAPHS, cs.dg.GraphCache(2)
    outs = {k: f() for k, f in fns.items()}
    (loss_m, grads_m), (loss_f, grads_f) = outs.values()
    same = torch.equal(loss_m, loss_f) and all(
        torch.equal(g, grads_f[k]) for k, g in grads_m.items())
    ulps = abs(float(loss_m) - float(loss_f)) / float(
        cs.np.spacing(cs.np.float32(abs(float(loss_f)))))
    spread = {k: [float(((g - grads_f[k]).abs() / (1e-6 * grads_f[k].abs())
                         ).nan_to_num(0.0).max()),
                  float((g - grads_f[k]).double().norm()
                        / grads_f[k].double().norm().clamp_min(1e-300))]
              for k, g in grads_m.items() if g.numel()}
    cs.log(f"  the masked scan against the five-argument one: loss "
           f"{float(loss_m):.9g} vs {float(loss_f):.9g} ({ulps:g} ulps); "
           f"per field the largest |a - b| / (1e-6 |b|) and the relative L2 "
           f"difference {spread}; finite "
           f"{all(bool(torch.isfinite(g).all()) for g in grads_m.values())}")
    times = {k: [] for k in fns}
    for k in ("masked", "five arguments", "five arguments", "masked"):
        times[k].append(cs.host_s(fns[k])[0])
    cs.log(f"  the graphed scan with and without the liveness mask, in "
           f"turns: " + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                                  f" s" for k, v in times.items())
           + f"; results torch.equal {same}; on {card}")
    print(json.dumps({"rays": int(ids.shape[0]), "nodes": nodes,
                      "device_ms": total,
                      "top": [list(r) for r in rows[:top]],
                      "mask_turns": times, "mask_equal": same,
                      "mask_loss_ulps": ulps, "mask_spread": spread,
                      "card": card}), flush=True)
    cs.dg.SCAN_GRAPHS = kept
    torch.cuda.empty_cache()


def _checkout_smoke(checkout):
    """``checkout``'s own chip_smoke module (and through it its package)."""
    sys.path.insert(0, os.path.abspath(checkout))
    import chip_smoke as cs
    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(checkout)):
        raise SystemExit(f"imported {cs.__file__}, not {checkout}'s")
    if not cs.torch.cuda.is_available():
        raise SystemExit("probes/scan_graph.py: no CUDA device")
    return cs


def _trip_sets(cs, dev, key):
    """{label: (tables, indices, gradients)} of the final scene's scan at
    2^17 rays (trips 0 and 1, trip 0 in float64) and triangle-mesh's trip
    0, from ``recorded_trips``."""
    torch = cs.torch
    ids = torch.arange(1 << 17, device=dev)
    sets = {}
    for preset, picks in (("random-spheres", (0, 1)), ("triangle-mesh", (0,))):
        scene, cam, cfg = cs.build_preset(preset, device=dev)
        params, _ = cs.dg.split_params(scene)
        trips = cs.recorded_trips(params, scene, cam, cfg, key, ids)
        for k in picks:
            sets[f"{preset} float32 trip {k}"] = trips[k]
        if preset == "random-spheres":
            ts, i, gs = trips[0]
            sets[f"{preset} float64 trip 0"] = (
                tuple(t.double() for t in ts), i,
                tuple(g.double() for g in gs))
        del trips
    return sets


def turns(checkout):
    cs = _checkout_smoke(checkout)
    torch, gr = cs.torch, cs.gr
    card = cs.card_line()
    cs.log(f"{checkout}: {card}")
    cs.build()
    dev = torch.device("cuda")
    key = cs.rng.base_key(0).to(dev)
    out = {"checkout": checkout, "card": card, "rows_ms": {}, "nodes": {}}
    sets = _trip_sets(cs, dev, key)
    # The first trip's first 2^14 rays: the launches at the scan's smaller
    # size.
    tables, idxs, grads = sets["random-spheres float32 trip 0"]
    sets["random-spheres float32 trip 0, its first 2^14 rays"] = (
        tables, tuple(i[:1 << 14] for i in idxs),
        tuple(g[:1 << 14] for g in grads))
    for label, (tables, idxs, grads) in sets.items():
        ms, bound = cs.rows_times(tables, idxs, grads, card)
        out["rows_ms"][label] = dict(ms, bound_ms=bound[0])
        if label.endswith("float32 trip 0"):
            shapes = [tuple(t.shape) for t in tables]
            out["nodes"][f"K16 {label}"] = cs.graph_nodes(
                lambda: gr.launch_gather(tables, idxs))
            out["nodes"][f"K17 {label}"] = cs.graph_nodes(
                lambda: gr.launch_row_sum(grads, idxs, shapes))
    torch.cuda.empty_cache()
    scene, cam, cfg = cs.build_preset("random-spheres", device=dev)
    params, _ = cs.dg.split_params(scene)
    out["scan_s"] = {}
    for rays in (1 << 14, 1 << 17):
        ids = torch.arange(rays, device=dev)
        target = torch.zeros((rays, 3), device=dev)

        def scan():
            return cs.dg.render_loss_and_grads(params, scene, cam, cfg, key,
                                               ids, target, method="scan")
        scan()  # the capture
        out["scan_s"][rays] = statistics.median(
            cs.host_s(scan)[0] for _ in range(3))
        cs.dg.SCAN_GRAPHS.clear()
        torch.cuda.empty_cache()
        out["nodes"][f"scan at {rays}"] = cs.graph_nodes(
            lambda: cs.dg.scan_loss_and_grads(
                params, scene, cam, key, ids, target, None, cfg=cfg,
                intersect_fn=cs.default_intersect))
        torch.cuda.empty_cache()
    cs.log(f"  {checkout}: scan {out['scan_s']} s; nodes {out['nodes']}")
    print(json.dumps(out), flush=True)


def _build_splits(cs, checkouts, only=None):
    """One nvcc a variant of SPLITS that applies to a checkout's source,
    all at once; returns [(checkout, name, keeps, library path)]."""
    from first_raytracer_tpu_torch.kernels import build
    out_dir = os.path.join(ROOT, "out", "scan_graph_split")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for checkout in checkouts:
        with open(os.path.join(checkout, "first_raytracer_tpu_torch",
                               "kernels", "csrc", "gather_rows.cu")) as f:
            text = f.read()
        for name, (edits, keeps) in SPLITS.items():
            if only and name not in only:
                continue
            if not all(old in text for old, _ in edits):
                continue
            stem = os.path.join(out_dir, re.sub(r"\W+", "_",
                                                f"{checkout}_{name}"))
            with open(stem + ".cu", "w") as f:
                f.write(functools.reduce(lambda t, e: t.replace(*e), edits,
                                         text))
            cmd = [build._nvcc(), *build.NVCC_FLAGS,
                   *cs.mk.NVCC_EXTRA_FLAGS, "-I", build.CSRC_DIR, "-o",
                   stem + ".so", stem + ".cu"]
            procs.append((checkout, name, keeps, stem + ".so",
                          subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    built = []
    for checkout, name, keeps, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {checkout} {name}:\n{log}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "registers" in line]
        built.append((checkout, name, keeps, lib, regs))
    return built


def split(checkouts, only=None):
    """K17's parts cut in copies of each checkout's source, timed in turns
    through this checkout's wrapper (whose launch matches the source's
    entry points; a parent's source is driven by its own wrapper)."""
    cs = _checkout_smoke(ROOT)
    torch = cs.torch
    card = cs.card_line()
    cs.log(card)
    cs.build()
    dev = torch.device("cuda")
    key = cs.rng.base_key(0).to(dev)
    sets = {k: v for k, v in _trip_sets(cs, dev, key).items()
            if "float64" not in k}
    built = _build_splits(cs, checkouts, only)
    wrappers = {c: _wrapper(c) for c in checkouts}
    times = {(c, n): {k: [] for k in sets} for c, n, *_ in built}
    same = {}
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}
    for rnd in range(2):
        for checkout, name, keeps, lib, regs in (built if rnd == 0
                                                 else built[::-1]):
            gr = wrappers[checkout]
            clib = cs.mk.bind_gather_rows(ctypes.CDLL(lib)) \
                if hasattr(gr, "row_sum_words") else _bind_old(lib)

            def entry(dev, fn, *args, clib=clib):
                stream = torch.cuda.current_stream(dev).cuda_stream
                err = getattr(clib, fn)(*args, stream)
                if err != 0:
                    raise RuntimeError(f"{fn} failed ({err})")
            sys.modules[gr.__name__ + "_mk"].launch_entry = entry
            for label, (tables, idxs, grads) in sets.items():
                shapes = [tuple(t.shape) for t in tables]
                if rnd == 0 and keeps:
                    got = gr.launch_row_sum(grads, idxs, shapes)
                    same[f"{checkout} {name} {label}"] = all(
                        torch.equal(a.view(bits[a.dtype]), cs.gr.row_sum_plain(
                            g, i, s[0]).view(bits[a.dtype]))
                        for a, g, i, s in zip(got, grads, idxs, shapes))
                times[(checkout, name)][label].append(cs.graph_ms(
                    lambda: gr.launch_row_sum(grads, idxs, shapes), 7, 20))
    rows = [{"checkout": c, "variant": n, "registers": regs,
             "ms": times[(c, n)]} for c, n, _, _, regs in built]
    for r in rows:
        cs.log(f"  {r['checkout']} {r['variant']}: " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)} ms"
            for k, v in r["ms"].items()) + f"; {r['registers']}")
    cs.log(f"  bit-equal to row_sum_plain: {same}; on {card}")
    if not all(same.values()):
        raise AssertionError(f"a variant that keeps the function differs: "
                             f"{same}")
    print(json.dumps({"card": card, "splits": rows, "bit_equal": same}),
          flush=True)


def _wrapper(checkout):
    """``checkout``'s ``kernels/gather_rows.py`` loaded under a name of its
    own, with a ``megakernel`` stand-in whose ``launch_entry`` the split
    sets."""
    import importlib.util
    import types
    name = "split_gather_rows_" + re.sub(r"\W+", "_",
                                         os.path.abspath(checkout))
    stand_in = types.ModuleType(name + "_mk")
    sys.modules[name + "_mk"] = stand_in
    path = os.path.join(checkout, "first_raytracer_tpu_torch", "kernels",
                        "gather_rows.py")
    with open(path) as f:
        text = f.read().replace("from . import megakernel",
                                f"import {name}_mk as megakernel")
    spec = importlib.util.spec_from_loader(name, loader=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__file__ = path
    exec(compile(text, path, "exec"), mod.__dict__)
    sys.modules[name] = mod
    return mod


def _bind_old(lib):
    """The argument types of a source whose K16 entry takes no index
    width (the earlier design's)."""
    lib = ctypes.CDLL(lib)
    desc = ctypes.POINTER(ctypes.c_int64)
    for t in ("f32", "f64"):
        fn = getattr(lib, f"frt_row_sum_{t}")
        fn.argtypes = [desc, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    main()
