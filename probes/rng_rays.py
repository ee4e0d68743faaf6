"""K7 and K8 on the card: phase 20 of ``chip_smoke.py`` alone, the design
variants of both kernels, or one checkout's K7, K8 and the paths they
serve, for turns with another.

Without arguments: builds the kernels' library (phase 2: ptxas's
registers and spills of each kernel), counts K7's and K8's launches over
the final scene's pool frame (2^17 slots through K4) and its chunked frame
(chunks of 2^17), both graphed, where only the loops' inits make camera
rays (K9 and K10 draw and make the passes' rays, phase 21); then runs
``chip_smoke.rng_rays_path``: the pool recorder through K4 (K7 none, K8
once, its init), its tape's replay (K8 once) and the differentiable scan
(K7 once a trip), each with the counters reset; K7 and K8 bit-equal to
their plain versions on phase 20's sets; their ms at 32, 1024, 2^15 and
2^17 rays beside a launch's floor, and their bounds.  Prints the phase's
log and K7's and K8's entries of the kernels line (about 2 min with the
build).

With ``--variants``: builds ``probes/rng_rays_variants.cu`` (its comment
lists the variants) with the package's flags, prints each variant
kernel's registers, SASS instructions and calls (``cuobjdump -sass``),
holds every variant bit-equal to the package's K7 or K8 on 2^17 ids, ids
around 2^32 - 1 (K8's 32-bit division variant below 2^32 only) and
camera-effects' lens, then times them in turns (each call in a CUDA graph
of 20, median of 7 replays, three rounds in alternating order) at 32,
1024, 2^15 and 2^17 rays beside a one-element fill.  Then K7's camera
draw read apart: the package's K7 through its C entry point with the
domain pointer null, a 0-d tensor of 0, zeros per ray and per-ray depths,
in turns at 2^17 ids.

With ``--turns CHECKOUT``: imports the package of ``CHECKOUT`` (a
directory holding ``first_raytracer_tpu_torch``, e.g. a parent unpacked
with ``git archive`` under ``out/``), builds its library and prints one
JSON line: the SASS instructions and calls of its K7, K8 (float and
double), K10 and K12's pool kernel; K7 (bounce draws at per-ray depths,
and the camera draw) and K8 (the final scene's camera) at 32, 1024, 2^15
and 2^17 rays beside a one-element fill (20 calls a graph, median of 7);
K10 at 2^17 slots after a pass and K12's pool launch at 2^14 and 2^17
slots (``probes/record_pass.py``'s ``StateClock``); the final scene's
pool frame (2^17 slots through K4), its chunked frames (chunks of 2^17 and
of the default 2^15) and the direct step at 2^17 rays (s, median of 3
after a warm call), with K8's launches in each.  Run on a GPU host from
the repository root, parent and change in turns:

    python probes/rng_rays.py
    python probes/rng_rays.py --variants
    mkdir -p out/parent && git archive <parent> | tar -x -C out/parent
    for t in out/parent . . out/parent; do
        python probes/rng_rays.py --turns $t; done
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
OUT = os.path.join(ROOT, "out", "rng_rays")
VARIANTS_SRC = os.path.join(ROOT, "probes", "rng_rays_variants.cu")
SIZES = (32, 1024, 1 << 15, 1 << 17)
K7_VARIANTS = ("shipped", "scalar stores", "8-byte reads", "two rays a thread",
               "blocks of 128", "blocks of 512")
K8_VARIANTS = ("shipped", "32-bit division", "int64 floor division",
               "sinf and cosf apart", "camera in shared memory",
               "rows staged, 16-byte stores", "the design before",
               "two rays a thread")
# The functions whose SASS is read, by a pattern of their mangled names.
SASS_NAMES = {"K7": r"uniforms_kernel", "K8 float": r"camera_rays_kernelIf",
              "K8 double": r"camera_rays_kernelId",
              "K10": r"regenerate_kernel", "K12 pool": r"record_pool_kernel",
              "K7 variant": r"k7_kernel", "K8 variant": r"k8_kernel",
              "K8 variant two rays": r"k8_two_rays"}


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def graph_ms(torch, fn, repeats=7, inner=20):
    """Median ms of one call of ``fn``: ``inner`` calls captured in a CUDA
    graph, its replays timed by events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
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
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


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


def opcode(inst):
    """An instruction's opcode, past its predicate."""
    words = inst.split()
    return words[1] if words[0].startswith("@") else words[0]


def sass(lib_path):
    """{label: {instructions, calls, callees}} of each function of
    ``lib_path`` that ``SASS_NAMES`` names (one entry a template
    instance for the variants), from ``cuobjdump -sass``: its instructions
    but the NOPs that pad it, its CALLs, and for each subroutine it calls
    (by address) the calls and the routine's length and opcodes up to its
    RET (the 64-bit integer division routine seeds its quotient with
    I2F.U64.RP)."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib_path],
        capture_output=True, text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        fn = body.split("\n", 1)[0].strip()
        label = next((k for k, pat in SASS_NAMES.items()
                      if re.search(pat, fn)), None)
        if label is None:
            continue
        rows = [(int(a, 16), i.strip()) for a, i in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        insts = [i for _, i in rows if not i.startswith("NOP")]
        calls = [i for i in insts if re.match(r"(@!?U?P\w+\s+)?CALL", i)]
        callees = {}
        for c in calls:
            addr = int(c.split()[-1], 16)
            start = next(k for k, (a, _) in enumerate(rows) if a == addr)
            end = next((k for k in range(start, len(rows))
                        if opcode(rows[k][1]).startswith("RET")),
                       len(rows) - 1)
            ops = sorted({opcode(r[1]) for r in rows[start:end + 1]})
            entry = callees.setdefault(hex(addr), {
                "calls": 0, "instructions": end + 1 - start,
                "division_64": any(o.startswith("I2F.U64.RP") for o in ops),
                "opcodes": ops})
            entry["calls"] += 1
        args = re.search(r"kernelI((?:Li\d+E)+)", fn)
        if label.endswith("variant") and args:
            label += " " + "/".join(re.findall(r"\d+", args.group(1)))
        out[label] = {"instructions": len(insts), "calls": len(calls),
                      "callees": callees}
    return out


def final_scene(torch, dev):
    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.scene.builders import build_preset

    scene, cam, cfg = build_preset("random-spheres", device=dev)
    key = rng.base_key(0).to(dev)
    depths = torch.randint(0, 51, (SIZES[-1],), generator=torch.Generator(
        ).manual_seed(0)).to(dev)
    return scene, cam, cfg, key, depths


def kernel_times(torch, dev, cam, cfg, key, depths):
    """{size: {K7, K7 camera draw, K8, floor}} in ms, and the bounds."""
    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.render import camera
    from first_raytracer_tpu_torch.utils.roofline import k7_bound, k8_bound

    one = torch.empty(1, device=dev)
    out, bounds = {}, {}
    for n in SIZES:
        ids = torch.arange(n, device=dev)
        dep = depths[:n].contiguous()
        out[n] = {
            "floor": graph_ms(torch, one.zero_),
            "K7": graph_ms(torch, lambda: rng.uniforms(key, ids, dep,
                                                       offset=1)),
            "K7 camera draw": graph_ms(
                torch, lambda: rng.camera_uniforms(key, ids)),
            "K8": graph_ms(torch, lambda: camera.camera_rays(
                cam, cfg.nx, cfg.ny, cfg.spp, key, ids))}
        bounds[n] = {"K7": k7_bound(n, True), "K7 camera draw": k7_bound(n),
                     "K8": k8_bound(n)}
    return out, bounds


# --------------------------------------------------------------------------
# --turns: one checkout's K7, K8, K10, K12's pool launch and the paths.
# --------------------------------------------------------------------------

def turns(checkout):
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    import first_raytracer_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(
            os.path.abspath(checkout)):
        raise SystemExit(f"imported {pkg.__file__}, not {checkout}'s")
    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.diff import grad as dg
    from first_raytracer_tpu_torch.diff import record_pass as rpass
    from first_raytracer_tpu_torch.diff import replay as rrep
    from first_raytracer_tpu_torch.kernels import dense_hit as dh
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip
    from first_raytracer_tpu_torch.kernels import megakernel as mk
    from first_raytracer_tpu_torch.render import camera
    from first_raytracer_tpu_torch.render import wavefront_pass as wp
    from first_raytracer_tpu_torch.render.api import render_image
    from first_raytracer_tpu_torch.render.integrator import default_intersect
    from first_raytracer_tpu_torch.render.regenerative import (pool_pass,
                                                               pool_state)

    import record_pass as rprobe

    if not torch.cuda.is_available():
        raise SystemExit("probes/rng_rays.py: no CUDA device")
    dev = torch.device("cuda")
    _, info = mk.load_mega_library()
    scene, cam, cfg, key, depths = final_scene(torch, dev)
    R = SIZES[-1]
    ids = torch.arange(R, device=dev)
    same = (torch.equal(rng.uniforms(key, ids, depths, offset=1),
                        rng.uniforms_plain(key, ids, depths + 1))
            and all(torch.equal(a, b) for a, b in zip(
                camera.camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids),
                camera.camera_rays_plain(cam, cfg.nx, cfg.ny, cfg.spp, key,
                                         ids))))
    if not same:
        raise AssertionError(f"{checkout}: K7 or K8 off its plain version")
    ms, bounds = kernel_times(torch, dev, cam, cfg, key, depths)

    # K10 at 2^17 slots after the pool's init and one pass (phase 21's
    # method: it reads the pass record, so its calls repeat one).
    pack = ip.pack_scene_pallas(scene)
    start = torch.zeros((), dtype=torch.int64, device=dev)
    static = dict(cfg=cfg, num_rays=cfg.num_rays, pool_size=R)
    inputs = dict(scene=scene, camera=cam, accel=pack, key=key,
                  start_id=start)
    state = pool_state(**inputs, **static)
    pool_pass(state, **inputs, intersect_fn=ip.intersect_pallas, **static)
    prim, _, hit = ip.intersect_pallas(scene, pack, state["o"], state["d"],
                                       cfg.t_min)
    wp._launch_shade(state, prim, hit, scene=scene, key=key, cfg=cfg,
                     start_id=start, num_rays=cfg.num_rays)
    ms["K10 at 2^17 slots"] = graph_ms(torch, lambda: wp._launch_regenerate(
        state, camera=cam, key=key, start_id=start, **static))
    # K12's pool launch (K13 folded in) after one pass, as
    # probes/record_pass.py --turns times it.
    kw = dict(scene=scene, key=key, cfg=cfg)
    for slots, n_ids in ((1 << 14, R), (R, 4 * R)):
        pids = torch.arange(n_ids, device=dev)
        pstate = rrep.record_pool_state(cam, key, pids, cfg=cfg,
                                        pool_size=slots)
        rrep.record_pool_pass(pstate, camera=cam, accel=None, ray_ids=pids,
                              intersect_fn=default_intersect, **kw)
        pprim, _, phit = dh.dense_hit(scene, pstate["o"], pstate["d"],
                                      cfg.t_min, pstate["alive"])
        clock = rprobe.StateClock(
            torch, lambda w, p, h, pids=pids: rpass.record_shade(
                w, p, h, camera=cam, ray_ids=pids, **kw),
            pstate, (pprim, phit), tuple(rpass.RECORD_ROWS) + ("cursor",))
        ms[f"K12 pool at {slots} slots"] = clock.ms(pstate, (pprim, phit))

    def frame(**kwargs):
        return lambda: render_image(scene, cam, cfg, seed=0, accel=pack,
                                    device=dev, **kwargs)
    params, _ = dg.split_params(scene)
    target = torch.zeros((R, 3), device=dev)
    runs = {"pool frame": frame(mode="regenerative", pool_size=R),
            "chunked frame, chunks of 2^17": frame(mode="wavefront",
                                                   chunk=R),
            "chunked frame, chunks of 2^15": frame(mode="wavefront"),
            "direct step": lambda: dg.render_loss_and_grads(
                params, scene, cam, cfg, key, ids, target)}
    secs, k8_launches = {}, {}
    for name, fn in runs.items():
        secs[name] = host_s(torch, fn)
        camera.camera_rays.launches = 0
        fn()
        torch.cuda.synchronize()
        k8_launches[name] = camera.camera_rays.launches
    print(json.dumps({
        "checkout": checkout, "card": card(), "sass": sass(info.path),
        "ms": {str(k): v for k, v in ms.items()},
        "bounds": {str(n): {k: list(v) for k, v in b.items()}
                   for n, b in bounds.items()},
        "s": secs, "K8 launches": k8_launches}), flush=True)


# --------------------------------------------------------------------------
# --variants: this checkout's variants of K7 and K8, in turns.
# --------------------------------------------------------------------------

def build_variants():
    """nvcc of ``rng_rays_variants.cu`` with the package's flags; returns
    (ctypes library, its path, nvcc's output)."""
    from first_raytracer_tpu_torch.kernels import megakernel as mk
    from first_raytracer_tpu_torch.kernels.build import (CSRC_DIR,
                                                         NVCC_FLAGS, _nvcc)

    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "librng_rays_variants.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *mk.NVCC_EXTRA_FLAGS, "-I", CSRC_DIR,
           "-o", lib, VARIANTS_SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    dll.k7_variant.argtypes = [ctypes.c_int, p, p, p, i64, i64, i64, p, p]
    dll.k7_variant.restype = ctypes.c_int
    dll.k8_variant.argtypes = [ctypes.c_int, p, p] + [i64] * 4 + [p] * 10
    dll.k8_variant.restype = ctypes.c_int
    return dll, lib, proc.stdout + proc.stderr


def variants():
    sys.path.insert(0, ROOT)
    import torch

    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.kernels import megakernel as mk
    from first_raytracer_tpu_torch.render import camera
    from first_raytracer_tpu_torch.scene.builders import build_preset

    if not torch.cuda.is_available():
        raise SystemExit("probes/rng_rays.py: no CUDA device")
    dev = torch.device("cuda")
    print(card(), flush=True)
    dll, path, log = build_variants()
    regs = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(json.dumps({"ptxas": regs, "sass": sass(path)}), flush=True)
    scene, cam, cfg, key, depths = final_scene(torch, dev)
    _, lcam, lcfg = build_preset("camera-effects", device=dev)
    fields = ("origin", "lower_left", "horizontal", "vertical", "u", "v",
              "lens_radius")

    def k7(which, ids, dom, stride, offset):
        out = torch.empty(ids.shape + (4,), device=dev)
        err = dll.k7_variant(which, key.data_ptr(), ids.data_ptr(),
                             None if dom is None else dom.data_ptr(),
                             stride, offset, ids.numel(), out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K7 variant {which}: error {err}")
        return out

    def k8(which, c, cf, ids):
        n = ids.numel()
        o = torch.empty((n, 3), device=dev)
        d = torch.empty((n, 3), device=dev)
        err = dll.k8_variant(which, key.data_ptr(), ids.data_ptr(), n, cf.nx,
                             cf.ny, cf.spp,
                             *(getattr(c, f).data_ptr() for f in fields),
                             o.data_ptr(), d.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K8 variant {which}: error {err}")
        return o, d

    # Every variant bit-equal to the package's kernel.
    R = SIZES[-1]
    big = torch.arange((1 << 32) - 1024, (1 << 32) + 1024, device=dev)
    sets = [("2^17 ids", torch.arange(R, device=dev), cam, cfg),
            ("ids around 2^32 - 1", big, cam, cfg),
            ("camera-effects' lens, 2^17 ids", torch.arange(R, device=dev),
             lcam, lcfg)]
    for label, ids, c, cf in sets:
        want = camera.camera_rays(c, cf.nx, cf.ny, cf.spp, key, ids)
        for which, name in enumerate(K8_VARIANTS):
            got = k8(which, c, cf, ids)
            keep = (ids < (1 << 32)) if which == 1 else slice(None)
            if not all(torch.equal(a[keep], b[keep])
                       for a, b in zip(got, want)):
                raise AssertionError(f"K8 {name} differs on {label}")
        for dom, stride, off in ((None, 0, 0),
                                 (depths[:ids.numel()].contiguous(), 1, 1)):
            want = rng.uniforms(key, ids, 0 if dom is None else dom,
                                offset=off)
            for which, name in enumerate(K7_VARIANTS):
                if not torch.equal(k7(which, ids, dom, stride, off), want):
                    raise AssertionError(f"K7 {name} differs on {label}")
    print("every variant bit-equal to the package's K7 or K8 on "
          + ", ".join(s[0] for s in sets), flush=True)

    one = torch.empty(1, device=dev)
    times = {}
    for n in SIZES:
        ids = torch.arange(n, device=dev)
        dep = depths[:n].contiguous()
        fns = {"floor": one.zero_}
        for which, name in enumerate(K7_VARIANTS):
            fns[f"K7 {name}"] = (lambda w=which: k7(w, ids, dep, 1, 1))
        for which, name in enumerate(K8_VARIANTS):
            fns[f"K8 {name}"] = (lambda w=which: k8(w, cam, cfg, ids))
        rows = {k: [] for k in fns}
        for r in range(3):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                rows[k].append(graph_ms(torch, fns[k]))
        times[n] = rows
        print(json.dumps({"rays": n, "ms": rows}), flush=True)

    # K7's camera draw read apart: the package's K7, its domain given four
    # ways, in turns at 2^17 ids.
    ids = torch.arange(R, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    zeros = torch.zeros(R, dtype=torch.int64, device=dev)

    def package_k7(dom, stride, offset):
        out = torch.empty((R, 4), device=dev)
        mk.launch_entry(dev, "frt_uniforms", key.data_ptr(), ids.data_ptr(),
                        None if dom is None else dom.data_ptr(), stride,
                        offset, R, out.data_ptr())
        return out
    ways = {"domain pointer null (the camera draw)":
            lambda: package_k7(None, 0, 0),
            "a 0-d domain tensor of 0": lambda: package_k7(zero, 0, 0),
            "zeros per ray": lambda: package_k7(zeros, 1, 0),
            "per-ray depths + 1 (the bounce draw)":
            lambda: package_k7(depths, 1, 1),
            "rng.camera_uniforms": lambda: rng.camera_uniforms(key, ids),
            "rng.uniforms, per-ray depths": lambda: rng.uniforms(
                key, ids, depths, offset=1)}
    rows = {k: [] for k in ways}
    for r in range(4):
        for k in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            rows[k].append(graph_ms(torch, ways[k]))
    print(json.dumps({"K7 camera draw split, 2^17 ids": rows}), flush=True)


def phase20():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from first_raytracer_tpu_torch.kernels import intersect_pallas as ip

    if not torch.cuda.is_available():
        raise SystemExit("probes/rng_rays.py: no CUDA device")
    dev = torch.device("cuda")
    line = cs.card_line()
    cs.log(line)
    cs.build()
    key = cs.rng.base_key(0)
    scene, cam, cfg = cs.build_preset("random-spheres", device=dev)
    pack = ip.pack_scene_pallas(scene)
    draws = {}
    for mode in ("regenerative", "wavefront"):
        cs.reset_counts()
        cs.render_image(scene, cam, cfg, seed=0, accel=pack, mode=mode,
                        chunk=cs.WAVE_RAYS, pool_size=cs.WAVE_RAYS,
                        device=dev)
        torch.cuda.synchronize()
        draws[mode] = (cs.rng.uniforms.launches,
                       cs.rcam.camera_rays.launches)
        cs.log(f"  the {mode} frame, graphed: K7 launches {draws[mode][0]},"
               f" K8 {draws[mode][1]}")
    torch.cuda.empty_cache()
    for entry in cs.rng_rays_path(dev, key, line, draws):
        cs.log(json.dumps(entry))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", metavar="CHECKOUT")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if args.variants:
        variants()
    elif args.turns:
        turns(args.turns)
    else:
        phase20()
    return 0


if __name__ == "__main__":
    sys.exit(main())
