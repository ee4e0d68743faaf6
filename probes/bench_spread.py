"""The repeat samples of one ``bench_torch.py`` configuration in order, and
where a slow sample's time went.

Starts ``--procs`` processes, one after another, as ``chip_smoke.py``'s
phase 17 starts ``bench_torch.py``.  Each builds the bench's plan for the
configuration its switches select (``BENCH_*`` in the environment; by
default ``BENCH_MODE=grad BENCH_GRAD_PIPELINE=4``, phase 17's "grad final
scene"), makes the bench's warm run and its run that sets the runs a
repeat queues (``runs_per_repeat``), then ``--repeats`` repeats as
``bench.measure`` times them, with, for each run of a repeat, the host's
clock when its work was queued and a CUDA event after it, and the
collector's passes (``gc.callbacks``) and their seconds, and the main
thread's CPU seconds and context switches, voluntary and forced
(``getrusage``), and the machine's stolen seconds (``/proc/stat``).  Prints one JSON
line a process: each repeat's seconds a run in the order taken, the
largest over the smallest, and for each repeat the largest gap between
two runs' queueing on the host, the longest run between two events on the
card, the median one, and the collector's seconds.  A slow repeat whose
host gap is long while the card's runs are not was held up on the host;
one whose card runs are long was slow on the card.  With ``--parts``
(the final scene's grad mode), the recorder's call and the replay's
(``render_loss_and_grads_bucketed``) are each put between two events too,
and each repeat also gives the longest recorder, the longest replay and
the longest idle stretch between two parts on the card.  With
``--profile DIR``, the repeats run under ``torch.profiler`` (the card's
activity) and each process also prints, from the trace it writes to
``DIR``, each kernel's count, median and largest microseconds and the
longest stretches in which the card ran nothing.

With ``--launches N``, each process instead queues N calls each of K2b
(the recorder), K14 and K15 on 2^17 rays of the final scene (K2b's tape,
as ``probes/replay_pass.py --turns`` makes them), eagerly, a CUDA event
between every two launches and a synchronize every 100 calls, and prints
each kernel's median, 99th percentile and largest ms: a kernel whose
time varies from call to call on the same inputs shows there.

    python probes/bench_spread.py --procs 6 --repeats 5
    python probes/bench_spread.py --tree out/parent   # a parent checkout
    python probes/bench_spread.py --procs 2 --launches 1000
"""
import argparse
import gc
import json
import os
import resource
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mark_parts(torch, marks):
    """Wraps the grad mode's recorder and replay calls so that each records
    a CUDA event and the host's clock before and after it into ``marks``
    as (part, 'in' or 'out', event, host seconds)."""
    from first_raytracer_tpu_torch.diff import grad as dg
    from first_raytracer_tpu_torch.kernels import record_mega as rm

    def wrap(mod, name):
        inner = getattr(mod, name)

        def marked(*args, **kwargs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, "in", ev, time.perf_counter()))
            out = inner(*args, **kwargs)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, "out", ev, time.perf_counter()))
            return out
        marked.__dict__ = inner.__dict__  # its launch counters
        setattr(mod, name, marked)
    wrap(rm, "record_paths_mega")
    wrap(dg, "render_loss_and_grads_bucketed")


def part_times(marks):
    """The longest card time of each part, and of the idle stretches
    between parts, in ms, from ``mark_parts``' marks."""
    out = {}
    for (n0, k0, e0, _), (n1, k1, e1, _) in zip(marks, marks[1:]):
        ms = e0.elapsed_time(e1)
        part = n0 if (k0, k1) == ("in", "out") else "between parts"
        out[part] = max(out.get(part, 0.0), ms)
    return out


def trace_summary(path, top=8):
    """Each kernel's count, median and largest us, the ``top`` longest idle
    stretches of the card (us, and the kernels on either side; for the
    first three, the host's traced calls that overlap them), and each CUDA
    runtime call's count, total, median and largest us, from a chrome
    trace that ``torch.profiler`` wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    work = sorted((e for e in events if e.get("ph") == "X" and e.get(
        "cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
        key=lambda e: e["ts"])
    by_name = {}
    for e in work:
        by_name.setdefault(e["name"][:60], []).append(e["dur"])
    kernels = {n: {"count": len(d), "median_us": statistics.median(d),
                   "max_us": max(d)} for n, d in by_name.items()}
    gaps = sorted(((b["ts"] - (a["ts"] + a["dur"]), i)
                   for i, (a, b) in enumerate(zip(work, work[1:]))),
                  reverse=True)[:top]
    idle = [(g, work[i]["name"][:40], work[i + 1]["name"][:40])
            for g, i in gaps]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "cuda_runtime", "cuda_driver", "cpu_op", "python_function")]
    around = []
    for g, i in gaps[:3]:
        lo = work[i]["ts"] + work[i]["dur"]
        hi = lo + g
        inside = sorted((e for e in host if e["ts"] < hi and
                         e["ts"] + e["dur"] > lo),
                        key=lambda e: -(min(hi, e["ts"] + e["dur"]) -
                                        max(lo, e["ts"])))[:6]
        around.append([g, [(e["cat"], e["name"][:50], e["dur"])
                           for e in inside]])
    calls = {}
    for e in host:
        if e["cat"] in ("cuda_runtime", "cuda_driver"):
            calls.setdefault(e["name"][:40], []).append(e["dur"])
    runtime = {n: {"count": len(d), "total_us": sum(d),
                   "median_us": statistics.median(d), "max_us": max(d)}
               for n, d in calls.items()}
    return {"kernels": kernels, "idle_us": idle, "idle_host": around,
            "runtime": runtime,
            "span_us": work[-1]["ts"] + work[-1]["dur"] - work[0]["ts"]}


def sched():
    """(CPU seconds of the calling thread, its voluntary and involuntary
    context switches, the machine's stolen seconds where ``/proc/stat``
    has them, else 0)."""
    use = resource.getrusage(resource.RUSAGE_THREAD)
    steal = 0.0
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        if len(cpu) > 8:
            steal = int(cpu[8]) / os.sysconf("SC_CLK_TCK")
    except OSError:
        pass
    return (use.ru_utime + use.ru_stime, use.ru_nvcsw, use.ru_nivcsw,
            steal)


def worker(repeats, parts=False, profile=None):
    import torch

    from first_raytracer_tpu_torch import bench as b

    marks = []
    if parts:
        mark_parts(torch, marks)

    env = os.environ
    dev = torch.device("cuda")
    scene_sel = env.get("BENCH_SCENE", "")
    mode = b._choice(env, "BENCH_MODE", "mega", b.MODES)
    isect = b._choice(env, "BENCH_INTERSECT",
                      "clustered" if scene_sel else "pallas", b.INTERSECTS)
    scene, cam, cfg, _ = b.select_scene(scene_sel, dev)
    key = b.rng.base_key(0)
    plan, accel = b._plan(env, mode, scene_sel, scene, cam, cfg, key, isect)
    plan.run(b.CountedIntersect(isect, scene, accel))
    torch.cuda.synchronize()
    fn = b.INTERSECT_FN.get(isect)
    frames = b.runs_per_repeat(plan.run, fn, dev)

    collecting = []

    def on_gc(phase, info):
        collecting.append((phase, time.perf_counter()))
    gc.callbacks.append(on_gc)
    out = []
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    for _ in range(repeats):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(frames + 1)]
        queued = []
        del collecting[:]
        del marks[:]
        s0 = sched()
        t0 = time.perf_counter()
        events[0].record()
        for k in range(frames):
            plan.run(fn)
            events[k + 1].record()
            queued.append(time.perf_counter())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran, vol, invol, stolen = (b - a for a, b in zip(s0, sched()))
        runs = [events[k].elapsed_time(events[k + 1]) / 1e3
                for k in range(frames)]
        gaps = [b - a for a, b in zip([t0] + queued, queued)]
        starts = [t for p, t in collecting if p == "start"]
        stops = [t for p, t in collecting if p == "stop"]
        out.append({"per_run_s": wall / frames, "wall_s": wall,
                    "host_gap_max_s": max(gaps),
                    "card_run_max_s": max(runs),
                    "card_run_median_s": statistics.median(runs),
                    "gc_passes": len(stops),
                    "gc_s": sum(b - a for a, b in zip(starts, stops)),
                    "thread_cpu_s": ran, "switches": vol,
                    "forced_switches": invol,
                    "machine_stolen_s": stolen,
                    **({"parts_max_ms": part_times(marks)} if parts
                       else {})})
    gc.callbacks.remove(on_gc)
    times = [r["per_run_s"] for r in out]
    line = {"frames": frames, "spread": max(times) / min(times),
            "repeats": out}
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(profile, exist_ok=True)
        path = os.path.join(profile, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        line["trace"] = trace_summary(path)
    print(json.dumps(line))


def launch_worker(calls, tree):
    import torch

    from replay_pass import final_scene
    from first_raytracer_tpu_torch.core import rng
    from first_raytracer_tpu_torch.diff import replay_pass as rp
    from first_raytracer_tpu_torch.kernels import megakernel as mk
    from first_raytracer_tpu_torch.kernels import record_mega as rm

    c = final_scene(torch, tree)
    scene, cfg, ids = c["scene"], c["cfg"], c["ids"]
    sph, tri = (t if t is None else t.detach()
                for t in rp._payload_tables(scene))
    k = rng.device_key(c["key"], c["dev"])
    pack = mk.pack_scene_mega(scene)
    fwd = (sph, tri, c["o"], c["d"], ids, k, c["tape"], cfg.max_depth,
           cfg.t_min)
    out = rp.launch_forward(*fwd)
    g_rad = (2.0 * out[0] / out[0].numel()).contiguous()
    bwd = (sph, tri, ids, k, c["tape"], cfg.max_depth, cfg.t_min, *out[1:],
           g_rad)
    work = {"K2b": lambda: rm.record_paths_mega(pack, c["cam"], cfg, c["key"],
                                                num_rays=len(ids)),
            "K14": lambda: rp.launch_forward(*fwd),
            "K15": lambda: rp.launch_backward(*bwd)}
    ms = {name: [] for name in work}
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        for lo in range(0, calls, 100):
            n = min(100, calls - lo)
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(n + 1)]
            events[0].record()
            for j in range(n):
                fn()
                events[j + 1].record()
            torch.cuda.synchronize()
            ms[name] += [events[j].elapsed_time(events[j + 1])
                         for j in range(n)]
    line = {}
    for name, t in ms.items():
        t = sorted(t)
        line[name] = {"median_ms": statistics.median(t),
                      "p99_ms": t[int(0.99 * (len(t) - 1))],
                      "max_ms": t[-1], "calls": len(t),
                      "over_2x_median": sum(x > 2 * statistics.median(t)
                                            for x in t)}
    print(json.dumps(line))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--tree", default=ROOT,
                   help="checkout whose package the processes import")
    p.add_argument("--launches", type=int, default=0,
                   help="calls of each kernel a process (0: the bench)")
    p.add_argument("--parts", action="store_true",
                   help="events around the recorder and the replay too")
    p.add_argument("--profile", metavar="DIR",
                   help="run the repeats under torch.profiler; traces here")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker and args.launches:
        return launch_worker(args.launches, args.tree)
    if args.worker:
        return worker(args.repeats, args.parts, args.profile)
    tree = os.path.abspath(args.tree)
    env = dict(os.environ, PYTHONPATH=tree)
    env.setdefault("BENCH_MODE", "grad")
    env.setdefault("BENCH_GRAD_PIPELINE", "4")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for n in range(args.procs):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--repeats", str(args.repeats), "--launches",
             str(args.launches), "--tree", tree]
            + (["--parts"] if args.parts else [])
            + (["--profile", os.path.abspath(args.profile)]
               if args.profile else []), cwd=tree, env=env,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"process {n} exited {proc.returncode}")
        print(os.path.relpath(tree, ROOT), n,
              proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
