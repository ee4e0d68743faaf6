"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (the configuration's scene, the
program's packs, warm-up and, for a fit, its first three steps) is timed
as ``setup_s`` from the process's start; then a closed loop with one client
sends request after request for ``--seconds``, each ending in a
synchronize or a loss read; then the check decides ``correct``.  With
``--trace 1`` the window runs under ``torch.profiler`` and the line carries
the cell's per-layer metrics, the device's busy seconds and a breakdown;
with ``--trace 0`` its end-to-end metrics.  The last line of standard
output is the result as one JSON object; every other line goes to
standard error.  Exits with another code than 0, printing no result, where
the card is missing, where the program loaded JAX, where a file is missing,
or where a traced run's per-layer metric that ``BENCHMARK.json`` lists for
the cell reads nothing (its kernels renamed or gone from the trace: the
reader has to follow them).
"""
import time

_T0 = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Caches of the program's builds and kernels: fixed paths in the checkout.
CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "first_raytracer_tpu")


def _process_age():
    """Seconds from this process's start to ``_T0``, from ``/proc``."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK")
                   - (time.time() - _T0))
    except (OSError, ValueError, IndexError):
        return 0.0


def log(*args):
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """What a request kind's session is given."""

    config: dict
    traffic: dict
    limits: dict
    streams: dict
    device: object
    spans: object
    scene_arrays: dict

    @property
    def image(self):
        return self.config["image"]


class MetricMissing(RuntimeError):
    """A per-layer metric listed for the cell read nothing in the trace."""


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def judge(numbers, limits):
    """{name: {"value", "limit"}} of the numbers the cell's limits name,
    and whether each is within its limit (NaN is not)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return checks, ok


def run_cell(spec, cell, seed, seconds, traced, device, scene_override=None,
             hold=None):
    """One run of ``cell``; returns the result dict (without printing).
    ``hold``, a dict, is given the run's context and session."""
    import torch

    from benchmark import scenes, seeds, window
    from benchmark.spans import Spans

    device = torch.device(device)
    streams = seeds.streams(seed)
    config = cell.config
    arrays = (scene_override or scenes.build)(config)
    spans = Spans(traced)
    ctx = Context(config, cell.traffic, cell.limits, streams, device, spans,
                  arrays)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    session = cell.request_module().Session(ctx)
    if hold is not None:
        hold.update(ctx=ctx, session=session)
    prof = None
    if traced:
        from benchmark.trace import Profiler
        prof = Profiler()
    i, lat = session.first_request, []
    t_start = time.perf_counter()
    setup_s = _process_age() + (time.time() - _T0)
    with spans("window"):
        while True:
            a = time.perf_counter()
            session.request(i)
            b = time.perf_counter()
            lat.append(b - a)
            i += 1
            if b - t_start >= seconds:
                break
    t_end = b
    trace = prof.stop() if prof else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    stats = window.summarize(lat, session.paths_per_request, t_start, t_end)
    log(f"window: {stats['requests']} requests in {stats['seconds']:.3f} s; "
        f"p50 {stats['p50_ms']:.4f} ms, p95 {stats['p95_ms']:.4f} ms over "
        f"{stats['requests']} requests ({stats['beyond_p95']} beyond it)")
    session.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, extras = session.check()
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    checks, ok = judge(numbers, cell.limits["numbers"])
    for name in sorted(set(numbers) - set(checks)):
        log(f"not compared {name}: {numbers[name]!r}")

    values = dict(stats, setup_s=setup_s)
    metrics = {}
    if not traced:
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": spec.end_to_end_module(m["name"]).read(values),
                "unit": m["unit"]}
    else:
        mctx = dict(trace=trace, stats=stats, extras=extras, arrays=arrays)
        for m in cell.per_layer:
            v = spec.metric_module(m["name"]).read(mctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        missing = [m["name"] for m in cell.per_layer
                   if m["name"] not in metrics]
        if missing:
            raise MetricMissing(
                f"per-layer metrics of {cell.name} read nothing in the "
                f"trace: {missing} (their readers in benchmark/metrics/ "
                f"find no kernel or span of theirs)")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": stats["requests"],
              "failed": 0, "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              trace.top_ops()],
                               "idle_gaps": [list(x) for x in
                                             trace.idle_gaps()]}
    result["checks"] = checks
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        result = run_cell(spec, cell, args.seed, args.seconds,
                          bool(args.trace), "cuda")
    except MetricMissing as e:
        log(str(e))
        return 4
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {found}")
        return 3
    for name, c in result["checks"].items():
        log(f"compared {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
