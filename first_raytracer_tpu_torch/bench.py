"""Benchmark entry of the port: prints ONE JSON line.

Port of the JAX package's ``bench.py`` (run as ``python3 bench_torch.py``
from the repository root).  Headline workload: the random-spheres "final
scene" (486 spheres) at 1200x800 @ 10 spp, depth 50, on one CUDA GPU.
Metric: Mpaths/s (camera paths traced to termination per second); also
Mrays/s (ray segments traced per second, from the kernels' counters).

Switches (environment, as ``bench.py``'s):

- ``BENCH_SCENE``: empty for the final scene, ``fieldN`` for
  ``sphere_field(N)``, ``trifieldN`` for ``triangle_field(N)`` (800x450 @
  4 spp).
- ``BENCH_MODE``: ``mega`` (K1, the default), ``megacluster`` (K3),
  ``wavefront`` (chunks of ``BENCH_CHUNK`` rays), ``regenerative`` (a pool
  of ``BENCH_POOL`` slots) or ``grad`` (record + replay gradient steps).
- ``BENCH_INTERSECT``: the wavefront closest hit, ``pallas`` (K4, the
  final scene's default), ``clustered`` (K5, the fields' default), ``bvh``
  (K6, the flat-BVH walk) or ``brute`` (the dense sweep).
- ``BENCH_REPEATS`` (at least 3), and for ``grad``: ``BENCH_GRAD_RAYS``
  (2^17), ``BENCH_GRAD_METHOD`` (``replay`` or ``scan``),
  ``BENCH_GRAD_REC`` (``mega`` = K2b, ``megacluster`` = K3t, ``pool`` =
  the pool recorder on ``BENCH_INTERSECT``, its loop CUDA graphs on the
  card; by default K2b up to
  ``DENSE_MAX`` spheres and triangles, K3t past it and on the fields),
  ``BENCH_GRAD_POOL`` (2^14), ``BENCH_GRAD_REPLAY`` (``bucketed`` or
  ``flat``) and ``BENCH_GRAD_PIPELINE`` (16 steps timed back to back with
  one synchronize at the end).
- ``BENCH_DEVICE``: ``cuda`` (the default).  ``cpu`` runs the kernels'
  plain versions and is for the tests; without a GPU and without it the
  entry fails, it never carries on on the host.

``BENCH_GATE``, ``BENCH_GRAD_KRAYS`` and ``BENCH_RECORD_GOLDEN`` (TPU
schedules, a TPU tile, and the writing of ``bench_golden.json``) have no
counterpart here and are refused, never ignored.

Packs, plans and scenes are built outside the timed loop.  The timed
``wavefront`` and ``regenerative`` runs replay the loops' CUDA graphs
(``render/graphed.py``); their warm run counts through a
``CountedIntersect`` and so runs eagerly, by ``graphed=False``.
After an untimed warm run (instrumented: segments and work) and one
untimed run (the graphs' capture, for those modes) that
sets how many runs each repeat queues back to back to last about
``MIN_REPEAT_S`` (one synchronize at its end), each repeat's time over its
runs is one sample; ``seconds`` is the median sample, the time of one run
(a frame, or ``BENCH_GRAD_PIPELINE`` steps).  Result guards: the samples
must agree within 3x; in ``mega`` and
``megacluster`` the radiance checksum within 1% of its golden
(``bench_golden.json`` for the final scene, the C++ oracle's
``data/field_goldens_oracle.json`` for the fields; both are only read, and
a missing golden is an error); the FP32 operations the kernels' own
counters say were done (``utils/roofline.py``) over the median time at
most 1.05 x the card's FP32 peak; and on the card, a launch of the mode's
kernel.  On any failure one JSON line with an ``error`` key, exit code 2,
and the history is left alone.  ``vs_baseline`` compares with the best
earlier value of the same configuration on the same card in
``out/bench_torch_history.json`` (git-ignored), 1.0 on a first run.
"""
from __future__ import annotations

import json
import math
import os
import time
import subprocess
import sys
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .accel import traverse
from .core import rng
from .diff import grad as dg
from .diff.replay import live_trips, plan_buckets, record_paths_pool
from .diff import record_pass, replay_pass
from .kernels import dense_hit
from .kernels import intersect_clustered as ic
from .kernels import intersect_pallas as ip
from .kernels import megakernel as mk
from .kernels import megakernel_clustered as mc
from .kernels import record_mega as rm
from .render.api import render_ray_batch
from .render.camera import camera_rays
from .render import wavefront_pass
from .render.integrator import default_intersect
from .render.regenerative import render_rays_regenerative
from .scene.builders import random_scene, sphere_field, triangle_field
from .utils import roofline
from .utils.profiling import time_repeats

__all__ = ["main", "measure", "check_spread", "check_work",
           "check_checksum", "golden_for", "BenchError"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "bench_golden.json")
ORACLE_GOLDENS = os.path.join(ROOT, "first_raytracer_tpu_torch", "data",
                              "field_goldens_oracle.json")
HISTORY = os.path.join(ROOT, "out", "bench_torch_history.json")
MAX_REPEAT_SPREAD = 3.0
# Each timed repeat runs the mode's work back to back until it lasts about
# this long (one synchronize at its end): a 2 ms frame timed alone on the
# host clock moved 11x between repeats on the H100 (PERF.md, PR 9), a
# host stall of the machine's shared cores, not the card's time.
MIN_REPEAT_S = 0.25
# The implied FP32 rate may reach this share of the card's peak: the
# counts are lower bounds of the work, so an honest run stays below 1.
MAX_PEAK_SHARE = 1.05
MODES = ("mega", "megacluster", "wavefront", "regenerative", "grad")
INTERSECTS = ("pallas", "clustered", "bvh", "brute")
UNPORTED = ("BENCH_GATE", "BENCH_GRAD_KRAYS", "BENCH_RECORD_GOLDEN")
# (ID, wrapper, counter attribute) of each kernel's launch counter.
COUNTERS = (("K1", mk.render_pixels_mega, "launches"),
            ("K2", mk.render_pixels_mega, "tape_launches"),
            ("K2b", rm.record_paths_mega, "launches"),
            ("K3", mc.render_pixels_mega_clustered, "launches"),
            ("K3t", rm.record_paths_mega_clustered, "launches"),
            ("K4", ip.intersect_pallas, "launches"),
            ("K5", ic.intersect_clustered, "launches"),
            ("K6", traverse.intersect_bvh, "launches"),
            ("K7", rng.uniforms, "launches"),
            ("K8", camera_rays, "launches"),
            ("K9", wavefront_pass.shade, "launches"),
            ("K10", wavefront_pass.regenerate, "launches"),
            ("K11", dense_hit.dense_hit, "launches"),
            ("K12", record_pass.record_step, "launches"),
            ("K12 (length)", record_pass.record_step, "length_launches"),
            ("K12 (pool)", record_pass.record_shade, "launches"),
            ("K13", record_pass.record_shade, "refill_launches"),
            ("K14", replay_pass.replay, "launches"),
            ("K15", replay_pass.replay, "backward_launches"))
# The closest-hit kernel and wrapper of each BENCH_INTERSECT (the dense
# sweep is K11, ``default_intersect``'s).
INTERSECT_KERNEL = {"pallas": "K4", "clustered": "K5", "bvh": "K6",
                    "brute": "K11"}
INTERSECT_FN = {"pallas": ip.intersect_pallas,
                "clustered": ic.intersect_clustered,
                "bvh": traverse.intersect_bvh}


class BenchError(Exception):
    """A refused run: its reason, and what to print beside it."""

    def __init__(self, reason, **extra):
        super().__init__(reason)
        self.reason, self.extra = reason, extra


def check_spread(times, max_spread=MAX_REPEAT_SPREAD):
    """None if repeat timings agree to ``max_spread``x, else a reason."""
    if max(times) / max(min(times), 1e-12) > max_spread:
        return "repeat timings disagree by >%gx" % max_spread
    return None


def check_work(ops, seconds, peak, max_share=MAX_PEAK_SHARE):
    """None if ``ops`` FP32 operations in ``seconds`` imply a rate the card
    can reach: at most ``max_share`` x its FP32 ``peak``.

    ``ops`` is what the kernels' counters say they did (``utils/
    roofline.py``), a lower bound of their work, so the guard catches a
    timing that returned before the work was done, not inefficiency.
    """
    if not ops:
        return None
    implied = ops / max(seconds, 1e-12)
    if implied > max_share * peak:
        return ("implied FP32 rate %.3g/s is above %g x the card's peak "
                "%.3g/s: physically impossible" % (implied, max_share, peak))
    return None


def check_checksum(checksum, golden, rtol=1e-2):
    """None if the radiance checksum matches the golden to ``rtol``."""
    rel = abs(checksum - golden) / max(abs(golden), 1e-9)
    if not rel < rtol:
        return ("radiance checksum %.6g mismatches golden %.6g "
                "(rel %.3g)" % (checksum, golden, rel))
    return None


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise BenchError(f"cannot read {os.path.relpath(path, ROOT)}: "
                         f"{e}") from None


def golden_for(scene_sel, cfg, seed=0):
    """(radiance sum, source) of the frame's golden: the final scene's
    from ``bench_golden.json``, a field's from the C++ oracle's file.
    Both files are only read; no golden is an error."""
    if not scene_sel:
        gkey = "radiance_sum_mega_%dx%d_%dspp" % (cfg.nx, cfg.ny, cfg.spp)
        gold = _read_json(GOLDEN)
        if gkey not in gold or seed != 0:
            raise BenchError(f"no golden {gkey} (seed {seed}) in "
                             "bench_golden.json")
        return float(gold[gkey]), "bench_golden.json:" + gkey
    entry = _read_json(ORACLE_GOLDENS)["goldens"].get(scene_sel)
    want = (cfg.nx, cfg.ny, cfg.spp, cfg.max_depth, seed)
    if entry is None or want != tuple(entry[k] for k in (
            "nx", "ny", "spp", "max_depth", "seed")):
        raise BenchError(f"no oracle golden for {scene_sel} at "
                         f"{cfg.nx}x{cfg.ny}@{cfg.spp} depth {cfg.max_depth}"
                         f" seed {seed} in field_goldens_oracle.json")
    return float(entry["radiance_sum"]), f"field_goldens_oracle.json:" \
        f"{scene_sel}"


def select_scene(scene_sel, device):
    """(scene, camera, cfg, metric name) of ``BENCH_SCENE``."""
    if scene_sel.startswith("trifield"):
        builder, n = triangle_field, scene_sel[8:]
    elif scene_sel.startswith("field"):
        builder, n = sphere_field, scene_sel[5:]
    elif not scene_sel:
        scene, cam, cfg = random_scene(device=device)
        return scene, cam, cfg, "Mpaths/s final-scene 1200x800@10spp"
    else:
        raise BenchError(f"unknown BENCH_SCENE {scene_sel!r}: empty, "
                         "fieldN or trifieldN")
    if n and not n.isdigit():
        raise BenchError(f"unknown BENCH_SCENE {scene_sel!r}")
    scene, cam, cfg = builder(n=int(n or 20000), device=device)
    return (scene, cam, cfg,
            f"Mpaths/s {scene_sel} {cfg.nx}x{cfg.ny}@{cfg.spp}spp")


def device_line(dev):
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise BenchError(f"nvidia-smi did not report the card: {e}") \
            from None
    return out.strip().splitlines()[0]


def device_peak(dev):
    """The FP32 peak of ``dev``'s card (None on the CPU, which has no
    entry: the plain versions' rate is not a card's)."""
    if dev.type != "cuda":
        return None
    try:
        return roofline.fp32_peak(torch.cuda.get_device_name(dev))
    except KeyError as e:
        raise BenchError(str(e.args[0])) from None


def reset_launches():
    for _, fn, attr in COUNTERS:
        setattr(fn, attr, 0)


def read_launches():
    return {k: getattr(fn, attr) for k, fn, attr in COUNTERS}


class CountedIntersect:
    """An ``intersect_fn`` that counts the FP32 operations of the closest
    hits it computes: K4's rays x rows, K5's and K6's nodes and slots from
    their counters (summed on the device), the dense sweep's swept rays x
    primitives at K4's counts; none for the plain walk on the CPU, which
    keeps no counters.  It takes the loop bodies' liveness mask as
    ``default_intersect`` does (``takes_alive``): K11 sweeps only the live
    rays, so only theirs are counted (summed on the device)."""

    takes_alive = True

    def __init__(self, kind, scene, accel):
        self.kind, self.scene, self.accel = kind, scene, accel
        self.rays, self.sweeps, self.walk = 0, None, None

    def __call__(self, scene, accel, o, d, t_min, alive=None):
        if self.kind == "brute" and alive is not None:
            self.rays = alive.sum() + self.rays
            return default_intersect(scene, accel, o, d, t_min, alive)
        self.rays += o.shape[0]
        if self.kind == "clustered":
            prim, t, hit, sweeps = ic.intersect_clustered(
                scene, accel, o, d, t_min, return_iters=True)
            s = sweeps.long().sum(0)
            self.sweeps = s if self.sweeps is None else self.sweeps + s
            return prim, t, hit
        if self.kind == "pallas":
            return ip.intersect_pallas(scene, accel, o, d, t_min)
        if self.kind == "bvh" and accel.device.type == "cuda":
            prim, t, hit, walk = traverse.intersect_bvh(
                scene, accel, o, d, t_min, return_counters=True)
            s = walk.long().sum(0)
            self.walk = s if self.walk is None else self.walk + s
            return prim, t, hit
        return default_intersect(scene, accel, o, d, t_min)

    def ops(self):
        if self.kind == "clustered":
            return 0 if self.sweeps is None else roofline.k5_ops(
                self.sweeps.tolist())
        if self.kind == "pallas":
            return roofline.intersect_ops(self.accel, self.rays)
        if self.kind == "bvh":
            return 0 if self.walk is None else roofline.k6_ops(
                self.walk.tolist())
        if self.kind == "brute":
            return int(self.rays) * (
                self.scene.num_spheres * roofline.OC_SPHERE_OPS
                + self.scene.num_triangles * roofline.MT_TRIANGLE_OPS)
        return 0


@dataclass
class Plan:
    """One mode's timed run and its untimed instrumentation.

    ``run(intersect_fn)`` is the timed work; the warm run calls it with a
    ``CountedIntersect``.  ``count(warm_out)`` returns (segments, FP32
    operations or None for the ``CountedIntersect``'s, radiance checksum
    or None) of one run."""

    run: Callable
    count: Callable
    total: int
    kernel: Optional[str]


@dataclass
class Measurement:
    """What ``measure`` read: the line's numbers and the guards' inputs."""

    metric: str
    mode: str
    intersect: str
    device: str
    history_key: str
    total: int
    times: list
    seconds: float
    segments: int
    ops: int
    checksum: Optional[float]
    golden: Optional[tuple]
    peak: Optional[float]
    kernel: Optional[str]
    launches: dict


def _int_env(env, name, default):
    try:
        return int(env.get(name, default))
    except ValueError:
        raise BenchError(f"{name} must be an integer") from None


def _choice(env, name, default, allowed):
    value = env.get(name, default)
    if value not in allowed:
        raise BenchError(f"unknown {name} {value!r}: one of "
                         f"{', '.join(allowed)}")
    return value


def _dense_only(scene, what):
    if max(scene.num_spheres, scene.num_triangles) > mk.DENSE_MAX:
        raise BenchError(
            f"{what}: the scene has {scene.num_spheres} spheres and "
            f"{scene.num_triangles} triangles, past DENSE_MAX = "
            f"{mk.DENSE_MAX} (kernels/megakernel.py), where the dense "
            "kernels sweep every primitive for each segment; use "
            "BENCH_MODE=megacluster")


def _accel(scene, isect):
    """The wavefront closest hit's accel of ``BENCH_INTERSECT``."""
    if isect == "pallas":
        return ip.pack_scene_pallas(scene)
    if isect == "clustered":
        return ic.pack_scene_clustered(scene)
    if isect == "bvh":
        print("# NOTE: BENCH_INTERSECT=bvh: the closest hit is K6, the "
              "flat-BVH walk (build_bvh(max_leaf=4)).", file=sys.stderr)
        from .accel.build import build_bvh
        return build_bvh(scene, max_leaf=4)
    return None


def _graphed(fn):
    """Whether a wavefront run replays the loops' CUDA graphs: not through
    a ``CountedIntersect`` (host state), which runs eagerly."""
    return not isinstance(fn, CountedIntersect)


def _segments_pass(scene, cam, cfg, key, num_rays, chunk, accel):
    """Segments of ray ids [0, num_rays) through the wavefront integrator
    in chunks: the untimed instrumented pass of ``bench.py``."""
    total = 0
    for lo in range(0, num_rays, chunk):
        ids = torch.arange(lo, min(lo + chunk, num_rays),
                           device=scene.device)
        _, segs = render_ray_batch(scene, cam, cfg, key, ids, accel,
                                   return_stats=True)
        total += int(segs.long().sum())
    return total


def _plan_grad(env, scene_sel, scene, cam, cfg, key, isect, chunk):
    """``grad``: value and gradient of a zero-target MSE pixel loss with
    respect to every ``DIFF_FIELDS`` leaf over ``BENCH_GRAD_RAYS`` rays.
    Returns the ``Plan`` and the accel of the pool recorder or the scan
    (None for the megakernel recorders)."""
    R = _int_env(env, "BENCH_GRAD_RAYS", 1 << 17)
    method = _choice(env, "BENCH_GRAD_METHOD", "replay", ("replay", "scan"))
    dev = scene.device
    ids = torch.arange(R, device=dev)
    params, _ = dg.split_params(scene)
    target = torch.zeros((R, 3), dtype=torch.float32, device=dev)

    if method == "scan":
        accel = _accel(scene, isect)

        def run(fn):
            return dg.render_loss_and_grads(params, scene, cam, cfg, key,
                                            ids, target, accel,
                                            intersect_fn=fn, method="scan")

        def count(_):
            return (_segments_pass(scene, cam, cfg, key, R, chunk, accel),
                    None, None)
        return Plan(run, count, R, INTERSECT_KERNEL[isect]), accel

    accel = None
    big = max(scene.num_spheres, scene.num_triangles) > mk.DENSE_MAX
    rec_kind = _choice(env, "BENCH_GRAD_REC",
                       "megacluster" if big or scene_sel else "mega",
                       ("mega", "megacluster", "pool"))
    if rec_kind == "mega":
        _dense_only(scene, "BENCH_GRAD_REC=mega")
        gpack = mk.pack_scene_mega(scene)
        kernel = "K2b"

        def rec_tape(fn=None, iters=False):
            return rm.record_paths_mega(gpack, cam, cfg, key, num_rays=R,
                                        return_iters=iters)

        def rec_counts():
            _, trips = rec_tape(iters=True)
            trips = int(trips.long().sum())
            return trips, roofline.dense_ops(gpack, trips)
    elif rec_kind == "megacluster":
        cgpack = mc.pack_scene_mega_clustered(scene, cam)
        kernel = "K3t"

        def rec_tape(fn=None, iters=False):
            return rm.record_paths_mega_clustered(cgpack, cam, cfg, key,
                                                  num_rays=R,
                                                  return_iters=iters)

        def rec_counts():
            _, trips, sweeps = rec_tape(iters=True)
            return (int(trips.long().sum()),
                    roofline.clustered_ops(sweeps.long().sum(0).tolist()))
    else:
        gpool = _int_env(env, "BENCH_GRAD_POOL", 1 << 14)
        accel = _accel(scene, isect)
        kernel = INTERSECT_KERNEL[isect]

        def rec_tape(fn=INTERSECT_FN.get(isect)):
            return record_paths_pool(scene, cam, cfg, key, ids, accel, fn,
                                     pool_size=gpool,
                                     graphed=_graphed(fn))

        def rec_counts():
            return _segments_pass(scene, cam, cfg, key, R, chunk,
                                  accel), None

    pipe = max(1, _int_env(env, "BENCH_GRAD_PIPELINE", 16))
    replay = _choice(env, "BENCH_GRAD_REPLAY", "bucketed",
                     ("bucketed", "flat"))
    # The tape is data-deterministic (fixed seed), so the plan (host NumPy)
    # and the trim depth are computed once, outside the timed loop.
    if replay == "bucketed":
        plan = plan_buckets(rec_tape())

        def step(fn):
            tape = rec_tape(fn)
            return dg.render_loss_and_grads_bucketed(
                params, scene, cam, cfg, key, ids, target, tape, plan=plan)
    else:
        trips = live_trips(rec_tape())

        def step(fn):
            tape = rec_tape(fn)
            return dg.render_loss_and_grads_tape(
                params, scene, cam, cfg, key, ids, target, tape[:trips])

    def run(fn):
        return [step(fn) for _ in range(pipe)]

    def count(_):
        # The pipeline repeats the same R ray ids: count them once and
        # scale by the repetitions (ADVICE r5).  The pool recorder's
        # operations are the CountedIntersect's over the whole run.
        segments, ops = rec_counts()
        return segments * pipe, None if ops is None else ops * pipe, None

    return Plan(run, count, R * pipe, kernel), accel


def _plan(env, mode, scene_sel, scene, cam, cfg, key, isect):
    """The ``Plan`` of ``mode``, its packs built here, outside the timed
    loop, and the accel its ``CountedIntersect`` counts on."""
    total = cfg.num_rays
    chunk = min(_int_env(env, "BENCH_CHUNK", 1 << 17), total)
    if mode == "mega":
        _dense_only(scene, "BENCH_MODE=mega")
        pack = mk.pack_scene_mega(scene)

        def count(out):
            segments = int(out[1].long().sum())
            return (segments, roofline.dense_ops(pack, segments),
                    float(out[0].double().sum()))
        return Plan(lambda fn: mk.render_pixels_mega(pack, cam, cfg, key),
                    count, total, "K1"), None
    if mode == "megacluster":
        cpak = mc.pack_scene_mega_clustered(scene, cam)

        def count(out):
            return (int(out[1].long().sum()),
                    roofline.clustered_ops(out[2].long().sum(0).tolist()),
                    float(out[0].double().sum()))
        return Plan(lambda fn: mc.render_pixels_mega_clustered(
            cpak, cam, cfg, key, return_iters=True), count, total,
            "K3"), None
    if mode == "grad":
        return _plan_grad(env, scene_sel, scene, cam, cfg, key, isect, chunk)

    accel = _accel(scene, isect)
    kernel = INTERSECT_KERNEL[isect]
    if mode == "regenerative":
        pool = _int_env(env, "BENCH_POOL", 1 << 17)

        def run(fn):
            return render_rays_regenerative(
                scene, cam, cfg, key, 0, total, accel, fn, pool_size=pool,
                return_stats=isinstance(fn, CountedIntersect),
                graphed=_graphed(fn))

        def count(out):
            return int(out[1].long().sum()), None, None
        return Plan(run, count, total, kernel), accel

    blocks = [torch.arange(lo, lo + chunk, device=scene.device).clamp(
        max=total - 1) for lo in range(0, total, chunk)]

    def run(fn):
        stats = isinstance(fn, CountedIntersect)
        outs = [render_ray_batch(scene, cam, cfg, key, b, accel, fn,
                                 return_stats=stats,
                                 graphed=_graphed(fn))
                for b in blocks]
        if not stats:
            return outs[-1]
        # The last block repeats ray total - 1 past the frame: count the
        # frame's rays once.
        return outs[-1][0], sum(int(segs[:total - lo].long().sum())
                                for (_, segs), lo in zip(
                                    outs, range(0, total, chunk)))

    def count(out):
        return out[1], None, None
    return Plan(run, count, total, kernel), accel


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def runs_per_repeat(run, fn, dev):
    """How many runs a timed repeat queues back to back to last
    ``MIN_REPEAT_S``, from the host-clock time of one untimed run."""
    t0 = time.perf_counter()
    run(fn)
    _sync(dev)
    once = time.perf_counter() - t0
    return max(1, math.ceil(MIN_REPEAT_S / max(once, 1e-9)))


def measure(env=None) -> Measurement:
    """Runs the configuration the switches in ``env`` (``os.environ`` by
    default) select and returns its ``Measurement``; raises ``BenchError``
    where the run cannot be made."""
    env = os.environ if env is None else env
    for name in UNPORTED:
        if name in env:
            raise BenchError(
                f"{name} has no counterpart in the port (ROADMAP.md, "
                "'Not ported, on purpose'); unset it")
    dev = torch.device(env.get("BENCH_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BenchError("no CUDA device: the bench runs on the card "
                         "(BENCH_DEVICE=cpu runs the plain versions, for "
                         "the tests)")
    if dev.type not in ("cuda", "cpu"):
        raise BenchError(f"BENCH_DEVICE {dev} is neither cuda nor cpu")
    scene_sel = env.get("BENCH_SCENE", "")
    mode = _choice(env, "BENCH_MODE", "mega", MODES)
    isect = _choice(env, "BENCH_INTERSECT",
                    "clustered" if scene_sel else "pallas", INTERSECTS)
    repeats = max(3, _int_env(env, "BENCH_REPEATS", 3))
    card = device_line(dev)
    peak = device_peak(dev)

    scene, cam, cfg, metric = select_scene(scene_sel, dev)
    key = rng.base_key(0)
    golden = (golden_for(scene_sel, cfg)
              if mode in ("mega", "megacluster") else None)
    plan, accel = _plan(env, mode, scene_sel, scene, cam, cfg, key, isect)
    counted = CountedIntersect(isect, scene, accel)

    reset_launches()
    warm = plan.run(counted)  # builds the kernels at first use; untimed
    _sync(dev)
    fn = INTERSECT_FN.get(isect)
    frames = runs_per_repeat(plan.run, fn, dev)

    def repeat(fn):
        for _ in range(frames - 1):
            plan.run(fn)
        return plan.run(fn)
    times = sorted(t / frames for t in time_repeats(repeat, fn,
                                                    repeats=repeats))
    launches = read_launches()
    segments, ops, checksum = plan.count(warm)
    if ops is None:
        ops = counted.ops()
    history_key = "/".join(filter(None, (scene_sel or "final", mode,
                                         _detail(env, mode, isect))))
    return Measurement(metric, mode, isect, card, history_key, plan.total,
                       times, times[len(times) // 2], segments, ops,
                       checksum, golden, peak, plan.kernel, launches)


def _detail(env, mode, isect):
    """What else the history keys a configuration by."""
    if mode in ("mega", "megacluster"):
        return ""
    if mode == "wavefront":
        return f"{isect}-chunk{env.get('BENCH_CHUNK', 1 << 17)}"
    if mode == "regenerative":
        return f"{isect}-pool{env.get('BENCH_POOL', 1 << 17)}"
    return "-".join(str(env.get(k, d)) for k, d in (
        ("BENCH_GRAD_METHOD", "replay"), ("BENCH_GRAD_REC", "default"),
        ("BENCH_GRAD_REPLAY", "bucketed"), ("BENCH_GRAD_RAYS", 1 << 17),
        ("BENCH_GRAD_PIPELINE", 16))) + f"-{isect}"


def guard(m: Measurement):
    """The result guards on a ``Measurement``; raises ``BenchError``."""
    err = check_spread(m.times)
    if err:
        raise BenchError(err, times=m.times)
    if m.golden is not None:
        err = check_checksum(m.checksum, m.golden[0])
        if err:
            raise BenchError(err, golden=m.golden[1])
    if m.peak is not None:
        err = check_work(m.ops, m.seconds, m.peak)
        if err:
            raise BenchError(err, ops=m.ops, seconds=m.seconds)
    if m.device != "cpu" and m.kernel and m.launches[m.kernel] < 1:
        raise BenchError(f"the run launched no {m.kernel}",
                         launches=m.launches)


def record_history(m: Measurement, mpaths: float) -> float:
    """``vs_baseline`` against the best earlier value of the same
    configuration on the same card, then that best updated."""
    hist = {}
    if os.path.exists(HISTORY):
        hist = _read_json(HISTORY)
    card = hist.setdefault(m.device, {})
    prev = card.get(m.history_key)
    card[m.history_key] = max(mpaths, prev or 0.0)
    os.makedirs(os.path.dirname(HISTORY), exist_ok=True)
    with open(HISTORY, "w") as f:
        json.dump(hist, f, indent=1)
    return mpaths / prev if prev else 1.0


def main(env=None) -> int:
    """Prints the one JSON line; returns the exit code (2 on any refused
    run)."""
    try:
        m = measure(env)
        guard(m)
        mpaths = m.total / m.seconds / 1e6
        vs = record_history(m, mpaths)
    except BenchError as e:
        print(json.dumps(dict(error=e.reason, **e.extra)))
        return 2
    print(json.dumps({
        "metric": m.metric,
        "value": mpaths,
        "unit": "Mpaths/s",
        "vs_baseline": vs,
        "mrays_s": m.segments / m.seconds / 1e6,
        "seconds": m.seconds,
        "mode": m.mode,
        "intersect": m.intersect,
        "device": m.device,
        "launches": m.launches,
    }))
    return 0
