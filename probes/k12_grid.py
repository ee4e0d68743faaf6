"""K12's design constants, tried on the card.

``kernels/csrc/wavefront_pass.cu`` fixes ``kStepWindow`` (the rays a block
of the lockstep and length modes takes and packs), ``kStepRays`` (the live
rays a thread shades at most; the block's threads are their quotient) and
``kRecordTile`` (the slots a tile of the pool mode's scan, a thread each,
with K13's refill in the same launch).  This probe builds a copy of the
source for each variant in ``VARIANTS`` (one nvcc each, all started
together, into ``out/k12_grid/``), prints each one's ptxas lines of the
two kernels, runs every variant through the package's own wrappers (its
library in place of the package's, and ``record_pass.RECORD_TILE`` set to
its tile), checks each against the plain seams (``record_step_plain``;
``record_shade_plain`` then ``record_regenerate_plain``), ``torch.equal``
on every tensor of the state (the flat tape's last entry aside) on every
input below (but a timed-only variant's), and times each with
``probes/record_pass.py``'s ``StateClock`` (20 calls a CUDA graph, each
restoring what it moves, the restores' own graph taken off, median of 5
replays); it also times the counter's add alone, the graph node that the
bodies had before K12 advanced the counter itself:

- lockstep and length modes at the first bounce of the final scene's 2^17
  camera rays, with liveness masks of live shares 1, 0.43, 0.1, 0.03,
  0.01 and 0 (from a numpy seed);
- lockstep mode summed over the lockstep recorder's bounces on those rays
  (each bounce's state and K11's closest hit, as the direct step runs
  them);
- the pool mode (with K13's refill) after one pass at 2^14 slots over
  2^17 ids (the direct step's ``record_pool``) and at 2^17 over 2^19.

Each column's bound (``utils/roofline.py::k12_bound`` on that input) and
the card's name and power limit are printed under the table.  Run from
the repository root on a GPU host (~3 min):

    python probes/k12_grid.py
"""
import contextlib
import ctypes
import os
import re
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from record_pass import (StateClock, capture, direct_bounces,  # noqa: E402
                         live_mask, replay_ms, step_moved)

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.diff import record_pass as rp  # noqa: E402
from first_raytracer_tpu_torch.diff import replay as rrep  # noqa: E402
from first_raytracer_tpu_torch.kernels import dense_hit as dh  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.kernels.build import (CSRC_DIR,  # noqa: E402
                                                     NVCC_FLAGS, _nvcc)
from first_raytracer_tpu_torch.render.camera import camera_rays  # noqa: E402,E501
from first_raytracer_tpu_torch.render.integrator import (  # noqa: E402
    default_intersect)
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501
from first_raytracer_tpu_torch.utils.roofline import k12_bound  # noqa: E402

RAYS = 1 << 17
SHARES = (1.0, 0.43, 0.1, 0.03, 0.01, 0.0)
POOLS = ((1 << 14, RAYS), (RAYS, 4 * RAYS))  # (slots, ids)
# (rays a window, rays a thread, slots a pool tile, edit): the edit's
# variants are timed only, not checked: "no arrival" leaves the counter's
# arrival and advance out of the lockstep kernel (the clock restores the
# counter, so the times stay those of the same bounce); "relaxed arrival"
# drops the arrival's acquire and release semantics.
ARRIVAL = "    arrived = arrive(q.arrivals);\n"
ACQ_REL, RELAXED = "atom.acq_rel.gpu.global", "atom.relaxed.gpu.global"
VARIANTS = [(256, 1, 256, None), (256, 2, 256, None), (512, 1, 256, None),
            (512, 2, 256, None), (1024, 1, 256, None), (1024, 2, 256, None),
            (512, 2, 128, None),
            (256, 1, 256, ("no arrival", ARRIVAL, "    arrived = 1;\n")),
            (256, 1, 256, ("relaxed arrival", ACQ_REL, RELAXED))]
OUT = os.path.join(ROOT, "out", "k12_grid")
CONSTANTS = ("kStepWindow", "kStepRays", "kRecordTile")


def name(v):
    return f"w{v[0]}x{v[1]}_t{v[2]}" + (f" {v[3][0]}" if v[3] else "")


def build_all():
    """One nvcc per variant, all at once; returns {variant: (dll, log)}."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(CSRC_DIR, "wavefront_pass.cu")) as f:
        src = f.read()
    procs = {}
    for v in VARIANTS:
        text = src
        for const, value in zip(CONSTANTS, v):
            pattern = rf"constexpr int {const} = \d+;"
            if len(re.findall(pattern, text)) != 1:
                raise RuntimeError(f"{const} was not found once")
            text = re.sub(pattern, f"constexpr int {const} = {value};", text)
        if v[3]:
            _, old, new = v[3]
            if text.count(old) != 1:
                raise RuntimeError(f"{name(v)}: the edit was not found once")
            text = text.replace(old, new)
        tag = name(v).replace(" ", "_")
        path = os.path.join(OUT, f"wavefront_pass_{tag}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"libk12_{tag}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *mk.NVCC_EXTRA_FLAGS, "-I", CSRC_DIR,
               "-o", lib, path]
        procs[v] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for v, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name(v)}:\n{log}")
        out[v] = (mk.bind_wavefront_pass(ctypes.CDLL(lib)), log)
    return out


def ptxas(log):
    """ptxas's register and spill lines of K12's two kernels."""
    out, inside = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = next((k for k in ("record_step_kernel",
                                       "record_pool_kernel") if k in line),
                          None)
        elif inside and ("registers" in line or "spill" in line):
            out.append(f"{inside}: {line.split(':', 1)[-1].strip()}")
    return out


@contextlib.contextmanager
def variant(dll, tile):
    """The package's wrappers launching ``dll``'s K12 (the other kernels
    the package's own), the pool's scan sized for ``tile``."""
    saved = mk.launch_entry, rp.RECORD_TILE

    def entry(dev, fn, *args):
        if fn not in ("frt_record_step", "frt_record_pool"):
            return saved[0](dev, fn, *args)
        with torch.cuda.device(dev):
            err = getattr(dll, fn)(
                *args, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"{fn} failed ({err})")
    mk.launch_entry, rp.RECORD_TILE = entry, tile
    try:
        yield
    finally:
        mk.launch_entry, rp.RECORD_TILE = saved


def same(what, got, want):
    """Every tensor of ``want`` equal to ``got``'s but the scan words and
    the flat tape's last entry (the plain pool's scratch)."""
    for k, v in want.items():
        a, b = got[k], v
        if k == "scan":
            continue
        if k == "tape" and a.dim() == 1:
            a, b = a[:-1], b[:-1]
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {k} differs from the plain seam")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/k12_grid.py: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    libs = build_all()
    for v, (_, log) in libs.items():
        print(f"{name(v)}: " + "; ".join(ptxas(log)), flush=True)
    dev = torch.device("cuda")
    key = rng.base_key(0).to(dev)
    scene, cam, cfg = build_preset("random-spheres", device=dev)
    ids = torch.arange(RAYS, device=dev)
    kw = dict(scene=scene, key=key, ray_ids=ids, cfg=cfg)
    o, d = camera_rays(cam, cfg.nx, cfg.ny, cfg.spp, key, ids)
    prim, _, hit = dh.dense_hit(scene, o, d, cfg.t_min)
    masks = {s: live_mask(torch, RAYS, s, dev) for s in SHARES}
    bounces = direct_bounces(torch, rrep, dh, default_intersect, scene, cfg,
                             key, o, d)

    def step(work, p, h):
        rp.record_step(work, p, h, **kw)

    def pool_call(work, p, h, pids):
        rp.record_shade(work, p, h, camera=cam, **dict(kw, ray_ids=pids))

    def pool_inputs():
        """Each pool after one pass, with K11's closest hit of its rays."""
        out = []
        for slots, n in POOLS:
            pids = torch.arange(n, device=dev)
            state = rrep.record_pool_state(cam, key, pids, cfg=cfg,
                                           pool_size=slots)
            rrep.record_pool_pass(state, camera=cam, accel=None, **dict(
                kw, ray_ids=pids), intersect_fn=default_intersect)
            p, _, h = dh.dense_hit(scene, state["o"], state["d"], cfg.t_min,
                                   state["alive"])
            out.append((slots, pids, state, p, h))
        return out

    # Bounds, from the plain seams' results on each input.
    bounds = {}
    for mode in ("lockstep", "length"):
        for s in SHARES:
            state = rrep.record_state(o, d, cfg=cfg, tape=mode == "lockstep")
            state["alive"].copy_(masks[s])
            if mode == "length":
                state["length"] = torch.zeros((RAYS,), dtype=torch.int64,
                                              device=dev)
            rp.record_step_plain(state, prim, hit, **kw)
            live = int(masks[s].sum())
            bounds[f"{mode} {s}"] = k12_bound(
                scene, RAYS, live, int(state["alive"].sum()),
                int((masks[s] & hit).sum()), mode)[0]
    total = 0.0
    for b, (p, h) in bounces:
        state = dict(rrep.record_state(o, d, cfg=cfg), **b)
        live = int(b["alive"].sum()) if int(b["d"]) <= cfg.max_depth else 0
        rp.record_step_plain(state, p, h, **kw)
        total += k12_bound(scene, RAYS, live, int(state["alive"].sum()),
                           int((b["alive"] & h).sum()), "lockstep")[0]
    bounds["direct step's bounces"] = total

    rows = {}
    for v, (dll, _) in libs.items():
        check = same if v[3] is None else (lambda *args: None)
        with variant(dll, v[2]):
            row = rows[v] = {}
            for mode in ("lockstep", "length"):
                first = rrep.record_state(o, d, cfg=cfg,
                                          tape=mode == "lockstep")
                if mode == "length":
                    first["length"] = torch.zeros((RAYS,), dtype=torch.int64,
                                                  device=dev)
                for s in SHARES:
                    got = dict(first, alive=masks[s])
                    got = {k: t.clone() for k, t in got.items()}
                    want = {k: t.clone() for k, t in got.items()}
                    step(got, prim, hit)
                    rp.record_step_plain(want, prim, hit, **kw)
                    check(f"{name(v)}, {mode} at {s} live", got, want)
                clock = StateClock(torch, step, first, (prim, hit),
                                   step_moved(first))
                for s in SHARES:
                    row[f"{mode} {s}"] = clock.ms(dict(first, alive=masks[s]),
                                                  (prim, hit))
            lock = rrep.record_state(o, d, cfg=cfg)
            for j, (b, (p, h)) in enumerate(bounces):
                got = {k: t.clone() for k, t in dict(lock, **b).items()}
                want = {k: t.clone() for k, t in got.items()}
                step(got, p, h)
                rp.record_step_plain(want, p, h, **kw)
                check(f"{name(v)}, the direct step's bounce {j}", got,
                      want)
            clock = StateClock(torch, step, lock, bounces[0][1],
                               step_moved(lock))
            row["direct step's bounces"] = sum(
                clock.ms(b, hits, repeats=3) for b, hits in bounces)
            for slots, pids, state, p, h in pool_inputs():
                got = {k: t.clone() for k, t in state.items()}
                want = {k: t.clone() for k, t in state.items()}
                pool_call(got, p, h, pids)
                rp.record_shade_plain(want, p, h, **dict(kw, ray_ids=pids))
                rp.record_regenerate_plain(want, camera=cam,
                                           **dict(kw, ray_ids=pids))
                check(f"{name(v)}, the pool of {slots}", got, want)
                clock = StateClock(
                    torch, lambda w, a, b, pids=pids: pool_call(w, a, b,
                                                                pids),
                    state, (p, h), tuple(rp.RECORD_ROWS) + ("cursor",))
                row[f"pool {slots}"] = clock.ms(state, (p, h))
                if v == VARIANTS[0]:
                    live = int(state["alive"].sum())
                    bounds[f"pool {slots}"] = k12_bound(
                        scene, slots, live, int(want["record"][0]),
                        int((state["alive"] & h).sum()), "pool")[0]
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    add_ms = replay_ms(torch, capture(torch, lambda: counter.add_(1), 20),
                       5) / 20
    print(f"every variant but the timed-only ones equal to the plain seams "
          f"on {2 * len(SHARES)} masked first bounces, {len(bounces)} "
          f"direct-step bounces and {len(POOLS)} pools; the counter's add "
          f"alone, a graph node (20 a graph): {add_ms:.5f} ms", flush=True)
    cols = list(rows[VARIANTS[0]])
    print("variant | " + " | ".join(cols) + " (ms)", flush=True)
    for v, row in rows.items():
        print(f"{name(v)} | " + " | ".join(f"{row[c]:.5f}" for c in cols),
              flush=True)
    print("bound | " + " | ".join(f"{bounds[c]:.5f}" for c in cols) +
          f"; {len(bounces)} bounces; on {card}", flush=True)


if __name__ == "__main__":
    main()
