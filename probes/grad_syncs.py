"""The host synchronizations of the gradient step, by part.

Builds the bench's grad configuration (``BENCH_MODE=grad``; the scene
from ``--scene``, empty for the final scene) and counts, under
``torch.cuda.set_sync_debug_mode("warn")``, the synchronizing CUDA calls
that each part of one step makes after a warm run of it:

- ``record``: the recorder's wrapper (K2b on the final scene, K3t on a
  field), ``diff.grad.tape_recorder``'s choice;
- ``plan``: ``plan_buckets`` (host NumPy: it reads the tape back, once a
  step, before the replay);
- ``replay``: ``render_loss_and_grads_bucketed`` on that tape and plan,
  the value and gradient (on the card, a replay of its CUDA graph);
- ``bench_step``: the bench's whole step as ``bench_torch.py`` runs it (its
  plan is made once, outside the timed loop);
- the direct step (``cli fit`` without ``--fast``; the dense sweep on the
  final scene, K5 on a field): ``direct_record`` (``record_tape``, the
  lockstep recorder's loop: on the card its CUDA graphs, whose one read
  of the alive flag a block of passes waits on an event, which the debug
  mode does not count; ``direct_record`` also gives the flag reads the
  loop counted), ``direct_replay`` (the whole tape's value and gradient,
  ``render_loss_and_grads_tape``), ``direct_step``
  (``render_loss_and_grads``) and ``fit_step`` (a ``make_fit_step`` step
  with Adam, its optimizer's step outside the graphs).

Prints one JSON line with each part's count and the source lines that
made them.  A replay without any can be queued back to back with the
next step's work; each one found makes the host wait for the card.

    python probes/grad_syncs.py                    # final scene, K2b
    python probes/grad_syncs.py --scene field5000  # K3t
"""
import argparse
import collections
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from first_raytracer_tpu_torch import bench  # noqa: E402
from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.diff import grad as dg  # noqa: E402
from first_raytracer_tpu_torch.diff.replay import plan_buckets  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic  # noqa: E402,E501
from first_raytracer_tpu_torch.render.graphed import LOOPS  # noqa: E402


def syncs(fn):
    """The synchronizing calls of ``fn`` after a warm run: (count, {site:
    count})."""
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # Not torch's one-time notice that the mode is a prototype.
    found = [w for w in caught
             if "called a synchronizing" in str(w.message)]
    return len(found), dict(collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in found))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="")
    args = ap.parse_args()
    dev = torch.device("cuda")
    env = {"BENCH_MODE": "grad", "BENCH_SCENE": args.scene,
           "BENCH_GRAD_PIPELINE": "1"}
    scene, cam, cfg, _ = bench.select_scene(args.scene, dev)
    key = rng.base_key(0)
    isect = "clustered" if args.scene else "pallas"
    plan, _ = bench._plan(env, "grad", args.scene, scene, cam, cfg, key,
                          isect)
    R = 1 << 17
    ids = torch.arange(R, device=dev)
    target = torch.zeros((R, 3), device=dev)
    params, _ = dg.split_params(scene)
    record = dg.tape_recorder(scene, cam, cfg, ids, dev)
    tape = record(scene, key)
    buckets = plan_buckets(tape)
    parts = {
        "record": lambda: record(scene, key),
        "plan": lambda: plan_buckets(tape),
        "replay": lambda: dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, tape, plan=buckets),
        "bench_step": lambda: plan.run(bench.INTERSECT_FN[isect]),
    }
    accel = ic.pack_scene_clustered(scene) if args.scene else None
    fit_params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
    fit = dg.make_fit_step(scene, cam, cfg, ids, target,
                           dg.make_optimizer("adam", fit_params, 1e-4),
                           accel=accel, device=dev)
    direct_tape = dg.record_tape(params, scene, cam, cfg, key, ids, accel)
    parts.update({
        "direct_record": lambda: dg.record_tape(params, scene, cam, cfg,
                                                key, ids, accel),
        "direct_replay": lambda: dg.render_loss_and_grads_tape(
            params, scene, cam, cfg, key, ids, target, direct_tape),
        "direct_step": lambda: dg.render_loss_and_grads(
            params, scene, cam, cfg, key, ids, target, accel),
        "fit_step": lambda: fit(fit_params, key),
    })
    out = {"scene": args.scene or "final", "kernel": plan.kernel}
    for name, fn in parts.items():
        reads = LOOPS.syncs
        out[name] = dict(zip(("syncs", "sites"), syncs(fn)))
        if name.startswith("direct") or name == "fit_step":
            # The loop's flag reads over the warm run and the counted one.
            out[name]["flag_reads"] = (LOOPS.syncs - reads) // 2
    out["graphs"] = {"captures": dg.GRAPHS.captures,
                     "replays": dg.GRAPHS.replays}
    out["loops"] = {"captures": LOOPS.captures, "replays": LOOPS.replays}
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
