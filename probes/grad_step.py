"""The record->replay gradient step of one checkout, for comparing commits.

On the final scene (random-spheres, 1200x800 @ 10, depth 50; or
``--scene field5000``, 800x450 @ 4) at ray ids [0, 2^17), zero target,
every differentiable field (``chip_smoke.py`` phase 6's step, and phase
10's scene): ``tape_recorder``'s kernel (K2b, or K3t on the field)
records the tape, ``plan_buckets`` sorts it, and
``render_loss_and_grads_bucketed`` differentiates the bucketed replay (on
the card a replay of its CUDA graph, where the checkout has one).
Prints one JSON line: the host seconds of the whole step and of the
replay's value and gradient alone (each the median of 5 after a warm
step, with all 5), the peak device memory of one step, and the loss and
the largest albedo gradient (so that two checkouts can be seen to
compute the same step).  Where the checkout has the eager body
(``bucketed_loss_and_grads``), the same for it (``eager_*``) in turns
with the graph, and the graph's capture (warm-up and capture seconds,
pool bytes).

``--fit N`` then runs N steps of ``make_fit_step_replay`` (Adam, lr 1e-2,
every field, zero target, the fixed seed's key) and reports each step's
host seconds (the plan counted apart, outside them), the graphs captured,
warmed up and replayed, and the distinct plans (groups) the steps met.

Run from the repository root on a GPU host, each checkout in its own
process, in turns (parent, change, change, parent):

    git archive <parent> | tar -x -C out/parent
    for t in out/parent . . out/parent; do
        python probes/grad_step.py $t; done

The checkout's own package is imported (its path goes first on
sys.path), so the parent is measured with its own replay and kernels.
"""
import argparse
import json
import statistics
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("checkout")
ap.add_argument("--scene", default="final", choices=("final", "field5000"))
ap.add_argument("--fit", type=int, default=0)
ARGS = ap.parse_args()
sys.path.insert(0, ARGS.checkout)

import torch  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.diff import grad as dg  # noqa: E402
from first_raytracer_tpu_torch.diff.replay import plan_buckets  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402,E501

RAYS = 1 << 17


def seconds(fns, repeats=5):
    """Sorted host seconds of each of ``fns`` (a dict) and the work it
    queued, ``repeats`` runs after a warm one, the functions in turns."""
    for fn in fns.values():
        fn()
    out = {k: [] for k in fns}
    for r in range(repeats):
        names = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for k in names:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            out[k].append(time.perf_counter() - t0)
    return {k: sorted(v) for k, v in out.items()}


def peak_gb(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9, out


def main():
    dev = torch.device("cuda")
    if ARGS.scene == "final":
        scene, cam, cfg = build_preset("random-spheres", device=dev)
    else:
        scene, cam, cfg = build_preset("sphere-field", n=5000, nx=800,
                                       ny=450, spp=4, device=dev)
    key = rng.base_key(0)
    ids = torch.arange(RAYS, device=dev)
    target = torch.zeros((RAYS, 3), device=dev)
    params, _ = dg.split_params(scene)
    record = dg.tape_recorder(scene, cam, cfg, ids, dev)
    tape = record(scene, key)
    plan = plan_buckets(tape)
    eager_body = getattr(dg, "bucketed_loss_and_grads", None)

    def graphed(t, p):
        return dg.render_loss_and_grads_bucketed(
            params, scene, cam, cfg, key, ids, target, t, plan=p)

    def eager(t, p):
        return eager_body(params, scene, cam, key, ids, target, t, p[0],
                          cfg=cfg, groups=p[1], num_values=3 * RAYS)

    def step(fn):
        t = record(scene, key)
        return fn(t, plan_buckets(t))

    fns = {"step": lambda: step(graphed),
           "replay": lambda: graphed(tape, plan)}
    if eager_body is not None:
        fns.update({"eager_step": lambda: step(eager),
                    "eager_replay": lambda: eager(tape, plan)})
    step(graphed)
    out = {"checkout": ARGS.checkout, "scene": ARGS.scene}
    peak, (loss, grads) = peak_gb(lambda: step(graphed))
    out["peak_gb"] = peak
    if eager_body is not None:
        out["eager_peak_gb"] = peak_gb(lambda: step(eager))[0]
        out["capture"] = dg.GRAPHS.last
    for k, v in seconds(fns).items():
        out[f"{k}_s"] = statistics.median(v)
        out[f"{k}_s_all"] = v
    out.update(loss=float(loss),
               albedo_grad_absmax=float(grads["albedo"].abs().max()))
    if ARGS.fit:
        fit_params, _ = dg.split_params(scene)
        opt = dg.make_optimizer("adam", fit_params, 1e-2)
        fit = dg.make_fit_step_replay(scene, cam, cfg, ids, target, opt,
                                      device=dev)
        before = {k: getattr(getattr(dg, "GRAPHS", None), k, 0)
                  for k in ("captures", "warmups", "replays")}
        plans, losses, times = set(), [], []
        rec = dg.tape_recorder(scene, cam, cfg, ids, dev)
        for _ in range(ARGS.fit):
            s = dg.merge_params(scene, {k: v.detach()
                                        for k, v in fit_params.items()})
            plans.add(plan_buckets(rec(s, key))[1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(fit(fit_params, key)))
            times.append(time.perf_counter() - t0)
        out["fit"] = {
            "steps": ARGS.fit, "seconds": sum(times),
            "step_s_median": statistics.median(times), "step_s": times,
            "distinct_plans": len(plans), "first_loss": losses[0],
            "last_loss": losses[-1],
            **{k: getattr(getattr(dg, "GRAPHS", None), k, 0) - before[k]
               for k in before}}
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
