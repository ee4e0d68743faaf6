"""The readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds 3] [--control-seeds 3] [--out FILE]

For each seed, in one process: one run of the cell as ``run.py`` makes it
(a short window), its compared numbers (the program's lower readings);
then, on the first ``--control-seeds`` seeds, the control (the reference
computed in bfloat16, the precision below the configuration's float32, put
in the program's place) and the cell's planted faults (variants of the
reference put in the program's place), compared with the same float64
reference.  One JSON line a seed on standard output (and appended to
``--out``).  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import run  # noqa: E402  (sets the cache directories)


def control_and_faults(ctx, session):
    """{name: numbers} of the control and of each planted fault."""
    import torch

    from benchmark import fit_check, render_check

    ref = render_check.reference(ctx)
    low = render_check.reference(ctx, torch.bfloat16)
    if hasattr(session, "reference_numbers"):
        want = session.reference_numbers(ref)
        out = {"control": fit_check.gaps(session.reference_numbers(low),
                                         want),
               "half_batch": fit_check.gaps(
                   session.reference_numbers(ref, half=True), want)}
        still = dict(want, grad_norm=0.0, change_norm=0.0)
        out["state_unchanged"] = fit_check.gaps(still, want)
        return out
    items = session.items()
    out = {"control": render_check.image_numbers(
        ctx, items, ref, lambda r, seed, px: low.pixel_means(
            seed, px, ctx.image["max_depth"])[0])[0]}
    for name, fault in render_check.faults(ctx).items():
        out[name] = render_check.image_numbers(ctx, items, ref, fault)[0]
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    from benchmark.spec import Spec

    spec = Spec(run.ROOT)
    cell = spec.cell(args.workload)
    for n, seed in enumerate(args.seeds):
        hold = {}
        t0 = time.perf_counter()
        res = run.run_cell(spec, cell, seed, args.seconds, False, args.device,
                           hold=hold)
        line = {"workload": cell.name, "seed": seed,
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - t0}
        if n < args.control_seeds:
            t1 = time.perf_counter()
            line.update(control_and_faults(hold["ctx"], hold["session"]))
            line["control_s"] = time.perf_counter() - t1
        hold.clear()
        print(json.dumps(line), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
