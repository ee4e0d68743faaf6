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

    python probes/scan_graph.py --rays 16384 131072
    python probes/scan_graph.py --rays 16384 --profile
    python probes/scan_graph.py --rays 16384 131072 --profile --rows
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, nargs="+", default=[1 << 17])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--rows", action="store_true")
    args = ap.parse_args()
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


if __name__ == "__main__":
    main()
