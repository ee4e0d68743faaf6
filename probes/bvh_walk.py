"""Phase 19 of ``chip_smoke.py`` alone: K6, the flat-BVH walk, on the card.

Builds the kernels' library (phase 2: ptxas's registers and spills of each
kernel), records the final scene's dense-sweep tape at ray ids [0, 2^17)
(the lockstep recorder that phase 18's direct step runs, graphed) and runs
``chip_smoke.bvh_walk_path`` on it: K6 bit-equal to its plain version
(prim, t, hit and the per-ray counters) on the final scene's camera and
secondary rays, on field5000, field20000 and trifield20000 and on
triangle scenes, through the path each takes and the other one forced
where a block holds its bytes, each set of 2^17 rays timed beside its
bound; ``build_bvh`` timed native and NumPy on four scenes; K6 against
the dense sweep, its syncs, ``entry()`` graphed against the plain walk,
the recorder through K6, the full-width pool frame through K6 and through
K4 in turns, K6's ms and bound, and ``cli render --bvh`` in a
subprocess.
Prints the phase's log and K6's entry of the kernels line (about 2 min
with the build).

    python probes/bvh_walk.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/bvh_walk.py: no CUDA device")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    cs.build()
    key = cs.rng.base_key(0)
    scene, cam, cfg = cs.build_preset("random-spheres", device=dev)
    o, d = cs.camera_rays(scene, cam, cfg, key, cs.GRAD_RAYS)
    ids = torch.arange(cs.GRAD_RAYS, device=dev)
    tape = cs.record_paths(scene, o, d, ids, key, cfg)
    del scene, o, d
    cs.log(json.dumps(cs.bvh_walk_path(dev, key, card, tape)))


if __name__ == "__main__":
    main()
