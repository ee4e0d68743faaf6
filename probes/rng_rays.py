"""Phase 20 of ``chip_smoke.py`` alone: K7 and K8 on the card.

Builds the kernels' library (phase 2: ptxas's registers and spills of
each kernel), counts K7's and K8's launches over the final scene's pool
frame (2^17 slots through K4) and its chunked frame (chunks of 2^17),
both graphed, where only the loops' inits still make camera rays (K9 and
K10 take the passes, phase 21); then runs ``chip_smoke.rng_rays_path``:
the pool recorder through K4 (K7 and K8 once a pass), K7 and K8 bit-equal
to their plain versions, their ms at 2^17 rays and bounds.  Prints the
phase's log and K7's and K8's entries of the kernels line (about 2 min
with the build).

    python probes/rng_rays.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/rng_rays.py: no CUDA device")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
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
    for entry in cs.rng_rays_path(dev, key, card, draws):
        cs.log(json.dumps(entry))


if __name__ == "__main__":
    main()
