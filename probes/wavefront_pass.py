"""Phase 21 of ``chip_smoke.py`` alone: K9 and K10 on the card, and the
graphed frames they move.

Builds the kernels' library (phase 2: ptxas's registers and spills of
each kernel), then times, graphed, the final scene's pool frame (2^17
slots through K4, median of 3) and chunked frame (chunks of 2^17, one
frame), field20000's chunked frame through K5 (median of 3, its host pack
inside, as phase 13 times it) and the final scene's pool frame through K6
(median of 3), each printed beside the readings before K9 and K10's
redesign (``chip_smoke.EARLIER_K9``) and before K9 and K10
(``chip_smoke.EARLIER``); then runs ``chip_smoke.wavefront_pass_path``:
K9 and K10 bit-equal to their plain versions pass by pass on every set
and on the stress set (a pool of 2^21 slots), their launches over the
frames, their ms at 2^17 slots (K9 in pool and trip mode, K10), their
bounds, and a graphed pool pass's and trip's ms and nodes.  Prints the phase's log and K9's and
K10's entries of the kernels line (a few minutes with the build).

    python probes/wavefront_pass.py
"""
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from first_raytracer_tpu_torch.accel.build import build_bvh  # noqa: E402
from first_raytracer_tpu_torch.kernels import intersect_clustered as ic  # noqa: E402,E501
from first_raytracer_tpu_torch.kernels import intersect_pallas as ip  # noqa: E402,E501


def frame_s(frame, repeats):
    """Graphed seconds of ``frame()`` (its first call captures): the
    median of ``repeats`` frames."""
    frame()
    return [statistics.median(cs.host_s(frame)[0] for _ in range(repeats))]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probes/wavefront_pass.py: no CUDA device")
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log(card)
    cs.build()
    key = cs.rng.base_key(0)
    scene, cam, cfg = cs.build_preset("random-spheres", device=dev)
    pack = ip.pack_scene_pallas(scene)
    bvh = build_bvh(scene, max_leaf=cs.BVH_MAX_LEAF)
    fs, fc, fcfg = cs.build_preset("sphere-field", n=20000, device=dev)

    def final(mode, accel):
        return lambda: cs.render_image(scene, cam, cfg, seed=0, accel=accel,
                                       mode=mode, chunk=cs.WAVE_RAYS,
                                       pool_size=cs.WAVE_RAYS, device=dev)

    def field():
        return cs.render_image(fs, fc, fcfg, seed=0,
                               accel=ic.pack_scene_clustered(fs),
                               chunk=cs.WAVE_RAYS, device=dev)
    frames = {
        "regenerative final scene": frame_s(final("regenerative", pack), 3),
        "wavefront final scene": frame_s(final("wavefront", pack), 1),
        "field20000 chunks": frame_s(field, 3),
        "bvh pool frame": frame_s(final("regenerative", bvh), 3)}
    k9, k10 = cs.wavefront_pass_path(dev, key, card, frames)
    print(json.dumps({"kernels": [k9, k10]}), flush=True)


if __name__ == "__main__":
    main()
