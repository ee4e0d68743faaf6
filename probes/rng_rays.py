"""Phase 20 of ``chip_smoke.py`` alone: K7 and K8 on the card, and the
graphed frames they move.

Builds the kernels' library (phase 2: ptxas's registers and spills of
each kernel), then times, graphed, the final scene's pool frame (2^17
slots through K4, median of 3) and chunked frame (chunks of 2^17, one
frame), field20000's chunked frame through K5 (median of 3) and the final
scene's pool frame through K6 (median of 3), each beside PRs 12-14's
readings (``chip_smoke.EARLIER``), and counts K7's and K8's launches over
the chunked frame; then runs ``chip_smoke.rng_rays_path``: K7 and K8
bit-equal to their plain versions, their launches over a pool frame, their
ms at 2^17 rays and bounds, and a graphed pool pass's ms and nodes.
Prints the phase's log and K7's and K8's entries of the kernels line
(about 3 min with the build).

    python probes/rng_rays.py
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


def frame_s(scene, cam, cfg, accel, mode, repeats):
    """Graphed seconds of ``render_image`` (its first call captures):
    the median of ``repeats`` frames."""
    def frame():
        return cs.render_image(scene, cam, cfg, seed=0, accel=accel,
                               mode=mode, chunk=cs.WAVE_RAYS,
                               pool_size=cs.WAVE_RAYS, device=scene.device)
    frame()
    return statistics.median(cs.host_s(frame)[0] for _ in range(repeats))


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
    frames = {
        "regenerative final scene": frame_s(scene, cam, cfg, pack,
                                            "regenerative", 3),
        "wavefront final scene": frame_s(scene, cam, cfg, pack,
                                         "wavefront", 1)}
    cs.reset_counts()
    frame_s(scene, cam, cfg, pack, "wavefront", 1)
    chunk_draws = (cs.rng.uniforms.launches, cs.rcam.camera_rays.launches)
    frames["bvh pool frame"] = frame_s(
        scene, cam, cfg, build_bvh(scene, max_leaf=cs.BVH_MAX_LEAF),
        "regenerative", 3)
    field, fcam, fcfg = cs.build_preset("sphere-field", device=dev, n=20000)
    frames["field20000 chunks"] = frame_s(
        field, fcam, fcfg, ic.pack_scene_clustered(field), "wavefront", 3)
    del field
    for name, earlier in (("regenerative final scene", "regenerative"),
                          ("wavefront final scene", "wavefront"),
                          ("bvh pool frame", "bvh frame"),
                          ("field20000 chunks", "field20000")):
        cs.log(f"  {name}, graphed: {frames[name]:.4f} s/frame; before K7 "
               f"and K8 {cs.EARLIER[earlier]}; on {card}")
    cs.log(f"  the chunked frame (two frames, the second with its graphs "
           f"cached): K7 launches {chunk_draws[0]}, K8 {chunk_draws[1]}")
    torch.cuda.empty_cache()
    for entry in cs.rng_rays_path(dev, key, card, frames, chunk_draws):
        cs.log(json.dumps(entry))


if __name__ == "__main__":
    main()
