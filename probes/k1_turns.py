"""K1 on the final scene in one checkout: its ptxas register line, the
instruction count of every kernel in the library's SASS (``cuobjdump
-sass``) and K1's CUDA-event time, median of 5 after a warm launch.

Compares two commits on one card when run in turns, each in its own
process, from the repository root on a GPU host:

    git archive <parent> | tar -x -C out/parent
    for t in out/parent . . out/parent; do python probes/k1_turns.py $t; done
"""
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402
from torch.utils.cpp_extension import CUDA_HOME  # noqa: E402

from first_raytracer_tpu_torch.core import rng  # noqa: E402
from first_raytracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from first_raytracer_tpu_torch.scene.builders import build_preset  # noqa: E402


def main():
    _, info = mk.load_mega_library()
    regs = [line.strip() for line in info.log.splitlines()
            if "registers" in line]
    sass = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", info.path],
        capture_output=True, text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        count = len(re.findall(r"/\*[0-9a-f]{4}\*/", body))
        print(sys.argv[1], body.split("\n", 1)[0][:90], "instructions",
              count, flush=True)
    scene, cam, cfg = build_preset("random-spheres", device="cuda")
    pack = mk.pack_scene_mega(scene)
    key = rng.base_key(0)
    mk.render_pixels_mega(pack, cam, cfg, key)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mk.render_pixels_mega(pack, cam, cfg, key)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(sys.argv[1], "K1 ms", statistics.median(times), sorted(times),
          "first entry:", regs[0] if regs else "cached", flush=True)


if __name__ == "__main__":
    main()
