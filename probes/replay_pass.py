"""Phase 23 of ``chip_smoke.py`` alone: K14 and K15, the tape replay on the
card.

Builds the kernels' library (phase 2: ptxas's registers and spills of
each kernel) and runs ``chip_smoke.replay_pass_path``: K14's float32
radiance ``torch.equal`` to the plain loop's and K15's float64 gradients
within 1e-8 of the plain loop's autograd on 2^17 rays of the final scene
(K2b's tape and JAX's golden tape) and of field5000 (K3t's tape); the
direct and bucketed steps' launches with the counters reset; K14 and K15
alone (CUDA graphs, median of 5) and the plain loop's forward and
backward; their bounds; the whole-tape replay's graph nodes through the
kernels and on the plain loop; and the graphed replay, direct step and
bucketed step through the kernels in turns with the plain loop's graphs.
Prints the phase's log and K14's and K15's entries of the kernels line
(about a minute with the build), on a machine with an NVIDIA GPU:

    python probes/replay_pass.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from first_raytracer_tpu_torch.core import rng  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("replay_pass: no CUDA device")
    card = chip_smoke.card_line()
    chip_smoke.log(card)
    chip_smoke.build()
    entries = chip_smoke.replay_pass_path(torch.device("cuda"),
                                          rng.base_key(0), card)
    print(json.dumps({"kernels": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
