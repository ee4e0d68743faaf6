"""Benchmark entry of the PyTorch + CUDA port: prints ONE JSON line.

    python3 bench_torch.py                          # K1, the final scene
    BENCH_SCENE=field20000 BENCH_MODE=megacluster python3 bench_torch.py

The switches, guards and line are those of ``bench.py`` (the JAX/TPU
entry); see ``first_raytracer_tpu_torch/bench.py``.  The kernels build at
first use.  Exit code 2, with an ``error`` key in the line, on any refused
run.
"""
import sys

from first_raytracer_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
