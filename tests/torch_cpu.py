"""torch's intra-op threads for the CPU tests of the port, shared out over
pytest-xdist's workers.

torch starts one OpenMP thread a core in every process, and between
parallel regions those threads keep spinning.  Under ``pytest -n N`` the
N workers' threads (N times the cores) then fight over the same cores:
measured on an 8-core host, six of the port's test files under ``-n 6``
took 735 s of summed test time with torch's default and 382 s with one
thread a worker (together with the g++ emulation's fibers,
``kernels/host_emu/cuda_runtime.h``); the host emulation's file alone went
from 138 s to 14 s.  Each worker (``PYTEST_XDIST_WORKER_COUNT`` is set)
takes ``cores // workers`` threads, at least one; a run without xdist keeps
torch's default.  Importing this module does it; every ``test_torch_*.py``
imports it first.  The tests' tolerances do not depend on the thread
count, and results compared bit for bit are computed in one process.
"""
import os

import torch

__all__ = ["THREADS"]

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
THREADS = (max(1, (os.cpu_count() or 1) // _WORKERS) if _WORKERS
           else torch.get_num_threads())
torch.set_num_threads(THREADS)
