"""Build the package's CUDA sources into shared libraries at first use.

Each kernel is plain CUDA C++ with a C interface, compiled by ``nvcc``
for Hopper (``sm_90a``) into ``kernels/build/`` inside the package and
loaded with ``ctypes``.  The library's file name carries a hash of its
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "BuildInfo",
           "build_library", "build_host_library"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """What one build did: the library path, its seconds, nvcc's output."""

    path: str
    seconds: float
    log: str
    cached: bool  # True: an identical library was already built


def _nvcc() -> str:
    """The nvcc of the CUDA toolkit PyTorch was built against."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the package's kernels")
    return path


def build_library(name: str, sources, extra_flags=()):
    """Compile ``sources`` (names under ``csrc/``) into ``lib<name>.so``.

    Returns ``(ctypes.CDLL, BuildInfo)``.  Raises ``RuntimeError`` with
    nvcc's output when the build fails.
    """
    paths = [os.path.join(CSRC_DIR, s) for s in sources]
    flags = list(NVCC_FLAGS) + list(extra_flags)
    # The shared headers count as sources: an edited header rebuilds every
    # library that may include it.
    headers = sorted(os.path.join(CSRC_DIR, h) for h in os.listdir(CSRC_DIR)
                     if h.endswith(".cuh"))
    digest = hashlib.sha256()
    for p in paths + headers:
        with open(p, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return ctypes.CDLL(out), BuildInfo(out, 0.0, "", True)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # One nvcc a source, all started together, then one link.
    objs = [f"{tmp}.{i}.o" for i in range(len(paths))]
    compile_flags = [f for f in flags if f != "-shared"]
    cmds = [[nvcc, *compile_flags, "-c", "-o", obj, p]
            for obj, p in zip(objs, paths)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    try:
        for cmd, proc, one in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{one}")
        cmd = [nvcc, *flags, "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{log}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return ctypes.CDLL(out), BuildInfo(out, seconds, log, False)


def build_host_library(name: str, source: str, flags):
    """Compile one C++ source for the host with ``g++`` (or ``$CXX``) into
    ``BUILD_DIR/lib<name>_<hash>.so`` at first use; the hash covers the
    source and the flags.  Returns ``(path, None)``, or ``(None, the
    reason)`` when there is no compiler, no source or the build fails."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None, "no C++ compiler (g++) found"
    if not os.path.exists(source):
        return None, f"{source} is missing"
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *flags, "-o", tmp, source],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            return None, f"g++ failed: {proc.stderr[-2000:]}"
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    return out, None
