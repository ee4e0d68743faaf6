"""Build ``kernels/csrc`` with g++ into a host library (the CPU tests'
emulation of the kernels; see ``cuda_runtime.h`` beside this file).

The sources are copied into ``kernels/build/``, their launches and
``extern __shared__`` buffers rewritten for the shim, ``cp_async.cuh``
replaced by the synchronous one here, and compiled with ``-ffp-contract=
off``.  The library keeps the sources' C entry points, so the tests bind
it as ``megakernel.load_mega_library`` binds the card's, and adds the
shim's own: ``frt_emu_interleave(resident, seed)`` (blocks in flight at
once in the launches that follow, 0 for one after another, and the seed
of their fibers' schedule), ``frt_emu_spins()`` (spin-waits since) and
``frt_emu_look_backs(out)`` (three uint64: the look-backs' windows,
those they went on past, and the aggregates they summed, since).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

from ..build import BUILD_DIR, CSRC_DIR

__all__ = ["GXX_FLAGS", "build_host_library", "rewrite"]

HERE = os.path.dirname(os.path.abspath(__file__))
GXX_FLAGS = ("-O2", "-std=c++20", "-ffp-contract=off",
             "-fPIC", "-shared", "-x", "c++")
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;{}]*>)?)\s*<<<")
_SHARED = re.compile(r"extern\s+__shared__\s+([\w:]+)\s+(\w+)\[\];")


def _split_top(text):
    """``text`` cut at its top-level commas."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        if ch in "(<[{":
            depth += 1
        elif ch in ")>]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def rewrite(src):
    """``k<<<grid, block, smem, stream>>>(args);`` -> ``frt_emu::launch(
    grid, block, smem, [&] { k(args); });``, and ``extern __shared__ T
    x[];`` -> the block's buffer."""
    out, pos = [], 0
    for m in _LAUNCH.finditer(src):
        if m.start() < pos:
            continue
        end = src.index(">>>", m.end())
        cfg = _split_top(src[m.end():end])
        i = end + 3
        while src[i].isspace():
            i += 1
        assert src[i] == "(", src[m.start():i + 20]
        depth, j = 0, i
        while True:
            depth += {"(": 1, ")": -1}.get(src[j], 0)
            if depth == 0:
                break
            j += 1
        args = src[i + 1:j]
        k = j + 1
        while src[k].isspace():
            k += 1
        assert src[k] == ";"
        smem = cfg[2] if len(cfg) > 2 else "0"
        out.append(src[pos:m.start()])
        out.append(f"frt_emu::launch(dim3({cfg[0]}), dim3({cfg[1]}), "
                   f"{smem}, [&]() {{ {m.group(1)}({args}); }});")
        pos = k + 1
    out.append(src[pos:])
    return _SHARED.sub(
        lambda m: f"{m.group(1)}* {m.group(2)} = reinterpret_cast<"
                  f"{m.group(1)}*>(frt_emu::tl_smem);", "".join(out))


def build_host_library(gxx="g++", units=None):
    """Compile every ``.cu`` under ``csrc/`` (or those named in ``units``)
    for the host; returns the loaded ``ctypes.CDLL``.  The library's name
    carries a hash of the sources, the shim and the flags."""
    names = sorted(n for n in os.listdir(CSRC_DIR)
                   if units is None or not n.endswith(".cu") or n in units)
    shim = ("cuda_runtime.h", "cp_async.cuh")
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for base, files in ((CSRC_DIR, names), (HERE, shim)):
        for n in files:
            with open(os.path.join(base, n), "rb") as f:
                digest.update(n.encode() + f.read())
    tag = digest.hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libfrt_host_emu_{tag}.so")
    if not os.path.exists(out):
        # A directory of this process's own: test workers that build the
        # same library at once never read each other's half-written copies.
        src = os.path.join(BUILD_DIR, f"host_emu_{tag}.{os.getpid()}")
        os.makedirs(src, exist_ok=True)
        units = []
        for n in names:
            with open(os.path.join(CSRC_DIR, n)) as f:
                text = f.read()
            if n.endswith(".cu"):
                text = rewrite(text)
                units.append(os.path.join(src, n))
            with open(os.path.join(src, n), "w") as f:
                f.write(text)
        shutil.copy(os.path.join(HERE, "cp_async.cuh"), src)
        control = os.path.join(src, "emu_control.cc")
        with open(control, "w") as f:
            f.write("#define FRT_EMU_CONTROL\n#include <cuda_runtime.h>\n")
        units.append(control)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [gxx, *GXX_FLAGS, "-I", HERE, "-o", tmp, *units],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{proc.stderr[-6000:]}")
        os.replace(tmp, out)
        shutil.rmtree(src, ignore_errors=True)
    lib = ctypes.CDLL(out)
    lib.frt_emu_interleave.argtypes = [ctypes.c_int, ctypes.c_ulonglong]
    lib.frt_emu_interleave.restype = None
    lib.frt_emu_spins.restype = ctypes.c_ulonglong
    lib.frt_emu_look_backs.argtypes = [ctypes.c_void_p]
    lib.frt_emu_look_backs.restype = None
    return lib
