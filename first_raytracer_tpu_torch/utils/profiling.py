"""Timing and tracing helpers.

Port of ``first_raytracer_tpu.utils.profiling``: wall-clock timing that
waits for the device (PyTorch returns before a CUDA device finishes, so a
host clock without a ``torch.cuda.synchronize`` measures the enqueue),
throughput in the renderer's units (Mpaths/s, Mrays/s), and a
``torch.profiler`` trace of a block of code, written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

__all__ = ["Timer", "time_fn", "time_repeats", "throughput",
           "trace_to"]


@dataclass
class Timer:
    """Accumulating named wall-clock timer."""

    times: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)


def _wait(out):
    """Wait for every CUDA device that holds a tensor of ``out`` (a tensor
    or a nest of tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _wait(x)
    elif isinstance(out, dict):
        for x in out.values():
            _wait(x)


def time_fn(fn: Callable, *args, warmup: int = 1, repeats: int = 3,
            **kwargs) -> float:
    """Best-of-N seconds for ``fn(*args, **kwargs)``, each run waiting for
    the devices that hold its outputs."""
    return min(time_repeats(fn, *args, warmup=warmup, repeats=repeats,
                            **kwargs))


def time_repeats(fn: Callable, *args, warmup: int = 0, repeats: int = 3,
                 **kwargs) -> list:
    """Seconds of each of ``repeats`` runs of ``fn(*args, **kwargs)``
    after ``warmup`` untimed ones, each run waiting for the devices that
    hold its outputs: the samples of a median and a spread."""
    for _ in range(warmup):
        _wait(fn(*args, **kwargs))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _wait(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return times


def throughput(num_paths: int, num_segments: int, seconds: float) -> dict:
    """Paths and segments per second, and the mean path length."""
    return {
        "seconds": seconds,
        "mpaths_per_s": num_paths / seconds / 1e6,
        "mrays_per_s": num_segments / seconds / 1e6,
        "avg_path_length": num_segments / max(num_paths, 1),
    }


@contextlib.contextmanager
def trace_to(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a GPU
    is present), written to ``logdir/trace.json``; a no-op when
    ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
