"""The port's timing helpers against the JAX package's.

``throughput`` is the same arithmetic in both packages and must give equal
dicts; ``time_fn``, ``time_repeats`` and ``Timer`` measure host seconds (on
the CPU here; on a GPU the timers wait for the device); ``trace_to`` writes a
``torch.profiler`` Chrome trace.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import json
import os

import pytest
import torch

from first_raytracer_tpu.utils.profiling import throughput as jax_throughput
from first_raytracer_tpu_torch.utils.profiling import (Timer, throughput,
                                                       time_fn, time_repeats,
                                                       trace_to)


@pytest.mark.parametrize("paths,segments,seconds",
                         [(9_600_000, 24_741_599, 0.0342), (1, 0, 1.0)])
def test_throughput_matches_jax(paths, segments, seconds):
    assert throughput(paths, segments, seconds) == jax_throughput(
        paths, segments, seconds)


def test_time_fn_and_timer():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return {"y": [torch.ones(3) * x * scale]}

    secs = time_fn(fn, 2.0, warmup=2, repeats=3, scale=0.5)
    assert secs >= 0.0 and len(calls) == 5
    t = Timer()
    for _ in range(2):
        with t.section("a"):
            pass
    assert set(t.times) == {"a"} and t.times["a"] >= 0.0


def test_trace_to(tmp_path):
    with trace_to(None):
        pass
    logdir = str(tmp_path / "trace")
    with trace_to(logdir):
        torch.ones(64).sum()
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_time_repeats_gives_every_repeat():
    calls = []
    times = time_repeats(lambda x: calls.append(x) or torch.ones(2) * x,
                         3.0, warmup=1, repeats=4)
    assert len(times) == 4 and len(calls) == 5
    assert all(t >= 0.0 for t in times)
