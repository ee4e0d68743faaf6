"""The benchmark's host spans around its calls into the program.

In a traced run each span is a ``torch.profiler.record_function``
annotation named ``bench:<name>``, so the trace places it on the device's
clock and the idle gaps can be named by what the host was doing.  With
tracing off a span costs nothing.
"""
from __future__ import annotations

import contextlib

from .trace import SPAN_PREFIX


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)
