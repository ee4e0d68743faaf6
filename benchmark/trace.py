"""The traced run: ``torch.profiler`` over the window, reduced to device
intervals, busy time, kernel time by name and idle gaps by host span.

Patterned on the port's ``probes/bench_spread.py --profile`` (kernel time
by name from the trace, the longest idle stretches).  The host spans are
the benchmark's own (``spans.py``), recorded as profiler annotations around
its calls into the program, so their times share the trace's clock.  The
trace file goes under ``TMPDIR`` and is deleted once read.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

# Device activity in the trace's events: kernels, copies and memsets.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench:"


class Profiler:
    """``torch.profiler`` over CPU and CUDA activity, started before the
    window; ``stop()`` returns the reduced ``Trace``."""

    def __init__(self):
        import torch

        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self):
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(events)


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device intervals and the benchmark's spans of one traced window.
    Times are the trace's microseconds."""

    def __init__(self, events):
        self.device = [(e["ts"], e["ts"] + e["dur"], e["name"],
                        e.get("cat", "")) for e in events
                       if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
        self.spans = [(e["ts"], e["ts"] + e["dur"],
                       e["name"][len(SPAN_PREFIX):]) for e in events
                      if e.get("ph") == "X"
                      and str(e.get("name", "")).startswith(SPAN_PREFIX)
                      and e.get("cat") == "user_annotation"]
        windows = [s for s in self.spans if s[2] == "window"]
        if windows:
            self.start, self.end = windows[0][0], windows[0][1]
        else:
            raise ValueError("the trace holds no 'window' span")

    def _clipped(self, pred=None):
        for s, e, name, cat in self.device:
            if pred is not None and not pred(name, cat):
                continue
            s, e = max(s, self.start), min(e, self.end)
            if e > s:
                yield s, e, name

    @property
    def window_s(self):
        return (self.end - self.start) / 1e6

    def busy_s(self):
        """Seconds of the window in which a kernel, copy or memset ran."""
        return sum(e - s for s, e in _union(
            (s, e) for s, e, _ in self._clipped())) / 1e6

    def kernel_seconds(self, pattern):
        """Device seconds in the window of the kernels whose name matches
        the regular expression ``pattern`` (``re.search``)."""
        rx = re.compile(pattern)
        return sum(e - s for s, e, _ in self._clipped(
            lambda n, c: c == "kernel" and rx.search(n))) / 1e6

    def top_ops(self, k=10):
        """The ``k`` device operations (by name) that took most time."""
        totals = {}
        for s, e, name in self._clipped():
            totals[name[:120]] = totals.get(name[:120], 0.0) + (e - s) / 1e6
        return sorted(totals.items(), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10):
        """The ``k`` longest idle stretches of the device in the window,
        each named by the innermost benchmark span open at its middle."""
        busy = _union((s, e) for s, e, _ in self._clipped())
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (s + e)
            open_ = [sp for sp in self.spans if sp[0] <= mid <= sp[1]]
            name = (min(open_, key=lambda sp: sp[1] - sp[0])[2]
                    if open_ else "outside any span")
            out.append((name, (e - s) / 1e6))
        return out
