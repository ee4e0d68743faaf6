"""The window's arithmetic: a rate over the whole window, a tail over every
request, and the spread of a set of runs.

Patterned on the port's ``utils/profiling.py`` (``time_repeats``,
``throughput``: the host clock around work that ends in a synchronize),
without its medians of repeats: a rate here is all the work of the window
over all its time, and a tail is taken over every request in it.
"""
from __future__ import annotations

import math
import statistics


def percentile(values, q):
    """The ``q``-th percentile (0 < q <= 100) of ``values`` by nearest rank:
    the smallest value with at least ``q`` percent of the values at or
    below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(work, start, end):
    """``work`` per second over ``[start, end]``, the whole window."""
    if end <= start:
        raise ValueError(f"empty window [{start}, {end}]")
    return work / (end - start)


def summarize(latencies_s, work_per_request, start, end):
    """The window's numbers from each request's latency (seconds, in the
    order they ran), the work each did and the window's bounds (seconds on
    the same clock): requests, the rate of work, and the median and 95th
    percentile latency in ms."""
    p95 = percentile(latencies_s, 95)
    return dict(
        requests=len(latencies_s),
        work=work_per_request * len(latencies_s),
        seconds=end - start,
        rate=rate(work_per_request * len(latencies_s), start, end),
        p50_ms=1e3 * percentile(latencies_s, 50),
        p95_ms=1e3 * p95,
        beyond_p95=sum(1 for x in latencies_s if x > p95))


def spread(values):
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
