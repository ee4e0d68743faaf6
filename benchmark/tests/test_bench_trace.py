"""The traced run's reduction: busy time as the union of device intervals
inside the window, kernel time by name, idle gaps named by the
benchmark's own spans."""
import pytest

from benchmark.trace import SPAN_PREFIX, Trace


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _trace():
    span = "user_annotation"
    return Trace([
        _x(SPAN_PREFIX + "window", 100, 1000, span),
        _x(SPAN_PREFIX + "request", 100, 500, span),
        _x(SPAN_PREFIX + "synchronize", 450, 150, span),
        _x(SPAN_PREFIX + "request", 600, 500, span),
        _x("void k1<false>(args)", 50, 100, "kernel"),    # half outside
        _x("void k1<false>(args)", 200, 200, "kernel"),
        _x("Memcpy DtoD", 300, 200, "gpu_memcpy"),        # overlaps
        _x("other_kernel", 700, 100, "kernel"),
        _x("cpu_op", 0, 5000, "cpu_op"),                  # not device
    ])


def test_busy_is_the_union_inside_the_window():
    tr = _trace()
    assert tr.window_s == pytest.approx(1000e-6)
    # [100, 150) + [200, 500) + [700, 800) = 50 + 300 + 100 us
    assert tr.busy_s() == pytest.approx(450e-6)


def test_kernel_seconds_by_name_and_top_ops():
    tr = _trace()
    assert tr.kernel_seconds(r"\bk1<false>") == pytest.approx(250e-6)
    assert tr.kernel_seconds("Memcpy") == 0.0   # copies are not kernels
    top = dict(tr.top_ops())
    assert top["void k1<false>(args)"] == pytest.approx(250e-6)
    assert top["Memcpy DtoD"] == pytest.approx(200e-6)


def test_idle_gaps_named_by_the_open_span():
    gaps = _trace().idle_gaps()
    # Gaps: [150, 200) in a request, [500, 700) half in the synchronize,
    # [800, 1100) in the second request.
    assert gaps[0] == ("request", pytest.approx(300e-6))
    assert gaps[1][1] == pytest.approx(200e-6)
    assert gaps[1][0] in ("synchronize", "request")
    assert gaps[2] == ("request", pytest.approx(50e-6))


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        Trace([_x("k", 0, 1, "kernel")])
