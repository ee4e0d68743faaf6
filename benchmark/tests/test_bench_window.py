"""The window's arithmetic: the rate is over the whole window and the tail
over every request, a stall included."""
import pytest

from benchmark import window


def test_rate_is_over_the_whole_window_with_a_stall():
    # 99 requests of 10 ms, then one stalled for 1 s: 1.99 s in all.
    lat = [0.01] * 99 + [1.0]
    s = window.summarize(lat, work_per_request=1000, start=0.0,
                         end=sum(lat))
    assert s["requests"] == 100 and s["work"] == 100_000
    assert s["rate"] == pytest.approx(100_000 / 1.99)
    # A median of chunks would hide the stall; the window's rate does not.
    assert s["rate"] < 0.55 * (1000 / 0.01)


def test_p95_is_over_every_request():
    lat = [0.01] * 94 + [0.5] * 6
    s = window.summarize(lat, 1, 0.0, sum(lat))
    assert s["p95_ms"] == pytest.approx(500.0)
    assert s["p50_ms"] == pytest.approx(10.0)
    lat = [0.01] * 95 + [0.5] * 5
    assert window.summarize(lat, 1, 0.0, sum(lat))["p95_ms"] == \
        pytest.approx(10.0)


def test_percentile_nearest_rank_and_spread():
    assert window.percentile([3, 1, 2], 50) == 2
    assert window.percentile([5], 95) == 5
    with pytest.raises(ValueError):
        window.percentile([], 50)
    with pytest.raises(ValueError):
        window.rate(1, 2.0, 2.0)
    assert window.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert window.spread([9.0, 10.0, 10.0, 11.0]) == pytest.approx(
        (10.75 - 9.25) / 10.0)
