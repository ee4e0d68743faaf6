"""The benchmark's frozen roofline arithmetic agrees with the port's
``utils/roofline.py`` on fixed counts."""
import types

import pytest

from benchmark import roofline
from first_raytracer_tpu_torch.utils import roofline as port


def test_constants_are_the_ports():
    assert roofline.PEAK_FP32 == port.PEAK_FP32
    assert roofline.PEAK_BYTES == port.PEAK_BYTES
    assert (roofline.SPHERE_OPS, roofline.TRIANGLE_OPS) == (
        port.SPHERE_OPS, port.TRIANGLE_OPS)


@pytest.mark.parametrize("segments,spheres,triangles", [
    (1, 1, 0), (12_345_678, 489, 0), (3_000_000, 20_004, 0),
    (1000, 7, 24)])
def test_dense_ops_and_least_time(segments, spheres, triangles):
    pack = types.SimpleNamespace(sphere_rows=spheres, tri_rows=triangles)
    ops = roofline.dense_ops(segments, spheres, triangles)
    assert ops == port.dense_ops(pack, segments)
    for nbytes in (0.0, 1e6, 1e12):
        ms, _ = port.roofline(ops, nbytes)
        assert roofline.least_seconds(ops, nbytes) * 1e3 == \
            pytest.approx(ms, rel=1e-12)
