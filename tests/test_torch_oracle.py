"""The port's oracles (``oracle/cpu_oracle.py``, ``oracle/native_oracle.py``)
against the JAX package's NumPy oracle and against the port's renderers.

Bounds:
- the port's NumPy oracle against JAX's ``render_oracle``: equal per ray
  (the same NumPy code fed bit-equal uniforms);
- the native oracle against the port's NumPy oracle: ``atol=2e-5`` (only
  libm's transcendentals differ; tests/test_native.py's bound);
- the port's wavefront render against the oracle, per ray: ``atol=2e-4``
  (``_compare``'s bound in tests/test_oracle_parity.py), with that test's
  allowance of knife-edge rays on the two scenes of near-ties (1% on
  random-spheres, 0.5% on triangle-mesh) and none elsewhere.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from first_raytracer_tpu.oracle.cpu_oracle import (
    render_oracle as jax_render_oracle)
from first_raytracer_tpu.scene import builders as jb
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.oracle import native_oracle
from first_raytracer_tpu_torch.oracle.cpu_oracle import render_oracle
from first_raytracer_tpu_torch.render.api import render_image, render_rays
from first_raytracer_tpu_torch.scene.builders import build_preset

# tests/test_oracle_parity.py's cases: (preset, builder arguments, the
# fraction of rays allowed past the bound).
CASES = {
    "three-spheres": (dict(nx=24, ny=12, spp=2), 0.0),
    "camera-effects": (dict(nx=24, ny=12, spp=2), 0.0),
    "triangle-mesh": (dict(nx=24, ny=12, spp=2), 0.005),
    "random-spheres": (dict(nx=16, ny=8, spp=1), 0.01),
}


def _ids(cfg):
    return np.arange(cfg.num_rays)


@pytest.mark.parametrize("name", list(CASES))
def test_numpy_oracle_equals_jax(name):
    kw, _ = CASES[name]
    js, jc, jcfg = jb.build_preset(name, **kw)
    scene, cam, cfg = build_preset(name, device="cpu", **kw)
    want = jax_render_oracle(js, jc, jcfg, seed=0, ray_ids=_ids(jcfg))
    got = render_oracle(scene, cam, cfg, seed=0, ray_ids=_ids(cfg))
    assert got.dtype == np.float32 and got.shape == (cfg.num_rays, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_wavefront_matches_oracle(name):
    kw, frac_tol = CASES[name]
    scene, cam, cfg = build_preset(name, device="cpu", **kw)
    wf = render_rays(scene, cam, cfg, rng.base_key(0),
                     torch.arange(cfg.num_rays)).numpy()
    orc = render_oracle(scene, cam, cfg, seed=0, ray_ids=_ids(cfg))
    diff = np.abs(wf - orc).max(axis=1)
    frac_bad = float((diff > 2e-4).mean())
    assert frac_bad <= frac_tol, (frac_bad, diff.max())


def test_full_image_matches_oracle():
    scene, cam, cfg = build_preset("three-spheres", device="cpu", nx=24,
                                   ny=12, spp=2)
    img = render_image(scene, cam, cfg, device="cpu").numpy()
    np.testing.assert_allclose(img, render_oracle(scene, cam, cfg),
                               atol=2e-4)


@pytest.fixture(scope="module")
def native():
    if not native_oracle.available():
        pytest.skip(f"native oracle unavailable: {native_oracle.error()}")
    return native_oracle


@pytest.mark.parametrize("name", ["three-spheres", "triangle-mesh",
                                  "camera-effects"])
def test_native_oracle_matches_numpy_oracle(native, name):
    scene, cam, cfg = build_preset(name, device="cpu", nx=24, ny=12, spp=2)
    a = render_oracle(scene, cam, cfg)
    b = native.render_oracle_native(scene, cam, cfg)
    assert b.shape == (cfg.ny, cfg.nx, 3)
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    ids = torch.arange(5, 37)
    np.testing.assert_allclose(
        render_oracle(scene, cam, cfg, ray_ids=ids),
        native.render_oracle_native(scene, cam, cfg, ray_ids=ids),
        atol=2e-5, rtol=0)


def test_native_oracle_is_built_from_its_source():
    """The port builds ``native/frt_oracle.cpp`` into its own build
    directory, never the JAX package's ``native/libfrt_native.so``; an
    unbuildable source is an error, not a fallback."""
    from first_raytracer_tpu_torch.kernels.build import (BUILD_DIR,
                                                         build_host_library)

    path, why = build_host_library("frt_oracle_missing", "/nonexistent.cpp",
                                   native_oracle.FLAGS)
    assert path is None and "missing" in why
    if native_oracle.available():
        lib_path = native_oracle._load()[0]._name
        assert lib_path.startswith(BUILD_DIR)
        assert "libfrt_native.so" not in lib_path


def test_golden_writer_sums_the_oracle_over_the_frame(native, tmp_path):
    """The field goldens' writer at a small size: its radiance sum is the
    oracle's per-ray radiance summed over every ray id of the frame (chunks
    over threads; a float64 sum in another order, so ``rtol=1e-12``), and
    the file records the scene, shape, seed and the oracle source's hash.
    The committed goldens name the frames chip_smoke.py renders."""
    import hashlib
    import json

    kw = dict(n=600, nx=16, ny=8, spp=2)
    out = native.write_goldens(str(tmp_path / "g.json"),
                               scenes=(("f600", "sphere-field", kw),),
                               threads=3, chunk=37)
    with open(tmp_path / "g.json") as f:
        assert json.load(f) == out
    g = out["goldens"]["f600"]
    scene, cam, cfg = build_preset("sphere-field", device="cpu", **kw)
    rad = native.render_oracle_native(scene, cam, cfg,
                                      ray_ids=np.arange(cfg.num_rays))
    np.testing.assert_allclose(g["radiance_sum"],
                               rad.astype(np.float64).sum(), rtol=1e-12)
    assert (g["scene"], g["nx"], g["ny"], g["spp"], g["seed"],
            g["rays"]) == ("sphere-field", 16, 8, 2, 0, 256)
    with open(native.SOURCE, "rb") as f:
        assert out["oracle"]["sha256"] == hashlib.sha256(
            f.read()).hexdigest()
    with open(native.GOLDENS) as f:
        committed = json.load(f)
    assert committed["oracle"]["sha256"] == out["oracle"]["sha256"]
    for label, preset, kw in native.GOLDEN_SCENES:
        c = committed["goldens"][label]
        assert (c["scene"], c["builder_args"], c["nx"], c["ny"], c["spp"],
                c["max_depth"], c["seed"]) == (preset, kw, 800, 450, 4, 50,
                                               0)
