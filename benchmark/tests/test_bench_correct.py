"""``correct`` comes out false where it should: the control (the reference
in bfloat16 put in the program's place) fails one of a cell's numbers, and
a run whose timed path is broken underneath fails for each fault the cell
can have.  At a size a test run holds, on the CPU (the port's plain
versions); the readings on the card at the cells' own sizes are
``benchmark/readings.py``'s (PERF.md)."""
import copy
import dataclasses
import functools

import pytest
import torch

from benchmark import readings, run, scenes
from benchmark.spec import Spec
from first_raytracer_tpu_torch.diff import grad
from first_raytracer_tpu_torch.kernels import megakernel, megakernel_clustered

from .conftest import ROOT

SIZES = {"final_scene": dict(nx=32, ny=16, spp=4)}
SEEDS = (11, 2**31 + 3)
CELLS = ["final_scene.oneshot", "final_scene.oneshot_clustered",
         "final_scene.fit", "final_scene.fit_clustered"]


def _cell(name):
    spec = Spec(ROOT)
    cell = spec.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["image"].update(SIZES[cell.config["name"]])
    cell.limits = dict(cell.limits, check={"requests": 2, "pixels": 400})
    return spec, cell


def _small(cfg):
    return scenes.book_scene(cfg["scene"]["seed"])


def _run(name, seed, hold=None, traced=False):
    torch.set_num_threads(2)
    spec, cell = _cell(name)
    return run.run_cell(spec, cell, seed, 0.3, traced, "cpu",
                        scene_override=_small, hold=hold)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name, seed):
    hold = {}
    res = _run(name, seed, hold)
    assert res["correct"], res["checks"]
    limits = hold["ctx"].limits["numbers"]
    out = readings.control_and_faults(hold["ctx"], hold["session"])
    assert any(not out["control"][k] <= v for k, v in limits.items()), out


def _stale(fn):
    first = {}

    def wrapped(*a, **k):
        if "out" not in first:
            first["out"] = fn(*a, **k)
        return first["out"]
    return wrapped


def _render_faults(module, attr):
    orig = getattr(module, attr)

    def half(*a, **k):
        a = list(a)
        a[2] = dataclasses.replace(a[2], spp=a[2].spp // 2)
        return orig(*a, **k)

    def pixel_off(*a, **k):
        out = orig(*a, **k)
        return torch.roll(out.reshape(-1, 3), 1, 0).reshape(out.shape)

    return {"stale": _stale(orig), "half_samples": half,
            "pixel_off": pixel_off}


FAULTS = {
    "final_scene.oneshot": (megakernel, "render_image_mega"),
    "final_scene.oneshot_clustered": (megakernel_clustered,
                                      "render_image_mega_clustered"),
}


@pytest.mark.parametrize("fault", ["stale", "half_samples", "pixel_off"])
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_render_faults_are_not_correct(name, fault, monkeypatch):
    module, attr = FAULTS[name]
    monkeypatch.setattr(module, attr, _render_faults(module, attr)[fault])
    res = _run(name, SEEDS[0])
    assert not res["correct"], res["checks"]


def _half_batch(orig):
    @functools.wraps(orig)
    def half(params, scene, camera, cfg, key, ray_ids, target, *a, **k):
        n = ray_ids.shape[0] // 2
        return orig(params, scene, camera, cfg, key, ray_ids[:n], target[:n],
                    *a, **k)
    return half


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["final_scene.fit",
                                  "final_scene.fit_clustered"])
def test_fit_faults_are_not_correct(name, fault, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(grad, "apply_grads", lambda opt, p, g: None)
    else:
        monkeypatch.setattr(grad, "render_loss_and_grads",
                            _half_batch(grad.render_loss_and_grads))
    res = _run(name, SEEDS[0])
    assert not res["correct"], res["checks"]


class _SilentTrace:
    """A trace in which no kernel of the port ran."""

    window_s = 0.3

    def kernel_seconds(self, pattern):
        return 0.0

    def busy_s(self):
        return 0.1

    def top_ops(self):
        return []

    def idle_gaps(self):
        return []


class _SilentProfiler:
    def stop(self):
        return _SilentTrace()


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_whose_kernels_are_gone_fails(name, monkeypatch):
    """A per-layer metric listed for the cell that finds none of its
    kernels in the trace (renamed, or taken off the path) fails the
    traced run, naming it, instead of leaving the line without it."""
    from benchmark import trace

    monkeypatch.setattr(trace, "Profiler", _SilentProfiler)
    with pytest.raises(run.MetricMissing, match="_ms_per_|_roofline_"):
        _run(name, SEEDS[0], traced=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_small_cell_is_correct_on_the_card(cuda_device, name):
    """The same runs through the kernels on the card, at the test's size:
    correct, and the result line's device is the card."""
    spec, cell = _cell(name)
    res = run.run_cell(spec, cell, SEEDS[1], 0.5, False, cuda_device,
                       scene_override=_small)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["attempted"] >= 1
