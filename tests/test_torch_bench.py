"""The port's benchmark entry (``first_raytracer_tpu_torch/bench.py``, run
as ``bench_torch.py``) on the CPU.

Its result guards on the cases of ``tests/test_bench_guards.py``; the
counted-work guard on K3's field20000 reading and on the round-3 artifact;
the goldens it reads (and never writes); the grad mode's segment count;
the segment counts of the wavefront modes; and the paths that refuse a
run, each with one ``error`` line, exit code 2 and no history.  The CPU
runs (``BENCH_DEVICE=cpu``) go through the kernels' plain versions, on
scenes cut to a few hundred rays where a whole frame is timed.
"""
import torch_cpu  # noqa: F401  (torch threads per xdist worker)
import hashlib
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from first_raytracer_tpu_torch import bench
from first_raytracer_tpu_torch.core import rng
from first_raytracer_tpu_torch.kernels import megakernel as mk
from first_raytracer_tpu_torch.kernels import megakernel_clustered as mc
from first_raytracer_tpu_torch.kernels import record_mega as rm
from first_raytracer_tpu_torch.render.api import render_ray_batch
from first_raytracer_tpu_torch.render.integrator import RenderConfig
from first_raytracer_tpu_torch.render.regenerative import \
    render_rays_regenerative
from first_raytracer_tpu_torch.scene.builders import (random_scene,
                                                      sphere_field)
from first_raytracer_tpu_torch.utils import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = roofline.FP32_PEAKS["NVIDIA H100 80GB HBM3"]
# The final scene's segments at full size (PERF.md, K1's bound).
FINAL_SEGMENTS = 24_723_769
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "mrays_s", "seconds",
             "mode", "intersect", "device", "launches"}


def _final_pack():
    scene, _, _ = random_scene()
    return mk.pack_scene_mega(scene)


# bench.py's six guard cases (tests/test_bench_guards.py), the FLOP guard's
# against the counted-work guard that replaces it.
def _spread_stable():
    assert bench.check_spread([0.250, 0.252, 0.255]) is None


def _spread_wild():
    # One 1.6 ms outlier among 250 ms runs (the r3 incident shape).
    assert bench.check_spread([0.0016, 0.250, 0.252]) is not None


def _work_real_rate():
    # The final scene's 24.7M segments over its 486 spheres in 0.250 s.
    ops = roofline.dense_ops(_final_pack(), FINAL_SEGMENTS)
    assert bench.check_work(ops, 0.250, H100) is None


def _work_r3_artifact():
    # The recorded artifact: the same segments in 1.6 ms.
    ops = roofline.dense_ops(_final_pack(), FINAL_SEGMENTS)
    err = bench.check_work(ops, 0.0016, H100)
    assert err is not None and "impossible" in err


def _work_zero_ops():
    # Runs that count no work (the BVH walk) must not trip the guard.
    assert bench.check_work(0, 0.001, H100) is None


def _checksum():
    assert bench.check_checksum(100.0, 100.4) is None  # ulp-drift scale
    assert bench.check_checksum(0.0, 100.0) is not None  # no-op execution
    assert bench.check_checksum(57.0, 100.0) is not None  # wrong image


@pytest.mark.parametrize("case", [_spread_stable, _spread_wild,
                                  _work_real_rate, _work_r3_artifact,
                                  _work_zero_ops, _checksum],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_guard_case(case):
    case()


def test_work_guard_accepts_k3_field20000_which_the_dense_count_refuses():
    # K3 on field20000: its counters' slots and boxes are 0.1394 ms of the
    # H100's FP32 peak (PERF.md), about 9.3e9 operations, in 2.4 ms.
    ops = 0.1394e-3 * roofline.PEAK_FP32
    assert 9.2e9 < ops < 9.4e9
    assert bench.check_work(ops, 2.4e-3, H100) is None
    # bench.py's charge of 10 per (segment, padded primitive): every one of
    # the 1.44M paths has a segment, over 20,096 padded spheres.
    dense = 1_440_000 * 20_096 * 10.0
    assert bench.check_work(dense, 2.4e-3, H100) is not None


def test_work_guard_reads_each_card_from_its_table():
    assert roofline.fp32_peak("NVIDIA H100 80GB HBM3") == 67e12
    with pytest.raises(KeyError, match="no FP32 peak"):
        roofline.fp32_peak("NVIDIA A100-SXM4-80GB")


def test_roofline_counts_phase_4_bound():
    # chip_smoke.py prints K1's bound over the final scene from this count:
    # 24,723,769 segments x 486 spheres x 20 operations, 3.587 ms.
    ms, by = roofline.bound(_final_pack(), FINAL_SEGMENTS, 16 * 960_000)
    assert by == "operations" and abs(ms - 3.5867) < 1e-3


def test_chip_smoke_counts_with_the_package():
    import ast
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    defined = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assigned = {t.id for n in tree.body if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    names = {"bound", "clustered_bound", "k4_bound", "k5_bound",
             "intersect_ops", "intersect_bound"}
    assert not defined & names
    assert not assigned & {"PEAK_FP32", "PEAK_BYTES", "SPHERE_OPS",
                           "BOX_OPS", "OC_SPHERE_OPS"}
    imported = {a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                and n.module == "first_raytracer_tpu_torch.utils.roofline"
                for a in n.names}
    assert {"bound", "clustered_bound", "k4_bound", "k5_bound"} <= imported


def _read(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("sel", ["", "field20000", "field5000",
                                 "trifield20000"])
def test_golden_selection(sel):
    if sel:
        cfg = RenderConfig(nx=800, ny=450, spp=4)
        want = _read(bench.ORACLE_GOLDENS)["goldens"][sel]["radiance_sum"]
    else:
        cfg = RenderConfig(nx=1200, ny=800, spp=10)
        want = _read(bench.GOLDEN)["radiance_sum_mega_1200x800_10spp"]
    value, source = bench.golden_for(sel, cfg)
    assert value == want
    assert source.startswith("field_goldens_oracle.json" if sel
                             else "bench_golden.json")


@pytest.mark.parametrize("sel,cfg", [
    ("field600", RenderConfig(nx=800, ny=450, spp=4)),
    ("field20000", RenderConfig(nx=64, ny=32, spp=4)),
    ("", RenderConfig(nx=64, ny=32, spp=2))])
def test_missing_golden_is_an_error(sel, cfg):
    with pytest.raises(bench.BenchError, match="no .*golden"):
        bench.golden_for(sel, cfg)


@pytest.mark.parametrize("sel,recorder", [("", "K2b"), ("field60", "K3t")])
def test_grad_segments_are_the_recorders_trips_times_the_pipeline(
        sel, recorder):
    R, pipe = 96, 3
    m = bench.measure({"BENCH_DEVICE": "cpu", "BENCH_MODE": "grad",
                       "BENCH_SCENE": sel, "BENCH_GRAD_RAYS": str(R),
                       "BENCH_GRAD_PIPELINE": str(pipe)})
    scene, cam, cfg, _ = bench.select_scene(sel, torch.device("cpu"))
    key = rng.base_key(0)
    if recorder == "K2b":
        pack = mk.pack_scene_mega(scene)
        _, trips = rm.record_paths_mega(pack, cam, cfg, key, num_rays=R,
                                        return_iters=True)
        ops = roofline.dense_ops(pack, int(trips.sum()))
    else:
        pack = mc.pack_scene_mega_clustered(scene, cam)
        _, trips, sweeps = rm.record_paths_mega_clustered(
            pack, cam, cfg, key, num_rays=R, return_iters=True)
        ops = roofline.clustered_ops(sweeps.long().sum(0).tolist())
    assert m.kernel == recorder and m.total == R * pipe
    assert m.segments == int(trips.sum()) * pipe > 0
    assert m.ops == ops * pipe


def test_regenerative_counts_the_wavefront_segments():
    scene, cam, cfg = random_scene(nx=12, ny=8, spp=2)
    key = rng.base_key(0)
    ids = torch.arange(cfg.num_rays)
    rad, segs = render_ray_batch(scene, cam, cfg, key, ids,
                                 return_stats=True)
    rad_p, segs_p = render_rays_regenerative(scene, cam, cfg, key, 0,
                                             cfg.num_rays, pool_size=64,
                                             return_stats=True)
    assert torch.equal(segs_p, segs)
    assert float((rad_p - rad).abs().max()) <= 2e-6
    assert torch.equal(render_rays_regenerative(
        scene, cam, cfg, key, 0, cfg.num_rays, pool_size=64), rad_p)


def _tiny(sel, device):
    """A frame of a few hundred rays under ``sel``'s label."""
    if sel.startswith("field"):
        scene, cam, cfg = sphere_field(n=60, nx=16, ny=8, spp=2,
                                       device=device)
    else:
        scene, cam, cfg = random_scene(nx=16, ny=8, spp=2, device=device)
    return scene, cam, cfg, f"Mpaths/s tiny {sel}"


def _fixed_times(*times):
    def timer(fn, *args, repeats=3, **kwargs):
        for _ in range(repeats):
            fn(*args, **kwargs)
        return list(times)
    return timer


@pytest.fixture
def tiny_bench(monkeypatch, tmp_path):
    """The bench on tiny frames: its history and the fields' golden file in
    ``tmp_path`` (field60's golden the plain K3's radiance sum), repeats of
    one run each, timed at 10 ms."""
    monkeypatch.setattr(bench, "select_scene", _tiny)
    monkeypatch.setattr(bench, "HISTORY", str(tmp_path / "history.json"))
    scene, cam, cfg, _ = _tiny("field60", torch.device("cpu"))
    rad, _ = mc.render_pixels_mega_clustered(
        mc.pack_scene_mega_clustered(scene, cam), cam, cfg, rng.base_key(0))
    goldens = tmp_path / "goldens.json"
    goldens.write_text(json.dumps({"goldens": {"field60": dict(
        nx=cfg.nx, ny=cfg.ny, spp=cfg.spp, max_depth=cfg.max_depth, seed=0,
        radiance_sum=float(rad.double().sum()))}}))
    monkeypatch.setattr(bench, "ORACLE_GOLDENS", str(goldens))
    monkeypatch.setattr(bench, "time_repeats", _fixed_times(0.01, 0.01,
                                                            0.01))
    monkeypatch.setattr(bench, "MIN_REPEAT_S", 0.0)
    return tmp_path


def _main(capsys, env):
    rc = bench.main(env)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


CPU_FIELD = {"BENCH_DEVICE": "cpu", "BENCH_SCENE": "field60",
             "BENCH_MODE": "megacluster"}


def test_run_prints_the_line_and_keeps_its_history(tiny_bench, capsys):
    rc, line = _main(capsys, CPU_FIELD)
    assert rc == 0 and set(line) == LINE_KEYS
    assert line["value"] == pytest.approx(256 / 0.01 / 1e6)
    assert line["vs_baseline"] == 1.0 and line["device"] == "cpu"
    assert line["launches"] == {k: 0 for k, _, _ in bench.COUNTERS}
    assert line["seconds"] == 0.01
    hist = _read(tiny_bench / "history.json")
    assert hist == {"cpu": {"field60/megacluster": line["value"]}}
    rc, line = _main(capsys, CPU_FIELD)
    assert rc == 0 and line["vs_baseline"] == pytest.approx(1.0)


def _wrong_golden(tmp_path, monkeypatch):
    path = tmp_path / "goldens.json"
    data = _read(path)
    data["goldens"]["field60"]["radiance_sum"] *= 1.5
    path.write_text(json.dumps(data))


def _no_peak(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "device_peak", lambda dev: 1.0)


def _spread(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "time_repeats", _fixed_times(0.001, 0.01,
                                                            0.01))


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("fault,reason", [
    (_wrong_golden, "mismatches golden"), (_no_peak, "physically impossible"),
    (_spread, "disagree")], ids=["checksum", "work", "spread"])
def test_guard_failure_prints_one_error_and_keeps_no_history(
        tiny_bench, capsys, monkeypatch, fault, reason):
    shas = [_sha(p) for p in (bench.GOLDEN, os.path.join(
        REPO, "first_raytracer_tpu_torch", "data",
        "field_goldens_oracle.json"))]
    fault(tiny_bench, monkeypatch)
    rc, line = _main(capsys, CPU_FIELD)
    assert rc == 2 and reason in line["error"]
    assert not (tiny_bench / "history.json").exists()
    assert shas == [_sha(p) for p in (bench.GOLDEN, os.path.join(
        REPO, "first_raytracer_tpu_torch", "data",
        "field_goldens_oracle.json"))]


def test_wavefront_modes_count_the_same_segments(tiny_bench):
    env = {"BENCH_DEVICE": "cpu", "BENCH_CHUNK": "100", "BENCH_POOL": "64"}
    wave = bench.measure(dict(env, BENCH_MODE="wavefront"))
    regen = bench.measure(dict(env, BENCH_MODE="regenerative"))
    scene, cam, cfg, _ = _tiny("", torch.device("cpu"))
    _, segs = render_ray_batch(scene, cam, cfg, rng.base_key(0),
                               torch.arange(cfg.num_rays),
                               return_stats=True)
    assert wave.segments == regen.segments == int(segs.sum())
    assert wave.kernel == regen.kernel == "K4"
    # K4's plain version over the rays of every call: the wavefront's
    # chunks trace dead rays too, the pool only its slots.
    assert wave.ops > regen.ops > 0


def test_bvh_names_k6_and_counts_the_same_segments(tiny_bench):
    """``BENCH_INTERSECT=bvh``: the closest hit is K6 (on the CPU its plain
    walk, which keeps no counters, so the guard counts no work) and the
    pool traces the dense sweep's segments."""
    env = {"BENCH_DEVICE": "cpu", "BENCH_POOL": "64",
           "BENCH_INTERSECT": "bvh", "BENCH_MODE": "regenerative"}
    regen = bench.measure(env)
    scene, cam, cfg, _ = _tiny("", torch.device("cpu"))
    _, segs = render_ray_batch(scene, cam, cfg, rng.base_key(0),
                               torch.arange(cfg.num_rays),
                               return_stats=True)
    assert regen.kernel == "K6" and regen.ops == 0
    assert regen.segments == int(segs.sum())


@pytest.mark.parametrize("env,reason", [
    ({"BENCH_GATE": "wl"}, "ROADMAP.md"),
    ({"BENCH_GRAD_KRAYS": "32"}, "ROADMAP.md"),
    ({"BENCH_RECORD_GOLDEN": "1"}, "ROADMAP.md"),
    ({"BENCH_MODE": "pathtrace"}, "unknown BENCH_MODE"),
    ({"BENCH_INTERSECT": "grid"}, "unknown BENCH_INTERSECT"),
    ({"BENCH_SCENE": "cornell"}, "unknown BENCH_SCENE"),
    ({"BENCH_SCENE": "field5000"}, "past DENSE_MAX"),
], ids=["gate", "krays", "record_golden", "mode", "intersect", "scene",
        "mega_past_dense_max"])
def test_refused_switch_prints_one_error_and_keeps_no_history(
        monkeypatch, tmp_path, capsys, env, reason):
    monkeypatch.setattr(bench, "HISTORY", str(tmp_path / "history.json"))
    rc, line = _main(capsys, dict(env, BENCH_DEVICE="cpu"))
    assert rc == 2 and reason in line["error"]
    assert not (tmp_path / "history.json").exists()


def test_no_gpu_is_an_error_not_a_host_run(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "HISTORY", str(tmp_path / "history.json"))
    rc, line = _main(capsys, {})
    assert rc == 2 and "no CUDA device" in line["error"]
    assert not (tmp_path / "history.json").exists()


def test_entry_script_without_gpu_exits_2(tmp_path):
    """``python3 bench_torch.py`` as a user runs it, on a host without a
    GPU: one error line, exit 2, no history."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry would run on it")
    history = os.path.join(REPO, "out", "bench_torch_history.json")
    before = _sha(history) if os.path.exists(history) else None
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 2 and len(lines) == 1
    assert "no CUDA device" in json.loads(lines[0])["error"]
    after = _sha(history) if os.path.exists(history) else None
    assert before == after


def test_repeats_queue_runs_to_last_the_minimum(monkeypatch):
    # A run of about 1 ms is queued about 1000 times a repeat: a host stall
    # of the 2 ms K3 frames' size, or of a host-bound gradient step's, no
    # longer decides the spread guard.
    calls = []
    monkeypatch.setattr(bench.time, "perf_counter",
                        lambda: 0.001 * len(calls))
    n = bench.runs_per_repeat(lambda fn: calls.append(fn), None,
                              torch.device("cpu"))
    assert calls == [None] * bench.SIZING_RUNS and n == 1000
    # A run that lasts a repeat is the only sizing run.
    del calls[:]
    monkeypatch.setattr(bench.time, "perf_counter",
                        lambda: 30.0 * len(calls))
    assert bench.runs_per_repeat(lambda fn: calls.append(fn), None,
                                 torch.device("cpu")) == 1
    assert calls == [None]


def test_a_stalled_sizing_run_does_not_shorten_the_repeats(monkeypatch):
    # The first untimed run meets a 250 ms stall of the host, the others
    # take 1/64 s: the repeats are sized by the 1/64 s.
    clock, calls = [0.0], []

    def run(fn):
        calls.append(fn)
        clock[0] += 0.25 + 2.0 ** -6 if len(calls) == 1 else 2.0 ** -6
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock[0])
    n = bench.runs_per_repeat(run, None, torch.device("cpu"))
    assert len(calls) == bench.SIZING_RUNS
    assert n == math.ceil(bench.MIN_REPEAT_S * 64)
