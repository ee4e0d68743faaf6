"""What a run loads: no module of JAX or of the JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and the reference loads nothing of the port."""
import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "first_raytracer_tpu"}

REHEARSAL = """
import copy, json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark import run, scenes
from benchmark.spec import Spec
spec = Spec({root!r})
cell = spec.cell({cell!r})
cell.config = copy.deepcopy(cell.config)
cell.config["image"].update(nx=8, ny=4, spp=1)
cell.limits = dict(cell.limits, check={{"requests": 1, "pixels": 8}})
small = lambda cfg: scenes.book_scene(5)
res = run.run_cell(spec, cell, 7, 0.05, False, "cpu", scene_override=small)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import scenes
from benchmark.reference.tracer import Reference
cfg = json.load(open({root!r} + "/benchmark/configs/final_scene.json"))
img = dict(cfg["image"], nx=4, ny=2, spp=1)
ref = Reference(scenes.book_scene(1), cfg["camera"], img, "cpu")
ref.pixel_means(3, torch.arange(8), 5)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["final_scene.oneshot",
                                  "final_scene.oneshot_clustered",
                                  "final_scene.fit",
                                  "final_scene.fit_clustered"])
def test_a_cells_rehearsal_loads_no_jax(cell):
    mods = _modules(REHEARSAL.format(root=ROOT, cell=cell))
    assert "first_raytracer_tpu_torch" in mods
    assert not mods & FORBIDDEN, sorted(mods & FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules(REFERENCE.format(root=ROOT))
    assert not mods & (FORBIDDEN | {"first_raytracer_tpu_torch"})


def test_run_refuses_without_a_card():
    """Without a CUDA device the run exits with another code than 0 and
    prints no result."""
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "final_scene.oneshot", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
