"""The book's random scenes, made from a seed: the benchmark's own copy.

Frozen copy of ``random_scene`` in
``first_raytracer_tpu_torch/scene/builders.py`` (with ``SceneBuilder`` of
``scene/soa.py``), the construction of Shirley's *Ray Tracing in One
Weekend* ch. 12 ``random_scene()``: a ground sphere, a jittered grid of
small spheres with the book's material roulette (lambertian below 0.8,
metal below 0.95, else glass), and three feature spheres.  The draws are
``np.random.RandomState(seed)``'s in the same order, so a seed gives the
port's preset arrays; a configuration fixes its scene's seed.  A
configuration file's ``scene`` object names its kind: ``"book"`` (the
22 x 22 grid, skipping spheres near the metal feature sphere).

Returns plain numpy arrays, handed alike to the program and to the
reference.
"""
from __future__ import annotations

import numpy as np

MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC = 0, 1, 2


class _Builder:
    def __init__(self):
        self.spheres, self.mats = [], []

    def material(self, mtype, albedo=(0.0, 0.0, 0.0), fuzz=0.0, ref=1.0):
        # The book's metal clamps its fuzz to 1.
        self.mats.append((mtype, tuple(albedo), min(float(fuzz), 1.0)
                          if mtype == MAT_METAL else 0.0, float(ref)))
        return len(self.mats) - 1

    def roulette(self, rng):
        """The book's material draw for a small sphere: the roulette's
        draw now, the material's own draws when the returned function is
        called (after the sphere's center, as the book draws them)."""
        choose = rng.rand()
        return lambda: (
            self.material(MAT_LAMBERTIAN, rng.rand(3) * rng.rand(3))
            if choose < 0.8 else
            self.material(MAT_METAL, 0.5 * (1.0 + rng.rand(3)),
                          fuzz=0.5 * rng.rand())
            if choose < 0.95 else self.material(MAT_DIELECTRIC, ref=1.5))

    def sphere(self, center, radius, mat):
        self.spheres.append((tuple(center), float(radius), int(mat)))

    def arrays(self):
        m = self.mats
        return dict(
            sphere_center=np.asarray([s[0] for s in self.spheres],
                                     np.float32).reshape(-1, 3),
            sphere_radius=np.asarray([s[1] for s in self.spheres], np.float32),
            sphere_mat=np.asarray([s[2] for s in self.spheres], np.int32),
            mat_type=np.asarray([x[0] for x in m], np.int32),
            albedo=np.asarray([x[1] for x in m], np.float32).reshape(-1, 3),
            fuzz=np.asarray([x[2] for x in m], np.float32),
            ref_idx=np.asarray([x[3] for x in m], np.float32))


def _features(b):
    b.sphere((0.0, 1.0, 0.0), 1.0, b.material(MAT_DIELECTRIC, ref=1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.material(MAT_LAMBERTIAN, (0.4, 0.2, 0.1)))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.material(MAT_METAL, (0.7, 0.6, 0.5)))


def book_scene(seed: int):
    """``random_scene()``: the ground, the 22 x 22 grid (a sphere within
    0.9 of (4, 0.2, 0) is skipped), the three feature spheres."""
    rng = np.random.RandomState(seed)
    b = _Builder()
    b.sphere((0.0, -1000.0, 0.0), 1000.0,
             b.material(MAT_LAMBERTIAN, (0.5, 0.5, 0.5)))
    for a in range(-11, 11):
        for bb in range(-11, 11):
            make = b.roulette(rng)
            center = np.array([a + 0.9 * rng.rand(), 0.2,
                               bb + 0.9 * rng.rand()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            b.sphere(center, 0.2, make())
    _features(b)
    return b.arrays()


def build(config):
    """The scene arrays of a configuration's ``scene`` object, drawn from
    its ``seed``: one scene a configuration, so that every run does the
    same work."""
    spec = config["scene"]
    seed = int(spec["seed"])
    if spec["kind"] == "book":
        return book_scene(seed)
    raise ValueError(f"unknown scene kind {spec['kind']!r}")
