"""The scene's per-primitive rows as tables, for the gradient paths.

- ``payload_tables``: the tape replay's (``diff/replay_pass.py``): a
  sphere's centre and radius, a triangle's vertices, each followed by its
  material's row (``mat_block``), (Ns, 15) and (Nt, 20).
- ``row_tables``: the differentiable scan's (``render/integrator.py``,
  ``recompute_hit_rows``): the spheres' (Ns, 4) and triangles' (Nt, 9)
  geometry and the materials' (Nm, 11) rows, each a ``torch.cat`` of the
  scene's own tensors, so their backward is slices, not an index
  backward; a ray reads its material row by its material id.

Both are differentiable in every scene leaf they hold.  The material row
is mtype, fuzz, ref_idx, albedo (3), albedo2 (3), tex_scale, tex_type; the
integer types ride as floats (exact) and are cast back on use
(``materials/scatter.py::scatter_rows``).
"""
from __future__ import annotations

import torch

__all__ = ["mat_block", "material_table", "payload_tables", "row_tables"]


def _mat_columns(scene, pick):
    """The material row's columns, each through ``pick``."""
    return [pick(scene.mat_type).to(torch.float32)[:, None],
            pick(scene.fuzz)[:, None],
            pick(scene.ref_idx)[:, None],
            pick(scene.albedo),
            pick(scene.albedo2),
            pick(scene.tex_scale)[:, None],
            pick(scene.tex_type).to(torch.float32)[:, None]]


def mat_block(scene, mat_ids):
    """(N, 11) material rows for per-primitive material ids."""
    m = mat_ids.long()
    return torch.cat(_mat_columns(scene, lambda x: x[m]), dim=1)


def material_table(scene):
    """(Nm, 11): one row a material."""
    return torch.cat(_mat_columns(scene, lambda x: x), dim=1)


def payload_tables(scene):
    """Per-primitive payload tables: (Ns, 4 + 11) spheres, (Nt, 9 + 11)
    triangles; geometry and the material row in one table, None where the
    scene has no such primitive."""
    sph = tri = None
    if scene.num_spheres:
        sph = torch.cat([scene.sphere_center, scene.sphere_radius[:, None],
                         mat_block(scene, scene.sphere_mat)], dim=1)
    if scene.num_triangles:
        tri = torch.cat([scene.tri_v0, scene.tri_v1, scene.tri_v2,
                         mat_block(scene, scene.tri_mat)], dim=1)
    return sph, tri


def row_tables(scene):
    """(spheres (Ns, 4), triangles (Nt, 9), materials (Nm, 11)): geometry
    tables None where the scene has no such primitive."""
    sph = tri = None
    if scene.num_spheres:
        sph = torch.cat([scene.sphere_center, scene.sphere_radius[:, None]],
                        dim=1)
    if scene.num_triangles:
        tri = torch.cat([scene.tri_v0, scene.tri_v1, scene.tri_v2], dim=1)
    return sph, tri, material_table(scene)
