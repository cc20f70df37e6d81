"""Wireframe rendering (port of bevy_tpu/render/wireframe.py; ref:
bevy_pbr/src/wireframe.rs: a `Wireframe` marker + `WireframeColor`
drawing a mesh's edges over the scene).

A mesh's unique edges are extracted on the host once, when the set of
wireframed entities changes (a prepare hook, the position of the JAX
package's trace-time read); each frame the edge end points turn with the
entities' GlobalTransforms on the device and go into the gizmo buffer as
one masked batch a mesh, which the gizmo pass (render/gizmos.py) draws
through the tile raster (kernel B4). Needs GizmosPlugin.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import Update
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Read
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.quat import quat_rotate_vec3
from bevy_tpu_torch.render.gizmos import Gizmos
from bevy_tpu_torch.render.mesh3d import Mesh3d
from bevy_tpu_torch.transform import GlobalTransform


@component
class Wireframe:
    """ref: the Wireframe marker + WireframeColor."""
    color = field(4, default=(0.1, 1.0, 0.3, 1.0))
    width = field((), default=1.0)


def mesh_edges(mesh) -> np.ndarray:
    """(E, 2) unique undirected edges of a mesh's triangles."""
    tris = np.asarray(mesh.triangles, np.int64)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                        tris[:, [2, 0]]], 0)
    return np.unique(np.sort(e, axis=1), axis=0)


def wire_segments(local, tr, ro, sc):
    """World end points (R * E, 3) a and b of edges `local` (E, 2, 3) on R
    instances with translation, rotation and scale rows (R, 3|4|3)."""
    nr, ne = tr.shape[0], local.shape[0]
    p = local[None] * sc[:, None, None, :]
    p = quat_rotate_vec3(ro[:, None, None, :].expand(nr, ne, 2, 4), p)
    p = p + tr[:, None, None, :]
    return p[:, :, 0].reshape(nr * ne, 3), p[:, :, 1].reshape(nr * ne, 3)


class WireframePlugin(Plugin):
    """Draws the edges of every entity with a `Wireframe` (and a Mesh3d of
    `mesh_plugin`'s pool). `budget` caps the gizmo segments a batch."""

    def __init__(self, mesh_plugin, budget: int = 8192):
        self.mesh_plugin = mesh_plugin
        self.budget = budget
        self._groups = []

    def build(self, app):
        app.world.register_component(Wireframe)
        plugin = self

        def extract(world):
            """The wireframed rows by mesh, and each mesh's edge end
            points (E, 2, 3) on the device, in ascending mesh id."""
            rows = world.query_rows(Mesh3d, Wireframe)
            mesh_ids = world.column(Mesh3d, "mesh").cpu().numpy()[rows]
            dev = world.device
            plugin._groups = []
            for mid in sorted(set(int(m) for m in mesh_ids)):
                mesh = plugin.mesh_plugin.pool.meshes[mid]
                pts = np.asarray(mesh.positions, np.float32)[mesh_edges(mesh)]
                plugin._groups.append((
                    torch.as_tensor(rows[mesh_ids == mid].astype(np.int64),
                                    device=dev),
                    torch.from_numpy(pts).to(dev)))

        @system(name="wireframe_pass")
        def wireframe_pass(q=Query(Read(Mesh3d), Read(Wireframe),
                                   Read(GlobalTransform)),
                           g=Gizmos(budget=self.budget)):
            gt = q.global_transform
            for ridx, local in plugin._groups:
                a, b = wire_segments(local, gt.translation[ridx],
                                     gt.rotation[ridx], gt.scale[ridx])
                n = a.shape[0]
                ne = local.shape[0]
                col = q.wireframe.color[ridx][:, None, :].expand(
                    -1, ne, 4).reshape(n, 4)
                wid = q.wireframe.width[ridx][:, None].expand(-1, ne) \
                    .reshape(n)
                mask = q.mask[ridx][:, None].expand(-1, ne).reshape(n)
                g._segments.append(
                    (a, b, col, wid, torch.ones(n, dtype=torch.bool,
                                                device=a.device), mask))

        app.add_prepare_hook(extract)
        app.add_systems(Update, wireframe_pass)
