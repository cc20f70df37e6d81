"""Meshes (port of bevy_tpu/render/mesh.py; ref: bevy_mesh Mesh + the
cuboid primitive, bevy_render MeshAllocator).

Meshes are host-side numpy data. The instanced mesh pass reads a mesh's
positions and normals directly (uniform batches), so the pool is a plain
registry of host meshes.
"""

from __future__ import annotations

from typing import List

import numpy as np


class Mesh:
    """Host-side mesh: positions (V,3), normals (V,3), uvs (V,2),
    triangles (T,3) int32 (CCW front faces, right-handed y-up)."""

    def __init__(self, positions, normals, uvs, triangles):
        self.positions = np.asarray(positions, np.float32)
        self.normals = np.asarray(normals, np.float32)
        self.uvs = np.asarray(uvs, np.float32)
        self.triangles = np.asarray(triangles, np.int32)

    @property
    def num_vertices(self):
        return self.positions.shape[0]

    @property
    def num_triangles(self):
        return self.triangles.shape[0]


def cuboid(x=1.0, y=1.0, z=1.0) -> Mesh:
    """ref: bevy_mesh/src/primitives/dim3/cuboid.rs — 24 verts (per-face
    normals), 12 tris."""
    hx, hy, hz = x / 2, y / 2, z / 2
    faces = [
        # (normal, corners CCW viewed from outside)
        ((0, 0, 1), [(-hx, -hy, hz), (hx, -hy, hz), (hx, hy, hz), (-hx, hy, hz)]),
        ((0, 0, -1), [(hx, -hy, -hz), (-hx, -hy, -hz), (-hx, hy, -hz), (hx, hy, -hz)]),
        ((1, 0, 0), [(hx, -hy, hz), (hx, -hy, -hz), (hx, hy, -hz), (hx, hy, hz)]),
        ((-1, 0, 0), [(-hx, -hy, -hz), (-hx, -hy, hz), (-hx, hy, hz), (-hx, hy, -hz)]),
        ((0, 1, 0), [(-hx, hy, hz), (hx, hy, hz), (hx, hy, -hz), (-hx, hy, -hz)]),
        ((0, -1, 0), [(-hx, -hy, -hz), (hx, -hy, -hz), (hx, -hy, hz), (-hx, -hy, hz)]),
    ]
    pos, nrm, uv, tri = [], [], [], []
    for normal, corners in faces:
        base = len(pos)
        pos += corners
        nrm += [normal] * 4
        uv += [(0, 1), (1, 1), (1, 0), (0, 0)]
        tri += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    return Mesh(pos, nrm, uv, tri)


class MeshPool:
    """Host registry of meshes; `add` returns the id a Mesh3d holds."""

    def __init__(self):
        self.meshes: List[Mesh] = []

    def add(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1
