"""Meshes (port of bevy_tpu/render/mesh.py; ref: bevy_mesh Mesh + the
primitive meshers, bevy_render MeshAllocator).

Meshes are host-side numpy data. The instanced mesh pass reads a mesh's
positions and normals directly (uniform batches); the general mesh route
reads the pool as one device slab (`MeshPool.build`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch


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

    def tri_tangents(self):
        """(T, 3) per-triangle tangents in mesh space from position / UV
        derivatives (ref: bevy_mesh's mikktspace pass, per-face flavour);
        they rotate with the instance like normals. Host numpy."""
        p = self.positions[self.triangles]          # (T, 3, 3)
        uv = self.uvs[self.triangles]               # (T, 3, 2)
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        d1 = uv[:, 1] - uv[:, 0]
        d2 = uv[:, 2] - uv[:, 0]
        det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
        inv = np.where(np.abs(det) > 1e-8, 1.0 / np.where(det == 0, 1, det),
                       0.0)[:, None]
        t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * inv
        n = np.linalg.norm(t, axis=1, keepdims=True)
        fallback = np.tile([1.0, 0.0, 0.0], (len(t), 1))
        return np.where(n > 1e-8, t / np.maximum(n, 1e-8),
                        fallback).astype(np.float32)


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


def uv_sphere(radius=0.5, sectors=36, stacks=18) -> Mesh:
    """ref: primitives/dim3/sphere.rs (SphereKind::Uv)."""
    pos, nrm, uv = [], [], []
    for i in range(stacks + 1):
        phi = math.pi / 2 - i * math.pi / stacks
        y = radius * math.sin(phi)
        r = radius * math.cos(phi)
        for j in range(sectors + 1):
            theta = j * 2 * math.pi / sectors
            p = (r * math.cos(theta), y, r * math.sin(theta))
            pos.append(p)
            n = np.asarray(p) / max(radius, 1e-9)
            nrm.append(tuple(n))
            uv.append((j / sectors, i / stacks))
    tri = []
    for i in range(stacks):
        for j in range(sectors):
            a = i * (sectors + 1) + j
            b = a + sectors + 1
            if i != 0:
                tri.append((a, a + 1, b))
            if i != stacks - 1:
                tri.append((a + 1, b + 1, b))
    return Mesh(pos, nrm, uv, tri)


def plane(x=1.0, z=1.0) -> Mesh:
    """ref: primitives/dim3/plane.rs — y-up plane."""
    hx, hz = x / 2, z / 2
    pos = [(-hx, 0, -hz), (hx, 0, -hz), (hx, 0, hz), (-hx, 0, hz)]
    nrm = [(0, 1, 0)] * 4
    uv = [(0, 0), (1, 0), (1, 1), (0, 1)]
    tri = [(0, 2, 1), (0, 3, 2)]
    return Mesh(pos, nrm, uv, tri)


def cylinder(radius=0.5, height=1.0, sectors=32) -> Mesh:
    """ref: bevy_mesh/src/primitives/dim3/cylinder.rs — side + caps."""
    pos, nrm, uv, tri = [], [], [], []
    hh = height / 2
    # side
    for i in range(sectors + 1):
        a = 2 * np.pi * i / sectors
        x, z = np.cos(a), np.sin(a)
        for y, v in ((hh, 0.0), (-hh, 1.0)):
            pos.append((radius * x, y, radius * z))
            nrm.append((x, 0.0, z))
            uv.append((i / sectors, v))
    for i in range(sectors):
        b = i * 2
        tri += [(b, b + 2, b + 1), (b + 1, b + 2, b + 3)]
    # caps
    for sign, ny in ((1.0, 1.0), (-1.0, -1.0)):
        center = len(pos)
        pos.append((0.0, sign * hh, 0.0))
        nrm.append((0.0, ny, 0.0))
        uv.append((0.5, 0.5))
        ring = len(pos)
        for i in range(sectors + 1):
            a = 2 * np.pi * i / sectors
            pos.append((radius * np.cos(a), sign * hh, radius * np.sin(a)))
            nrm.append((0.0, ny, 0.0))
            uv.append((0.5 + 0.5 * np.cos(a), 0.5 + 0.5 * np.sin(a)))
        for i in range(sectors):
            if sign > 0:
                tri.append((center, ring + i + 1, ring + i))
            else:
                tri.append((center, ring + i, ring + i + 1))
    return Mesh(pos, nrm, uv, tri)


def torus(major_radius=0.75, minor_radius=0.25, major_sectors=32,
          minor_sectors=16) -> Mesh:
    """ref: primitives/dim3/torus.rs."""
    pos, nrm, uv, tri = [], [], [], []
    for i in range(major_sectors + 1):
        a = 2 * np.pi * i / major_sectors
        ca, sa = np.cos(a), np.sin(a)
        for j in range(minor_sectors + 1):
            b = 2 * np.pi * j / minor_sectors
            cb, sb = np.cos(b), np.sin(b)
            pos.append(((major_radius + minor_radius * cb) * ca,
                        minor_radius * sb,
                        (major_radius + minor_radius * cb) * sa))
            nrm.append((cb * ca, sb, cb * sa))
            uv.append((i / major_sectors, j / minor_sectors))
    stride = minor_sectors + 1
    for i in range(major_sectors):
        for j in range(minor_sectors):
            b0 = i * stride + j
            tri += [(b0, b0 + 1, b0 + stride),
                    (b0 + 1, b0 + stride + 1, b0 + stride)]
    return Mesh(pos, nrm, uv, tri)


def cone(radius=0.5, height=1.0, sectors=32) -> Mesh:
    """ref: primitives/dim3/cone.rs — apex up, flat base."""
    pos, nrm, uv, tri = [], [], [], []
    hh = height / 2
    slope = radius / height
    for i in range(sectors + 1):
        a = 2 * np.pi * i / sectors
        x, z = np.cos(a), np.sin(a)
        n = np.asarray([x, slope, z])
        n /= np.linalg.norm(n)
        pos.append((0.0, hh, 0.0))
        nrm.append(tuple(n))
        uv.append((i / sectors, 0.0))
        pos.append((radius * x, -hh, radius * z))
        nrm.append(tuple(n))
        uv.append((i / sectors, 1.0))
    for i in range(sectors):
        b = i * 2
        tri.append((b, b + 3, b + 1))
    base = len(pos)
    pos.append((0.0, -hh, 0.0))
    nrm.append((0.0, -1.0, 0.0))
    uv.append((0.5, 0.5))
    ring = len(pos)
    for i in range(sectors + 1):
        a = 2 * np.pi * i / sectors
        pos.append((radius * np.cos(a), -hh, radius * np.sin(a)))
        nrm.append((0.0, -1.0, 0.0))
        uv.append((0.5 + 0.5 * np.cos(a), 0.5 + 0.5 * np.sin(a)))
    for i in range(sectors):
        tri.append((base, ring + i, ring + i + 1))
    return Mesh(pos, nrm, uv, tri)


def capsule(radius=0.5, length=1.0, sectors=24, stacks=8) -> Mesh:
    """ref: primitives/dim3/capsule.rs — hemisphere caps on a cylinder
    (one continuous ring strip, so the surface is watertight)."""
    pos, nrm, uv, tri = [], [], [], []
    hl = length / 2
    rows = []                 # (ring radius factor, normal y, y offset)
    for i in range(stacks + 1):                # top pole → equator
        phi = (np.pi / 2) * i / stacks
        rows.append((np.sin(phi), np.cos(phi), hl))
    for i in range(1, stacks + 1):             # equator → bottom pole
        psi = (np.pi / 2) * i / stacks
        rows.append((np.cos(psi), -np.sin(psi), -hl))
    for r, (sr, ny, yoff) in enumerate(rows):
        y = ny * radius + yoff
        for j in range(sectors + 1):
            a = 2 * np.pi * j / sectors
            x, z = np.cos(a) * sr, np.sin(a) * sr
            pos.append((radius * x, y, radius * z))
            n = np.asarray([x, ny, z])
            ln = np.linalg.norm(n)
            nrm.append(tuple(n / ln) if ln > 1e-6 else (0.0, 1.0, 0.0))
            uv.append((j / sectors, r / (len(rows) - 1)))
    stride = sectors + 1
    for i in range(len(rows) - 1):
        for j in range(sectors):
            b0 = i * stride + j
            tri += [(b0, b0 + 1, b0 + stride),
                    (b0 + 1, b0 + stride + 1, b0 + stride)]
    return Mesh(pos, nrm, uv, tri)


class MeshPool:
    """Host registry of meshes; `add` returns the id a Mesh3d holds."""

    RESOURCE = "mesh_pool"

    def __init__(self):
        self.meshes: List[Mesh] = []

    def add(self, mesh: Mesh) -> int:
        self.meshes.append(mesh)
        return len(self.meshes) - 1

    def build(self, device) -> Dict:
        """The device slab (ref: MeshAllocator allocate/slab): concatenated
        attributes, triangle indices offset into the pool, per-mesh
        (vert_offset, vert_count, tri_offset, tri_count, bounding radius)
        tables, on `device`. An empty pool gets a unit cuboid first."""
        if not self.meshes:
            self.add(cuboid())
        v_cnt = np.asarray([m.num_vertices for m in self.meshes])
        t_cnt = np.asarray([m.num_triangles for m in self.meshes])
        v_off = np.cumsum(v_cnt) - v_cnt
        radius = [float(np.linalg.norm(m.positions, axis=1).max()
                        if m.num_vertices else 0.0) for m in self.meshes]

        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return {
            "positions": dev(np.concatenate(
                [m.positions for m in self.meshes]), torch.float32),
            "normals": dev(np.concatenate(
                [m.normals for m in self.meshes]), torch.float32),
            "uvs": dev(np.concatenate([m.uvs for m in self.meshes]),
                       torch.float32),
            "triangles": dev(np.concatenate(
                [m.triangles + o for m, o in zip(self.meshes, v_off)]),
                torch.int32),
            "vert_offset": dev(v_off, torch.int32),
            "vert_count": dev(v_cnt, torch.int32),
            "tri_offset": dev(np.cumsum(t_cnt) - t_cnt, torch.int32),
            "tri_count": dev(t_cnt, torch.int32),
            "radius": dev(radius, torch.float32),
        }
