"""Irradiance volumes (port of bevy_tpu/render/irradiance.py; ref:
bevy_pbr/src/light_probe/irradiance_volume.rs: a 3D grid of ambient cubes
adding baked diffuse indirect light by world position, six colours a
voxel for +x, -x, +y, -y, +z, -z).

One image pass over the deferred G-buffer after the shade: world
positions from the depth, the grid interpolated trilinearly (8 corner
gathers), the six axis colours blended by the squared world normal (the
ambient-cube basis). Needs Mesh3dPlugin(deferred=True).
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.camera import Camera3d, pixel_world
from bevy_tpu_torch.render.plugin import SHADE_SET, RenderTarget
from bevy_tpu_torch.render.post import camera_vp, inverse
from bevy_tpu_torch.transform import GlobalTransform


def _trilinear_cube(volume, u, v, w):
    """volume (nx, ny, nz, 6, 3); u, v, w (H, W) in texel space [0, n-1].
    Returns (H, W, 6, 3)."""
    nx, ny, nz = volume.shape[:3]
    i0 = torch.clamp(torch.floor(u).to(torch.int32), 0, nx - 1)
    j0 = torch.clamp(torch.floor(v).to(torch.int32), 0, ny - 1)
    k0 = torch.clamp(torch.floor(w).to(torch.int32), 0, nz - 1)
    i1 = torch.clamp(i0 + 1, max=nx - 1)
    j1 = torch.clamp(j0 + 1, max=ny - 1)
    k1 = torch.clamp(k0 + 1, max=nz - 1)
    fu = torch.clamp(u - i0, 0.0, 1.0)[..., None, None]
    fv = torch.clamp(v - j0, 0.0, 1.0)[..., None, None]
    fw = torch.clamp(w - k0, 0.0, 1.0)[..., None, None]
    flat = volume.reshape(nx * ny * nz, 6, 3)

    def at(i, j, k):
        return flat[((i * ny + j) * nz + k).long()]

    c00 = at(i0, j0, k0) * (1 - fu) + at(i1, j0, k0) * fu
    c10 = at(i0, j1, k0) * (1 - fu) + at(i1, j1, k0) * fu
    c01 = at(i0, j0, k1) * (1 - fu) + at(i1, j0, k1) * fu
    c11 = at(i0, j1, k1) * (1 - fu) + at(i1, j1, k1) * fu
    c0 = c00 * (1 - fv) + c10 * fv
    c1 = c01 * (1 - fv) + c11 * fv
    return c0 * (1 - fw) + c1 * fw


def irradiance_volume(c, g, depth, has_cam, world, volume, lo, span,
                      intensity):
    """The volume's diffuse term over the G-buffer `g` at world positions
    (H, W, 3), added to the colour (4, H, W) where the pixel is covered
    and inside the volume's box."""
    nx, ny, nz = volume.shape[:3]
    t = (world - lo) / span
    inside = torch.all((t >= 0.0) & (t <= 1.0), -1) & (depth > 0.0) & \
        has_cam
    cube = _trilinear_cube(volume, t[..., 0] * (nx - 1),
                           t[..., 1] * (ny - 1), t[..., 2] * (nz - 1))
    n = g[4:7].permute(1, 2, 0)
    w2 = n * n
    pos = (n > 0.0).to(torch.float32)
    irr = (cube[..., 0, :] * (w2[..., 0:1] * pos[..., 0:1]) +
           cube[..., 1, :] * (w2[..., 0:1] * (1 - pos[..., 0:1])) +
           cube[..., 2, :] * (w2[..., 1:2] * pos[..., 1:2]) +
           cube[..., 3, :] * (w2[..., 1:2] * (1 - pos[..., 1:2])) +
           cube[..., 4, :] * (w2[..., 2:3] * pos[..., 2:3]) +
           cube[..., 5, :] * (w2[..., 2:3] * (1 - pos[..., 2:3])))
    albedo = g[0:3].permute(1, 2, 0)
    add = albedo * (1.0 - g[10][..., None]) * irr * intensity
    rgb = torch.where(inside[None], c[:3] + add.permute(2, 0, 1), c[:3])
    return torch.cat([rgb, c[3:4]], 0)


class IrradianceVolumePlugin(Plugin):
    """A baked diffuse-irradiance grid added over the deferred result.

    volume: (nx, ny, nz, 6, 3) ambient-cube colours, axis order [+x, -x,
    +y, -y, +z, -z]; min_corner / max_corner: the world box the grid
    spans; intensity scales it (ref: IrradianceVolume { voxels,
    intensity })."""

    def __init__(self, volume, min_corner, max_corner, intensity=1.0):
        self.volume = np.asarray(volume, np.float32)
        if self.volume.ndim != 5 or self.volume.shape[3:] != (6, 3):
            raise ValueError("volume must be (nx, ny, nz, 6, 3)")
        self.min_corner = np.asarray(min_corner, np.float32)
        self.max_corner = np.asarray(max_corner, np.float32)
        self.intensity = float(intensity)

    def build(self, app):
        dev = app.device
        vol = torch.from_numpy(self.volume).to(dev)
        lo = torch.from_numpy(self.min_corner).to(dev)
        span = torch.from_numpy(np.maximum(
            self.max_corner - self.min_corner, 1e-6)).to(dev)
        inten = self.intensity

        @system(name="irradiance_volume_pass")
        def irradiance_pass(target=ResMut(RenderTarget.RESOURCE),
                            cam=Query(Read(Camera3d),
                                      Read(GlobalTransform))):
            c, z = target.color, target.depth
            _, h, w = c.shape
            vp, *_, has_cam = camera_vp(cam, w, h)
            world = pixel_world(inverse(vp), z, w, h)
            target.color = irradiance_volume(c, target.gbuffer, z, has_cam,
                                             world, vol, lo, span, inten)

        app.add_systems(Render, irradiance_pass, in_set=SHADE_SET,
                        after="deferred_shade")
