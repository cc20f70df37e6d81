"""Screen-space reflections (port of bevy_tpu/render/ssr.py; ref:
bevy_pbr/src/ssr — a raymarch against the depth buffer in the deferred
path, blended by fresnel and roughness).

A fixed-step march: every pixel advances its reflected ray in lockstep
(the vectorised form of ssr.wesl's per-pixel loop), projects it and reads
the reverse-z depth each step; the first step whose ray falls behind the
buffer within `thickness` is the hit. Needs the deferred G-buffer; runs
after the shade, so the colour holds the lit scene it reflects.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.camera import Camera3d, pixel_world
from bevy_tpu_torch.render.environment import _f0
from bevy_tpu_torch.render.plugin import SHADE_SET, RenderTarget
from bevy_tpu_torch.render.post import camera_vp, inverse
from bevy_tpu_torch.transform import GlobalTransform


def project_step(vp, p, z):
    """Project world points (H, W, 3) by `vp` and read the depth buffer
    `z` (H, W) under them. Returns (ray reverse-z, buffer depth, in
    bounds, clip w)."""
    h, w = z.shape
    ph = torch.cat([p, torch.ones_like(p[..., :1])], -1)
    cl = torch.einsum("ij,hwj->hwi", vp, ph)
    cw = torch.where(torch.abs(cl[..., 3]) > 1e-8, cl[..., 3],
                     torch.ones_like(cl[..., 3]))
    sx = (cl[..., 0] / cw * 0.5 + 0.5) * w
    sy = (0.5 - cl[..., 1] / cw * 0.5) * h
    ray_z = cl[..., 2] / cw
    ix = torch.clamp(sx.to(torch.int32), 0, w - 1)
    iy = torch.clamp(sy.to(torch.int32), 0, h - 1)
    buf_z = z[iy.long(), ix.long()]
    inb = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    return ray_z, buf_z, inb, cl[..., 3], ix, iy


def ssr(c, g, z, has_cam, vp, world, eye, steps, stride, thickness,
        max_roughness, intensity, near):
    """The reflection march over world positions (H, W, 3) from the eye
    (3,), blended into the colour (4, H, W)."""
    n = g[4:7].permute(1, 2, 0)
    vdir = world - eye[None, None, :]
    vdir = vdir * torch.rsqrt(torch.clamp(
        torch.sum(vdir * vdir, -1, keepdim=True), min=1e-9))
    refl = vdir - 2.0 * torch.sum(vdir * n, -1, keepdim=True) * n
    rough = g[11]
    metallic = g[10]
    albedo = g[0:3].permute(1, 2, 0)
    eligible = (z > 0) & (rough < max_roughness) & has_cam
    hit_x = torch.zeros_like(z)
    hit_y = torch.zeros_like(z)
    hit = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for s in range(1, steps + 1):
        ray_z, buf_z, inb, cw, ix, iy = project_step(
            vp, world + refl * (stride * s), z)
        inb = inb & (cw > 0)
        # a hit: the buffer's surface is nearer than the ray point, but
        # within `thickness` of it in view depth
        dv_ray = near / torch.clamp(ray_z, min=1e-6)
        dv_buf = near / torch.clamp(buf_z, min=1e-6)
        crossed = (buf_z > ray_z) & (dv_ray - dv_buf < thickness) & \
            (buf_z > 0) & inb
        new = crossed & ~hit
        hit_x = torch.where(new, ix.to(torch.float32), hit_x)
        hit_y = torch.where(new, iy.to(torch.float32), hit_y)
        hit = hit | crossed
    hx = hit_x.to(torch.int32).long()
    hy = hit_y.to(torch.int32).long()
    refl_col = c[:3][:, hy, hx].permute(1, 2, 0)
    f0 = _f0(g, albedo, metallic)
    nov = torch.clamp(-torch.sum(vdir * n, -1), min=0.0)
    fres = f0 + (1.0 - f0) * ((1.0 - nov[..., None]) ** 5)
    wgt = torch.where((hit & eligible)[..., None],
                      fres * (1.0 - rough[..., None] / max_roughness) *
                      intensity, 0.0)
    out = c[:3].permute(1, 2, 0) * (1.0 - wgt) + refl_col * wgt
    return torch.cat([out.permute(2, 0, 1), c[3:4]], 0)


class SsrPlugin(Plugin):
    """ref: the ScreenSpaceReflections component — global here. `steps`
    is the march length; `max_roughness` gates which surfaces reflect."""

    def __init__(self, steps=24, stride=6.0, thickness=0.35,
                 max_roughness=0.4, intensity=1.0):
        self.steps = steps
        self.stride = stride
        self.thickness = thickness
        self.max_roughness = max_roughness
        self.intensity = intensity

    def build(self, app):
        steps, stride = self.steps, self.stride
        thickness, max_rough = self.thickness, self.max_roughness
        inten = self.intensity

        @system(name="ssr_pass")
        def ssr_pass(target=ResMut(RenderTarget.RESOURCE),
                     cam=Query(Read(Camera3d), Read(GlobalTransform))):
            z = target.depth
            h, w = z.shape
            vp, eye, _, near, has_cam = camera_vp(cam, w, h)
            world = pixel_world(inverse(vp), z, w, h)
            target.color = ssr(target.color, target.gbuffer, z, has_cam, vp,
                               world, eye, steps, stride, thickness,
                               max_rough, inten, near)

        app.add_systems(Render, ssr_pass, in_set=SHADE_SET,
                        after="deferred_shade")
