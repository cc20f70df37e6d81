"""Fog (port of bevy_tpu/render/fog.py; ref: bevy_pbr's DistanceFog —
`src/fog.rs` — and the volumetric fog of `src/volumetric_fog/`: a
raymarched scattering pass that reads the directional shadow map, for
god rays).

Both are image passes in POST_SET before tonemapping. Distance fog blends
by view depth. Volumetric fog marches `steps` lockstep samples along each
pixel's ray, adding in-scattering gated by the cascaded shadow maps where
a ShadowPlugin made them (render/shadow.py shadow_factor); without one the
medium is uniformly lit.
"""

from __future__ import annotations

import math

import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.camera import Camera3d, camera_row, pick_camera
from bevy_tpu_torch.render.mesh3d import DirectionalLight
from bevy_tpu_torch.render.plugin import POST_SET, RenderTarget
from bevy_tpu_torch.render.shadow import shadow_factor
from bevy_tpu_torch.render.skybox import light_forward, view_rays
from bevy_tpu_torch.transform import GlobalTransform


def distance_fog(c, depth, color, density, near):
    """Exponential-squared fog by view distance over the colour (4, H, W);
    the background is left as it is. color: (3,) tensor."""
    dist = near / torch.clamp(depth, min=1e-7)
    t = torch.exp(-(density * dist) ** 2)
    t = torch.where(depth > 0, t, torch.ones_like(t))
    rgb = c[:3] * t[None] + color[:, None, None] * (1.0 - t)[None]
    return torch.cat([rgb, c[3:4]], 0)


class DistanceFogPlugin(Plugin):
    """ref: the DistanceFog component (exponential-squared falloff)."""

    def __init__(self, color=(0.6, 0.65, 0.75), density=0.02, near=0.1):
        self.color = color
        self.density = density
        self.near = near

    def build(self, app):
        color = torch.tensor(self.color, dtype=torch.float32,
                             device=app.device)
        density, near = self.density, self.near

        @system(name="distance_fog_pass")
        def distance_fog_pass(target=ResMut(RenderTarget.RESOURCE)):
            target.color = distance_fog(target.color, target.depth, color,
                                        density, near)

        app.add_systems(Render, distance_fog_pass, in_set=POST_SET,
                        before="tonemap_pass")


def volumetric_fog(c, depth, eye, rays, ldir, lcol, lit_at, density, steps,
                   max_distance, anisotropy, scatter_color, near):
    """Single scattering through a global medium: `steps` samples along
    each pixel's ray (3, H, W) up to its surface or `max_distance`,
    Henyey-Greenstein phase towards the light `ldir` of colour `lcol`,
    each sample lit by `lit_at(points (H, W, 3))` ((H, W) factors, or None
    for a uniformly lit medium). Returns the new rgb (3, H, W)."""
    g = anisotropy
    rdir = rays.permute(1, 2, 0)                       # (H, W, 3)
    cosang = -torch.sum(rdir * ldir[None, None, :], -1)
    phase = (1.0 - g * g) / torch.clamp(
        4.0 * math.pi * (1.0 + g * g - 2.0 * g * cosang) ** 1.5, min=1e-4)
    surf = torch.where(depth > 0, near / torch.clamp(depth, min=1e-7),
                       torch.full_like(depth, max_distance))
    dt = torch.clamp(surf, max=max_distance) / steps    # (H, W)
    trans = torch.ones_like(depth)
    scatter = torch.zeros_like(depth)
    step_od = density * dt
    for s in range(steps):
        d = dt * (s + 0.5)
        if lit_at is None:
            lit = torch.ones_like(depth)
        else:
            lit = lit_at(eye[None, None, :] + rdir * d[..., None])
        scatter = scatter + trans * lit * step_od * phase
        trans = trans * torch.exp(-step_od)
    fog_rgb = (scatter_color * lcol)[:, None, None] * scatter[None] * \
        4.0 * math.pi
    return c[:3] * trans[None] + fog_rgb


class VolumetricFogPlugin(Plugin):
    """ref: VolumetricFog + FogVolume — a global medium here; god rays
    come from sampling the directional shadow cascades along the ray."""

    def __init__(self, density=0.03, steps=16, max_distance=40.0,
                 scatter_color=(0.8, 0.85, 1.0), anisotropy=0.4,
                 near=0.1):
        self.density = density
        self.steps = steps
        self.max_distance = max_distance
        self.scatter_color = scatter_color
        self.anisotropy = anisotropy
        self.near = near

    def build(self, app):
        density, steps = self.density, self.steps
        max_d, g, near = self.max_distance, self.anisotropy, self.near
        scol = torch.tensor(self.scatter_color, dtype=torch.float32,
                            device=app.device)

        @system(name="volumetric_fog_pass")
        def volumetric_fog_pass(target=ResMut(RenderTarget.RESOURCE),
                                cam=Query(Read(Camera3d),
                                          Read(GlobalTransform)),
                                light=Query(Read(DirectionalLight),
                                            Read(GlobalTransform))):
            c = target.color
            z = target.depth
            h, w = z.shape
            ci, has_cam = pick_camera(cam.mask)
            gt = cam.global_transform
            rays = view_rays(camera_row(gt.rotation, ci),
                             camera_row(cam.camera3d.fov, ci), w / h, h, w)
            ldir, li, has_l = light_forward(light)
            dl = light.directional_light
            lcol = camera_row(dl.color, li) * camera_row(dl.illuminance, li)
            lit_at = None
            if hasattr(target, "shadow_depth"):
                sd, svp = target.shadow_depth, target.shadow_vp

                def lit_at(p):
                    return shadow_factor(p, sd, svp)
            rgb = volumetric_fog(c, z, camera_row(gt.translation, ci), rays,
                                 ldir, lcol, lit_at, density, steps, max_d,
                                 g, scol, near)
            rgb = torch.where(has_cam & has_l, rgb, c[:3])
            target.color = torch.cat([rgb, c[3:4]], 0)

        app.add_systems(Render, volumetric_fog_pass, in_set=POST_SET,
                        before="tonemap_pass")
