"""Contact shadows (port of bevy_tpu/render/contact_shadows.py; ref:
bevy_pbr's screen-space contact shadows — a short depth-buffer raymarch
towards the light that catches the small-scale occlusion shadow maps
miss).

`steps` lockstep steps along the first DirectionalLight per pixel; where
a step's projection is occluded by the buffer within `thickness`, the
pixel darkens by `strength`. It runs after the deferred shade and
darkens the whole lit colour (an approximation the JAX package makes
too: the direct light is not split out).
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.camera import Camera3d, pixel_world
from bevy_tpu_torch.render.mesh3d import DirectionalLight
from bevy_tpu_torch.render.plugin import SHADE_SET, RenderTarget
from bevy_tpu_torch.render.post import camera_vp, inverse
from bevy_tpu_torch.render.skybox import light_forward
from bevy_tpu_torch.render.ssr import project_step
from bevy_tpu_torch.transform import GlobalTransform


def contact_shadows(c, z, ok, vp, world, to_light, steps, length,
                    thickness, strength, near):
    """March from world positions (H, W, 3) towards the light; the colour
    (4, H, W) darkens at the occluded pixels where `ok` (a 0-d bool)."""
    occluded = torch.zeros(z.shape, dtype=torch.bool, device=z.device)
    for s in range(1, steps + 1):
        ray_z, buf_z, inb, _, _, _ = project_step(
            vp, world + to_light[None, None, :] * (length * s / steps), z)
        dv_ray = near / torch.clamp(ray_z, min=1e-6)
        dv_buf = near / torch.clamp(buf_z, min=1e-6)
        occluded = occluded | ((buf_z > ray_z) &
                               (dv_ray - dv_buf < thickness) &
                               (buf_z > 0) & inb)
    factor = torch.where(occluded & (z > 0) & ok, 1.0 - strength, 1.0)
    return torch.cat([c[:3] * factor[None], c[3:4]], 0)


class ContactShadowsPlugin(Plugin):
    """ref: the ContactShadows component — global here, for the first
    DirectionalLight. `near` is the view depth of the reverse-z mapping
    the thickness test reads."""

    def __init__(self, steps=8, length=0.6, thickness=0.15, strength=0.7,
                 near=0.1):
        self.steps = steps
        self.length = length
        self.thickness = thickness
        self.strength = strength
        self.near = near

    def build(self, app):
        steps, length = self.steps, self.length
        thickness, strength, near = self.thickness, self.strength, self.near

        @system(name="contact_shadows_pass")
        def contact_shadows_pass(target=ResMut(RenderTarget.RESOURCE),
                                 cam=Query(Read(Camera3d),
                                           Read(GlobalTransform)),
                                 light=Query(Read(DirectionalLight),
                                             Read(GlobalTransform))):
            z = target.depth
            h, w = z.shape
            vp, *_, has_cam = camera_vp(cam, w, h)
            world = pixel_world(inverse(vp), z, w, h)
            ldir, _, has_l = light_forward(light)
            target.color = contact_shadows(
                target.color, z, has_cam & has_l, vp, world, -ldir, steps,
                length, thickness, strength, near)

        app.add_systems(Render, contact_shadows_pass, in_set=SHADE_SET,
                        after="deferred_shade")
