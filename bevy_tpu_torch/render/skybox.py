"""Skybox (port of bevy_tpu/render/skybox.py; ref: bevy_core_pipeline/src/
skybox — a cubemap drawn behind everything — plus the gradient / sun look
of bevy_pbr's atmosphere for the procedural mode).

One image pass over the background pixels (reverse-z depth 0: nothing
rasterised there). World-space view rays come from the camera's rotation
and fov; the sky is a procedural horizon / zenith gradient with a sun
disc from the first DirectionalLight, or an equirectangular environment
texture sampled by ray direction. Runs in POST_SET before tonemapping,
so the sky's radiance grades with the scene.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.quat import quat_rotate_vec3
from bevy_tpu_torch.render.camera import (
    Camera3d, camera_row, consts, pick_camera,
)
from bevy_tpu_torch.render.mesh3d import DirectionalLight
from bevy_tpu_torch.render.plugin import POST_SET, RenderTarget
from bevy_tpu_torch.transform import GlobalTransform


def view_rays(cam_rot, fov, aspect, h, w):
    """(3, H, W) unit world-space rays through each pixel centre."""
    dev = cam_rot.device
    f = 1.0 / torch.tan(fov * 0.5)
    xs = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w *
          2.0 - 1.0) * aspect / f
    ys = (1.0 - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) /
          h * 2.0) / f
    d = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w),
                     torch.full((h, w), -1.0, device=dev)], -1)
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True))
    return quat_rotate_vec3(cam_rot[None, None, :], d).permute(2, 0, 1)


def light_forward(light):
    """The first DirectionalLight's forward (-z turned by its rotation),
    and whether one exists."""
    li, has_l = pick_camera(light.mask)
    rot = camera_row(light.global_transform.rotation, li)
    return quat_rotate_vec3(rot, consts(rot.device)["-z"]), li, has_l


def procedural_sky(rays, sun_dir, horizon, zenith, ground, sun_color,
                   sun_size=0.02):
    """(3, H, W) radiance: a horizon-to-zenith gradient above, the ground
    colour below, an additive sun disc with a soft edge. The colours are
    (3,) tensors on the rays' device."""
    up = rays[1]
    t = torch.clamp(up, 0.0, 1.0) ** 0.7
    sky = horizon[:, None, None] * (1.0 - t) + zenith[:, None, None] * t
    below = ground[:, None, None] * torch.ones_like(sky)
    col = torch.where(up[None] >= 0.0, sky, below)
    cosang = -(rays[0] * sun_dir[0] + rays[1] * sun_dir[1] +
               rays[2] * sun_dir[2])
    disc = torch.clamp((cosang - (1.0 - sun_size)) / (sun_size * 0.3), 0.0,
                       1.0)
    return col + sun_color[:, None, None] * disc[None]


def sample_equirect(env, rays):
    """Sample an equirectangular (He, We, 3|4) map by ray direction (3, H,
    W), nearest texel (ref: the cubemap fetch of skybox.wesl, lat-long
    form)."""
    he, we = env.shape[0], env.shape[1]
    u = torch.atan2(rays[0], -rays[2]) / (2.0 * math.pi) + 0.5
    v = 0.5 - torch.asin(torch.clamp(rays[1], -1.0, 1.0)) / math.pi
    ix = torch.clamp((u * we).to(torch.int32), 0, we - 1).long()
    iy = torch.clamp((v * he).to(torch.int32), 0, he - 1).long()
    return env[iy, ix][..., :3].permute(2, 0, 1)


def over_background(c, depth, has_cam, sky):
    """The colour (4, H, W) with `sky` (3, H, W) at the background
    pixels."""
    bg = (depth <= 0.0) & has_cam
    return torch.cat([torch.where(bg[None], sky, c[:3]), c[3:4]], 0)


class SkyboxPlugin(Plugin):
    """Procedural sky (default) or an `environment=` equirect image array
    (ref: the Skybox component and EnvironmentMapLight's background
    role)."""

    def __init__(self, horizon=(0.35, 0.55, 0.85), zenith=(0.08, 0.18, 0.45),
                 ground=(0.18, 0.15, 0.13), sun_color=(2.5, 2.2, 1.8),
                 sun_size=0.02, environment=None, brightness=1.0):
        self.horizon = horizon
        self.zenith = zenith
        self.ground = ground
        self.sun_color = sun_color
        self.sun_size = sun_size
        self.environment = None if environment is None else \
            np.asarray(environment, np.float32)
        self.brightness = brightness

    def build(self, app):
        dev = app.device

        def vec(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        horizon, zenith, ground, sun_color = (
            vec(x) for x in (self.horizon, self.zenith, self.ground,
                             self.sun_color))
        sun_size, brightness = self.sun_size, self.brightness
        env = None if self.environment is None else \
            torch.from_numpy(self.environment).to(dev)

        @system(name="skybox_pass")
        def skybox_pass(target=ResMut(RenderTarget.RESOURCE),
                        cam=Query(Read(Camera3d), Read(GlobalTransform)),
                        light=Query(Read(DirectionalLight),
                                    Read(GlobalTransform))):
            c = target.color
            _, h, w = c.shape
            ci, has_cam = pick_camera(cam.mask)
            rays = view_rays(camera_row(cam.global_transform.rotation, ci),
                             camera_row(cam.camera3d.fov, ci), w / h, h, w)
            if env is not None:
                sky = sample_equirect(env, rays) * brightness
            else:
                sun_dir = light_forward(light)[0]
                sky = procedural_sky(rays, sun_dir, horizon, zenith, ground,
                                     sun_color, sun_size) * brightness
            target.color = over_background(c, target.depth, has_cam, sky)

        app.add_systems(Render, skybox_pass, in_set=POST_SET,
                        before="tonemap_pass")
