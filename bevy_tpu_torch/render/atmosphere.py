"""Physically based atmosphere (port of bevy_tpu/render/atmosphere.py;
ref: bevy_pbr's `src/atmosphere/`: Rayleigh + Mie single scattering
driving the sky).

A fixed-sample single-scattering integral over each background pixel's
ray (the reference precomputes LUTs; at one ray a pixel and 8 samples the
direct integral is cheap). The sun is the first DirectionalLight; the
pass writes the background (depth 0) before tonemapping.
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
from bevy_tpu_torch.render.skybox import (
    light_forward, over_background, view_rays,
)
from bevy_tpu_torch.transform import GlobalTransform

# per-metre scattering coefficients (standard earth values)
RAYLEIGH = (5.802e-6, 13.558e-6, 33.1e-6)
MIE = 3.996e-6
PLANET_R = 6_360e3
ATMO_R = 6_460e3
H_RAYLEIGH = 8_000.0
H_MIE = 1_200.0


def _ray_sphere_exit(o_y, d_y, radius):
    """Distance to the atmosphere shell along (0, o_y, 0) + t d for an
    origin offset only vertically (a flat-horizon approximation)."""
    b = o_y * d_y
    c = o_y * o_y - radius * radius
    disc = torch.clamp(b * b - c, min=0.0)
    return torch.clamp(-b + torch.sqrt(disc), min=0.0)


def sky_radiance(rays, sun_dir, sun_intensity=20.0, samples=8,
                 altitude=500.0):
    """(3, H, W) single-scattered radiance (ref: the sky-view LUT math of
    atmosphere/functions.wesl, as a direct integral)."""
    d = rays.permute(1, 2, 0)                          # (H, W, 3)
    ray_b = torch.tensor(RAYLEIGH, dtype=torch.float32, device=d.device)
    o_y = PLANET_R + altitude
    # downward rays clamp to the horizon glow
    dy = torch.clamp(d[..., 1], min=0.015)
    dist = _ray_sphere_exit(o_y, dy, ATMO_R)
    mu = -torch.sum(d * sun_dir[None, None, :], -1)    # cos(view, sun)
    ph_r = 3.0 / (16.0 * math.pi) * (1.0 + mu * mu)
    g = 0.8
    ph_m = 3.0 / (8.0 * math.pi) * ((1.0 - g * g) * (1.0 + mu * mu)) / \
        ((2.0 + g * g) * torch.clamp(
            (1.0 + g * g - 2.0 * g * mu) ** 1.5, min=1e-4))
    sun_up = torch.clamp(-sun_dir[1], min=0.0)
    # the sun path's optical depth, flat-atmosphere Chapman form:
    # beta * H * density(h) / cos(zenith)
    inv_cos_sun = 1.0 / torch.clamp(sun_up, min=0.02)
    hw = d.shape[:2]
    acc_r = torch.zeros(hw + (3,), device=d.device)
    acc_m = torch.zeros(hw, device=d.device)
    od_r = torch.zeros(hw + (3,), device=d.device)
    od_m = torch.zeros(hw, device=d.device)
    dt = dist / samples
    for s in range(samples):
        t = dt * (s + 0.5)
        h = torch.sqrt(o_y * o_y + t * t + 2.0 * o_y * t * dy) - PLANET_R
        dens_r = torch.exp(-torch.clamp(h, min=0.0) / H_RAYLEIGH)
        dens_m = torch.exp(-torch.clamp(h, min=0.0) / H_MIE)
        od_r = od_r + ray_b[None, None] * (dens_r * dt)[..., None]
        od_m = od_m + MIE * dens_m * dt
        sun_od = (ray_b[None, None] * H_RAYLEIGH *
                  (dens_r * inv_cos_sun)[..., None] +
                  (MIE * H_MIE * dens_m * inv_cos_sun)[..., None])
        trans = torch.exp(-(od_r + od_m[..., None] + sun_od))
        acc_r = acc_r + trans * (dens_r * dt)[..., None]
        acc_m = acc_m + torch.mean(trans, -1) * dens_m * dt
    rgb = sun_intensity * (acc_r * ray_b[None, None] * ph_r[..., None] +
                           (acc_m * MIE * ph_m)[..., None])
    # the sun disc through the final transmittance
    disc = torch.clamp((mu - 0.9995) / 0.0002, 0.0, 1.0)
    rgb = rgb + (sun_intensity * disc)[..., None] * \
        torch.exp(-(od_r + od_m[..., None]))
    return rgb.permute(2, 0, 1)


class AtmospherePlugin(Plugin):
    """ref: the Atmosphere component — global here; pairs with
    TonemappingPlugin (the radiance is HDR)."""

    def __init__(self, sun_intensity=20.0, samples=8, altitude=500.0):
        self.sun_intensity = sun_intensity
        self.samples = samples
        self.altitude = altitude

    def build(self, app):
        inten, samples, alt = self.sun_intensity, self.samples, self.altitude

        @system(name="atmosphere_pass")
        def atmosphere_pass(target=ResMut(RenderTarget.RESOURCE),
                            cam=Query(Read(Camera3d), Read(GlobalTransform)),
                            light=Query(Read(DirectionalLight),
                                        Read(GlobalTransform))):
            c = target.color
            _, h, w = c.shape
            ci, has_cam = pick_camera(cam.mask)
            rays = view_rays(camera_row(cam.global_transform.rotation, ci),
                             camera_row(cam.camera3d.fov, ci), w / h, h, w)
            sky = sky_radiance(rays, light_forward(light)[0], inten,
                               samples, alt)
            target.color = over_background(c, target.depth, has_cam, sky)

        app.add_systems(Render, atmosphere_pass, in_set=POST_SET,
                        before="tonemap_pass")
