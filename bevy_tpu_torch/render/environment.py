"""Environment-map lighting (port of bevy_tpu/render/environment.py; ref:
bevy_pbr's light_probe/environment_map — `EnvironmentMapLight`:
prefiltered diffuse irradiance and roughness-blurred specular radiance
added as image-based ambient light).

The equirect environment is prefiltered on the host at build (a cosine
convolution for the irradiance, progressive blurs for the specular
roughness chain, numpy as in the JAX package) and uploaded once. One
image pass over the G-buffer (planes 0-3 albedo, 4-6 normal, 10 metallic,
11 roughness, 19-21 the specular tint where the G-buffer has 22 planes)
adds the IBL term after the deferred shade (SHADE_SET, after
"deferred_shade"); it needs Mesh3dPlugin(deferred=True).
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.camera import Camera3d, camera_row, pick_camera
from bevy_tpu_torch.render.plugin import SHADE_SET, RenderTarget
from bevy_tpu_torch.render.skybox import sample_equirect, view_rays
from bevy_tpu_torch.transform import GlobalTransform


def _dirs_equirect(h, w):
    """(h, w, 3) unit directions of the equirect texel centres (numpy)."""
    v = (np.arange(h) + 0.5) / h
    u = (np.arange(w) + 0.5) / w
    theta = np.pi * v                      # 0 (up) .. pi (down)
    phi = 2.0 * np.pi * (u - 0.5)
    st = np.sin(theta)[:, None]
    y = np.cos(theta)[:, None] * np.ones((1, w))
    x = st * np.sin(phi)[None, :]
    z = -st * np.cos(phi)[None, :]
    return np.stack([x, y, z], -1)


def prefilter_environment(env, irr_size=(16, 32), spec_levels=4):
    """Host prefilter (numpy): the cosine-convolved irradiance map and the
    specular chain (level 0 sharp, each next one halved and blurred)."""
    env = np.asarray(env, np.float32)[..., :3]
    sh, sw = 32, 64
    ys = (np.linspace(0, env.shape[0] - 1, sh)).astype(int)
    xs = (np.linspace(0, env.shape[1] - 1, sw)).astype(int)
    src = env[ys][:, xs]                              # (sh, sw, 3)
    sdirs = _dirs_equirect(sh, sw).reshape(-1, 3)
    sweight = np.repeat(np.sin(np.pi * (np.arange(sh) + 0.5) / sh), sw)
    srgb = src.reshape(-1, 3)
    ih, iw = irr_size
    idirs = _dirs_equirect(ih, iw).reshape(-1, 3)
    cos = np.clip(idirs @ sdirs.T, 0.0, None)         # (ihw, shw)
    wsum = cos * sweight[None, :]
    irr = (wsum @ srgb) / np.maximum(wsum.sum(1, keepdims=True), 1e-8)
    irradiance = irr.reshape(ih, iw, 3).astype(np.float32)
    spec = [env]
    cur = env
    for _ in range(spec_levels - 1):
        h2, w2 = max(cur.shape[0] // 2, 4), max(cur.shape[1] // 2, 8)
        ys = (np.linspace(0, cur.shape[0] - 1, h2)).astype(int)
        xs = (np.linspace(0, cur.shape[1] - 1, w2)).astype(int)
        ds = cur[ys][:, xs]
        k = np.asarray([0.25, 0.5, 0.25])
        ds = (np.roll(ds, 1, 0) * k[0] + ds * k[1] + np.roll(ds, -1, 0) * k[2])
        ds = (np.roll(ds, 1, 1) * k[0] + ds * k[1] + np.roll(ds, -1, 1) * k[2])
        spec.append(ds.astype(np.float32))
        cur = ds
    return irradiance, spec


def gradient_environment(horizon=(0.5, 0.6, 0.8), zenith=(0.2, 0.3, 0.6),
                         ground=(0.25, 0.2, 0.15), size=(32, 64)):
    """A procedural gradient equirect array (numpy (h, w, 3))."""
    h, w = size
    dirs = _dirs_equirect(h, w)
    up = dirs[..., 1]
    t = np.clip(up, 0.0, 1.0) ** 0.7
    sky = (np.asarray(horizon) * (1 - t[..., None]) +
           np.asarray(zenith) * t[..., None])
    out = np.where(up[..., None] >= 0, sky, np.asarray(ground))
    return out.astype(np.float32)


def _f0(g, albedo, metallic):
    """(H, W, 3) specular reflectance at normal incidence: the dielectric
    0.04, tinted by the specular tint planes where the G-buffer has them
    (ref: specular_tint modulates the dielectric F0), mixed to the albedo
    by metallic."""
    tint = g[19:22].permute(1, 2, 0) if g.shape[0] >= 22 else 1.0
    return 0.04 * tint * (1.0 - metallic[..., None]) + \
        albedo * metallic[..., None]


def environment_light(c, g, depth, has_cam, rays, irradiance, specs,
                      intensity):
    """The IBL term over the G-buffer `g`, added to the colour (4, H, W)
    at the covered pixels."""
    _, h, w = c.shape
    albedo = g[0:3].permute(1, 2, 0)
    n = g[4:7].permute(1, 2, 0)
    metallic = g[10]
    rough = torch.clamp(g[11], 0.0, 1.0)
    diffuse = sample_equirect(irradiance, g[4:7])            # (3, H, W)
    d = rays.permute(1, 2, 0)
    r = d - 2.0 * torch.sum(d * n, -1, keepdim=True) * n
    r3 = r.permute(2, 0, 1)
    nlev = len(specs)
    lev = rough * (nlev - 1)
    spec_acc = torch.zeros((3, h, w), device=c.device)
    for li in range(nlev):
        wgt = torch.clamp(1.0 - torch.abs(lev - li), 0.0, 1.0)
        spec_acc = spec_acc + sample_equirect(specs[li], r3) * wgt[None]
    f0 = _f0(g, albedo, metallic)
    ibl = (diffuse.permute(1, 2, 0) * albedo * (1.0 - metallic[..., None]) +
           spec_acc.permute(1, 2, 0) * f0) * intensity
    hit = (depth > 0) & has_cam
    rgb = torch.where(hit[None], c[:3] + ibl.permute(2, 0, 1), c[:3])
    return torch.cat([rgb, c[3:4]], 0)


class EnvironmentLightPlugin(Plugin):
    """ref: EnvironmentMapLight. Needs the deferred G-buffer."""

    def __init__(self, environment, intensity=1.0):
        self.irradiance, self.spec = prefilter_environment(environment)
        self.intensity = intensity

    gradient_environment = staticmethod(gradient_environment)

    def build(self, app):
        dev = app.device
        irr = torch.from_numpy(self.irradiance).to(dev)
        specs = [torch.from_numpy(s).to(dev) for s in self.spec]
        inten = self.intensity

        @system(name="environment_light_pass")
        def env_light_pass(target=ResMut(RenderTarget.RESOURCE),
                           cam=Query(Read(Camera3d), Read(GlobalTransform))):
            c = target.color
            _, h, w = c.shape
            ci, has_cam = pick_camera(cam.mask)
            rays = view_rays(camera_row(cam.global_transform.rotation, ci),
                             camera_row(cam.camera3d.fov, ci), w / h, h, w)
            target.color = environment_light(c, target.gbuffer, target.depth,
                                             has_cam, rays, irr, specs, inten)

        app.add_systems(Render, env_light_pass, in_set=SHADE_SET,
                        after="deferred_shade")
