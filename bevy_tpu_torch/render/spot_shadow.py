"""Spot-light shadow map (port of bevy_tpu/render/spot_shadow.py; ref: the
spot-shadow half of bevy_pbr/src/render/light.rs — one perspective depth
view a shadow-casting spot, sampled while shading).

The first SpotLight with `shadows=1` renders a perspective depth-only
pass from its pose (fov = twice the outer angle; the mesh pass's
group-route raster in its depth-only mode: kernels B1 and B2). The binned
shade (B3) leaves it out (render/deferred.py masks it) and this plugin
adds its Cook-Torrance GGX term with the shadow factor in plain PyTorch,
after the deferred shade: the same arithmetic as B3's light body, so a
shadowed and an unshadowed spot match. Needs the deferred G-buffer.

Profiler spans: shadow:spot (the depth pass, mesh:* inside it) and
shadow:spot_shade.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.quat import quat_rotate_vec3
from bevy_tpu_torch.render.camera import (
    Camera3d, consts, perspective_infinite_reverse, pick_camera,
    pixel_world, view_matrix,
)
from bevy_tpu_torch.render.deferred import SpotLight
from bevy_tpu_torch.render.mesh3d import Mesh3d, MeshMaterial
from bevy_tpu_torch.render.plugin import (
    CLEAR_SET, PASS_SET, SHADE_SET, RenderPlugin, RenderTarget,
)
from bevy_tpu_torch.render.shadow import depth_pass


def _pick_shadow_spot(slight):
    """Row index and existence of the first shadow-casting spot."""
    sel = slight.mask & (slight.spot_light.shadows > 0)
    return torch.argmax(sel.to(torch.uint8)), torch.any(sel)


@system(name="clear_spot_shadow")
def clear_spot_shadow(target=ResMut(RenderTarget.RESOURCE)):
    target.spot_shadow_depth = torch.zeros_like(target.spot_shadow_depth)


def ggx_light(albedo, n, metallic, rough, view_dir, ldir, lcol, cc=None,
              ccr=None):
    """Cook-Torrance GGX as B3's light body (ops/shade.py shade_light).
    (..., 3) / (...,) planes; ldir points toward the light. Optional
    clearcoat weight / roughness planes add the second lobe (Kelemen
    visibility) with the base layer's Fresnel attenuation."""
    rough = torch.clamp(rough, 0.045, 1.0)
    alpha = rough * rough
    a2 = alpha * alpha
    nov = torch.clamp(torch.sum(n * view_dir, -1), min=1e-4)
    nol = torch.clamp(torch.sum(n * ldir, -1), min=0.0)
    h = ldir + view_dir
    h = h * torch.rsqrt(torch.clamp(torch.sum(h * h, -1, keepdim=True),
                                    min=1e-9))
    noh = torch.clamp(torch.sum(n * h, -1), min=0.0)
    loh = torch.clamp(torch.sum(ldir * h, -1), min=0.0)
    den = noh * noh * (a2 - 1.0) + 1.0
    dist = a2 / torch.clamp(math.pi * den * den, min=1e-9)
    vis = 0.5 / torch.clamp(nol * (nov * (1.0 - alpha) + alpha) +
                            nov * (nol * (1.0 - alpha) + alpha), min=1e-4)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    x = 1.0 - loh[..., None]
    x2 = x * x
    fres = x2 * x2 * x
    spec = (dist * vis)[..., None] * (f0 + (1.0 - f0) * fres)
    base = albedo * (1.0 - metallic[..., None]) + spec
    if cc is not None:
        ccr_c = torch.clamp(ccr, 0.045, 1.0)
        cc_a2 = (ccr_c * ccr_c) ** 2
        ccden = noh * noh * (cc_a2 - 1.0) + 1.0
        ccdist = cc_a2 / torch.clamp(math.pi * ccden * ccden, min=1e-9)
        ccvis = 0.25 / torch.clamp(loh * loh, min=1e-4)
        fc = ((0.04 + 0.96 * fres[..., 0]) * cc)[..., None]
        base = base * (1.0 - fc) + (ccdist * ccvis)[..., None] * fc
    return base * lcol * nol[..., None]


def camera_world(cam, target, width, height):
    """The first camera's index, existence, global transform and the
    world positions (H, W, 3) of target.depth's pixels."""
    ci, has_cam = pick_camera(cam.mask)
    cam_gt = cam.global_transform
    view = view_matrix(cam_gt.translation[ci], cam_gt.rotation[ci],
                       cam_gt.scale[ci])
    proj = perspective_infinite_reverse(cam.camera3d.fov[ci], width / height,
                                        cam.camera3d.near[ci])
    inv_vp = torch.linalg.inv_ex(proj @ view).inverse    # no host sync
    return ci, has_cam, cam_gt, pixel_world(inv_vp, target.depth, width,
                                            height)


def add_light_term(target, cam_gt, ci, world, ldir, lcol, geom):
    """target.color's rgb plus the GGX term of one light (ldir (H, W, 3)
    toward it, lcol (H, W, 3) its attenuated colour) over the G-buffer,
    where `geom` (H, W)."""
    c, g = target.color, target.gbuffer
    albedo = g[0:3].permute(1, 2, 0)
    n = g[4:7].permute(1, 2, 0)
    vdir = cam_gt.translation[ci][None, None, :] - world
    vdir = vdir * torch.rsqrt(torch.clamp(
        torch.sum(vdir * vdir, -1, keepdim=True), min=1e-9))
    add = ggx_light(albedo, n, g[10], g[11], vdir, ldir, lcol, cc=g[12],
                    ccr=g[13])
    rgb = torch.where(geom[None], c[:3] + add.permute(2, 0, 1), c[:3])
    return torch.cat([rgb, c[3:4]], 0)


class SpotShadowPlugin(Plugin):
    """Shadow map and shaded term of the first SpotLight with shadows=1
    (the map: `spot_shadow_depth` (size, size) and `spot_shadow_vp` (4,4)
    in the RenderTarget store, cleared every frame). Needs
    Mesh3dPlugin(deferred=True) + DeferredLightingPlugin."""

    def __init__(self, mesh_plugin, size=512, near=0.1, bias=2e-3):
        self.mesh_plugin = mesh_plugin
        self.size = size
        self.near = near
        self.bias = bias

    def build(self, app):
        from bevy_tpu_torch.transform import GlobalTransform

        rp = next(p for p in app._plugins if isinstance(p, RenderPlugin))
        width, height = rp.width, rp.height
        size, bias = self.size, self.bias
        mesh_plugin = self.mesh_plugin
        dev = app.device
        near = torch.tensor(self.near, device=dev)
        store = app.world.state["res"][RenderTarget.RESOURCE]
        store["spot_shadow_depth"] = torch.zeros((size, size), device=dev)
        store["spot_shadow_vp"] = torch.eye(4, device=dev)

        @system(name="spot_shadow_pass")
        def spot_shadow_pass(q=Query(Read(Mesh3d), Read(MeshMaterial),
                                     Read(GlobalTransform)),
                             slight=Query(Read(SpotLight),
                                          Read(GlobalTransform)),
                             target=ResMut(RenderTarget.RESOURCE),
                             stats=ResMut("render_stats")):
            with span("shadow:spot"):
                li, has = _pick_shadow_spot(slight)
                lgt = slight.global_transform
                lview = view_matrix(lgt.translation[li], lgt.rotation[li],
                                    consts(dev)["ones"])
                fov = torch.clamp(slight.spot_light.outer_angle[li] * 2.0,
                                  min=0.1)
                lvp = perspective_infinite_reverse(fov, 1.0, near) @ lview
                target.spot_shadow_depth = depth_pass(
                    mesh_plugin, q, lvp, has, target.spot_shadow_depth,
                    stats, size=size)
                target.spot_shadow_vp = lvp

        @system(name="spot_shadow_shade")
        def spot_shadow_shade(cam=Query(Read(Camera3d),
                                        Read(GlobalTransform)),
                              slight=Query(Read(SpotLight),
                                           Read(GlobalTransform)),
                              target=ResMut(RenderTarget.RESOURCE)):
            with span("shadow:spot_shade"):
                li, has = _pick_shadow_spot(slight)
                ci, has_cam, cam_gt, world = camera_world(cam, target, width,
                                                          height)
                z = target.depth
                lgt = slight.global_transform
                sl = slight.spot_light
                ldirv = lgt.translation[li][None, None, :] - world
                d2 = torch.sum(ldirv * ldirv, -1)
                inv_d = torch.rsqrt(torch.clamp(d2, min=1e-9))
                ldir = ldirv * inv_d[..., None]
                rng = sl.range[li]
                win = torch.clamp(
                    1.0 - (d2 / torch.clamp(rng * rng, min=1e-9)) ** 2,
                    0.0, 1.0)
                atten = win * win / (d2 + 1.0)
                axis = quat_rotate_vec3(lgt.rotation[li], consts(dev)["-z"])
                cos_to = -torch.sum(ldir * axis[None, None, :], -1)
                cos_o = torch.cos(sl.outer_angle[li])
                inv_co = 1.0 / torch.clamp(torch.cos(sl.inner_angle[li])
                                           - cos_o, min=1e-4)
                cone = torch.clamp((cos_to - cos_o) * inv_co, 0.0, 1.0)
                atten = atten * cone * cone
                # the perspective shadow lookup (reverse-z, as the pass)
                ph = torch.cat([world, torch.ones_like(z)[..., None]], -1)
                lc = torch.einsum("ij,hwj->hwi", target.spot_shadow_vp, ph)
                lw = torch.where(torch.abs(lc[..., 3]) > 1e-8, lc[..., 3],
                                 torch.ones_like(z))
                sx, sy, lz = lc[..., 0] / lw, lc[..., 1] / lw, \
                    lc[..., 2] / lw
                # truncation toward zero before the clamp (the JAX int32
                # cast), not floor
                ix = torch.clamp(((sx * 0.5 + 0.5) * size).to(torch.int32),
                                 0, size - 1).long()
                iy = torch.clamp(((0.5 - sy * 0.5) * size).to(torch.int32),
                                 0, size - 1).long()
                inside = (torch.abs(sx) < 1.0) & (torch.abs(sy) < 1.0) & \
                    (lc[..., 3] > 0)
                occ = target.spot_shadow_depth[iy, ix]
                lit = ((occ <= lz + bias) | ~inside).to(torch.float32)
                lcol = (sl.color[li] * sl.intensity[li])[None, None, :] * \
                    (atten * lit)[..., None]
                target.color = add_light_term(target, cam_gt, ci, world,
                                              ldir, lcol,
                                              (z > 0) & has & has_cam)

        app.add_systems(Render, clear_spot_shadow, in_set=CLEAR_SET)
        app.add_systems(Render, spot_shadow_pass, in_set=PASS_SET,
                        before="mesh_pass")
        app.add_systems(Render, spot_shadow_shade, in_set=SHADE_SET,
                        after="deferred_shade")
