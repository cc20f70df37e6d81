"""Specular and diffuse transmission (port of bevy_tpu/render/
transmission.py; ref: the Transmissive3d phase of bevy_pbr —
`StandardMaterial::specular_transmission` and the screen-space
transmission texture the main pass copies and samples with a
roughness-dependent blur).

Transmissive instances leave the opaque and transparent phases (the mesh
plugin's `rows_x`, render/mesh3d.py) and raster here, through
`raster_batched(deferred=True)` (kernels B1 and B2), into a temporary
14-plane G-buffer whose depth starts as the opaque depth, so the opaque
scene occludes them. A full-screen pass in plain PyTorch then refracts:
the screen-space tangential part of the surface normal offsets the
background sample (scaled by ior - 1, the thin-surface approximation of
bevy's screen-space path), roughness widens a ring of taps, Beer-Lambert
attenuation (attenuation_color ^ (thickness / attenuation_distance))
tints the transmitted light, fresnel splits transmitted from reflected
energy and a GGX highlight of the directional light sits on top; diffuse
transmission lerps the diffuse lobe toward back-lit Lambert. The
per-pixel transmission weight and ior ride the temporary G-buffer's
clearcoat planes, diffuse transmission its alpha plane, the attenuation
colour its emissive planes and the Beer-Lambert exponent its metallic
plane.

As the JAX package's, the pass reads the first camera only (it does not
split by viewport). Span transmission:pass.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.affine import TRS, trs_to_mat4
from bevy_tpu_torch.math.quat import quat_rotate_vec3
from bevy_tpu_torch.render.camera import (
    Camera3d, camera_row, consts, perspective_infinite_reverse, pick_camera,
    view_matrix,
)
from bevy_tpu_torch.render.mesh3d import (
    ROUTE_OF_BACKEND, AmbientLight, DirectionalLight, Mesh3d, MeshMaterial,
    raster_batched,
)
from bevy_tpu_torch.render.plugin import (
    SHADE_SET, RenderPlugin, RenderTarget, add_render_stats,
)
from bevy_tpu_torch.render.spot_shadow import ggx_light


class TransmissionPlugin(Plugin):
    """Screen-space transmission for materials with specular_transmission
    or diffuse_transmission > 0, after the mesh pass of `mesh_plugin` (a
    group-route Mesh3dPlugin, forward or deferred). strength: the pixel
    offset a unit of (ior - 1). backend: the JAX signature's; the kernels
    follow the tensors' device."""

    def __init__(self, mesh_plugin, strength=60.0, backend="auto"):
        if backend not in ROUTE_OF_BACKEND:
            raise ValueError(f"TransmissionPlugin: unknown backend "
                             f"{backend!r}")
        self.mesh_plugin = mesh_plugin
        self.strength = strength

    def build(self, app):
        rp = next(p for p in app._plugins if isinstance(p, RenderPlugin))
        add_render_stats(app, "pair_overflow", "tile_overflow",
                         "fallback_clusters")
        app.add_systems(Render, make_transmission_pass(
            self.mesh_plugin, rp.width, rp.height, self.strength),
            in_set=SHADE_SET, after="mesh_pass")


def make_transmission_pass(mesh_plugin, width, height, strength):
    from bevy_tpu_torch.transform import GlobalTransform

    @system(name="transmission_pass")
    def transmission_pass(q=Query(Read(Mesh3d), Read(MeshMaterial),
                                  Read(GlobalTransform)),
                          cam=Query(Read(Camera3d), Read(GlobalTransform)),
                          light=Query(Read(DirectionalLight),
                                      Read(GlobalTransform)),
                          amb=Res(AmbientLight),
                          target=ResMut(RenderTarget.RESOURCE),
                          stats=ResMut("render_stats")):
        groups = [g for g in mesh_plugin._groups or () if g["n_x"]]
        if not groups:
            return
        with span("transmission:pass"):
            _transmit(q, cam, light, amb, target, stats, groups, width,
                      height, strength)

    return transmission_pass


def _transmit(q, cam, light, amb, target, stats, groups, width, height,
              strength):
    c = target.color
    dev = c.device
    ci, has_cam = pick_camera(cam.mask)
    cgt = cam.global_transform
    crot = camera_row(cgt.rotation, ci)
    view = view_matrix(camera_row(cgt.translation, ci), crot,
                       camera_row(cgt.scale, ci))
    vp = perspective_infinite_reverse(
        camera_row(cam.camera3d.fov, ci), width / height,
        camera_row(cam.camera3d.near, ci)) @ view
    # the transmissive groups into a temporary G-buffer, depth seeded with
    # the opaque depth (ref: Transmissive3d draws depth-tested after the
    # transmission texture's copy)
    t = SimpleNamespace(gbuffer=torch.zeros((14, height, width), device=dev),
                        depth=target.depth)
    mm = q.mesh_material
    gt = q.global_transform
    for grp in groups:
        rows = grp["rows_x"]
        gt_r = gt.rotation[rows]
        mats = trs_to_mat4(TRS(translation=gt.translation[rows],
                               rotation=gt_r, scale=gt.scale[rows]))
        mvp = torch.einsum("ij,njk->nik", vp, mats)
        clip = torch.einsum("nij,vj->nvi", mvp, grp["ph"])
        nrm = quat_rotate_vec3(gt_r[:, None, :], grp["normals"][None])
        att_d = mm.attenuation_distance[rows]
        att_exp = torch.where(att_d > 0.0, mm.thickness[rows] /
                              torch.clamp(att_d, min=1e-6), 0.0)
        ones = torch.ones_like(att_d)
        # [rgb, diffuse transmission, attenuation colour, Beer-Lambert
        # exponent, roughness, transmission, ior, no anisotropy or
        # parallax, reflectance 0.5]
        mat = torch.stack(
            [mm.base_color[rows][:, 0], mm.base_color[rows][:, 1],
             mm.base_color[rows][:, 2], mm.diffuse_transmission[rows],
             mm.attenuation_color[rows][:, 0],
             mm.attenuation_color[rows][:, 1],
             mm.attenuation_color[rows][:, 2], att_exp,
             mm.perceptual_roughness[rows],
             mm.specular_transmission[rows], mm.ior[rows], 0.0 * ones,
             0.0 * ones, 0.0 * ones, 0.5 * ones], 1)
        # the shade records, as the JAX package's call (no coplanar quads)
        raster_batched(clip, nrm, dict(grp, quads=None),
                       q.mask[rows] & has_cam, mat,
                       torch.zeros(16, device=dev), t, stats, width=width,
                       height=height, deferred=True)
    g = t.gbuffer
    covered = t.depth > target.depth
    n = g[4:7].permute(1, 2, 0)
    tint = g[0:3].permute(1, 2, 0)
    rough = g[11]
    stw = torch.clamp(g[12], 0.0, 1.0)
    ior = torch.clamp(g[13], min=1.0)
    # screen-space refraction offset from the tangential normal
    ax = consts(dev)
    rightv = quat_rotate_vec3(crot, ax["x"])
    upv = quat_rotate_vec3(crot, ax["y"])
    nsx = torch.einsum("hwj,j->hw", n, rightv)
    nsy = torch.einsum("hwj,j->hw", n, upv)
    off = strength * (ior - 1.0)
    yy = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(width, dtype=torch.float32, device=dev)[None, :]

    def bg_at(scale):
        sx = torch.clamp(torch.round(xx - nsx * off * scale).to(torch.int32),
                         0, width - 1).long()
        sy = torch.clamp(torch.round(yy + nsy * off * scale).to(torch.int32),
                         0, height - 1).long()
        return c[:3, sy, sx].permute(1, 2, 0)

    # roughness ring blur: the centre and 4 spread taps
    spread = 1.0 + rough * 3.0
    bg = bg_at(1.0)
    for s in (0.85, 0.95, 1.05, 1.15):
        bg = bg + bg_at(((s - 1.0) * spread + 1.0))
    bg = bg / 5.0
    # Beer-Lambert volume attenuation (ref: attenuation_color ^ (thickness
    # / attenuation_distance))
    t_att = torch.exp(g[10][..., None] * torch.log(
        torch.clamp(g[7:10].permute(1, 2, 0), 1e-4, 1.0)))
    transmitted = tint * bg * t_att
    # fresnel split and the lit surface for the reflected part; the view
    # direction approximated by the camera's forward
    fwd = quat_rotate_vec3(crot, -ax["-z"])
    vdirs = fwd.expand(n.shape)
    nov = torch.clamp(torch.sum(n * vdirs, -1), 0.0, 1.0)
    fres = 0.04 + 0.96 * (1.0 - nov) ** 5
    li, has_light = pick_camera(light.mask)
    ldir = -quat_rotate_vec3(camera_row(light.global_transform.rotation, li),
                             ax["-z"])
    lcol = (camera_row(light.directional_light.color, li) *
            camera_row(light.directional_light.illuminance, li) *
            has_light)[None, None, :]
    spec = ggx_light(torch.zeros_like(tint), n, torch.zeros_like(rough),
                     rough, vdirs, ldir.expand(n.shape), lcol)
    lam = torch.clamp(torch.sum(n * ldir[None, None, :], -1), min=0.0)
    # diffuse transmission (ref: StandardMaterial::diffuse_transmission):
    # light from behind the surface, flipped-normal Lambert
    dtw = torch.clamp(g[3], 0.0, 1.0)
    lam_back = torch.clamp(-torch.sum(n * ldir[None, None, :], -1), min=0.0)
    lam_mix = lam * (1.0 - dtw) + lam_back * dtw
    surface = tint * (amb.color * amb.brightness + lcol * lam_mix[..., None])
    mixw = (stw * (1.0 - fres))[..., None]
    out = surface * (1.0 - mixw) + transmitted * mixw + spec
    rgb = torch.where(covered[None], out.permute(2, 0, 1), c[:3])
    target.color = torch.cat([rgb, c[3:4]], 0)
    target.depth = torch.where(covered, t.depth, target.depth)
