"""Deferred lighting plugin (port of bevy_tpu/render/deferred.py; ref:
bevy's deferred path `bevy_core_pipeline/src/deferred/` + the clustered
light binning of `bevy_light/src/cluster/assign.rs` + PointLight
`bevy_light/src/point_light.rs`).

Geometry passes built with `Mesh3dPlugin(deferred=True)` write the
G-buffer (albedo, normal, emissive, material planes) and reverse-z depth;
this plugin bins the lights into the raster's screen tiles (ops/shade.py
`bin_lights`) and resolves lighting in one kernel (B3, ops/shade.py
`deferred_shade`).

The kernel variant (spot cones, rect lights, clearcoat, reflectance,
anisotropy, specular tint), the light record width (8, 16 or 24 fields)
and the G-buffer's plane count (19, or 22 with the tint planes 19:22 when
a live material tints) are chosen by a prepare hook from the host's view
of the world (structural change only), so a frame reads nothing back
from the device.

With a ShadowPlugin (render/shadow.py) the shade reconstructs each
pixel's world position, turns the cascade maps into a lit factor
(`shadow_factor`, span shadow:factor) and hands it to B3 as its shadow
plane. Shadow-casting point and spot lights (`shadows=1`) leave the
binned shade: render/point_shadow.py and render/spot_shadow.py shade the
first of each.

With `shards` the shade runs in row bands over a ShardMesh
(parallel/raster.py `sharded_deferred_shade`), the lights binned over the
grid padded to whole bands, the shadow plane cut into the same bands.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import component, field, get_spec
from bevy_tpu_torch.ecs.query import Query, Read, Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.quat import quat_rotate_vec3
from bevy_tpu_torch.ops.shade import bin_lights, deferred_shade
from bevy_tpu_torch.parallel import as_mesh
from bevy_tpu_torch.parallel import raster as par_raster
from bevy_tpu_torch.render.camera import (
    Camera3d, consts, perspective_infinite_reverse, pick_camera,
    pixel_world, view_matrix,
)
from bevy_tpu_torch.render.mesh3d import (
    AmbientLight, DirectionalLight, MeshMaterial,
)
from bevy_tpu_torch.render.plugin import (
    CLEAR_SET, SHADE_SET, ClearColor, RenderPlugin, RenderTarget,
    add_render_stats,
)
from bevy_tpu_torch.render.shadow import shadow_factor


@component
class PointLight:
    """ref: PointLight — color, intensity (normalized), range cutoff."""
    color = field(3, default=(1.0, 1.0, 1.0))
    intensity = field((), default=1.0)
    range = field((), default=20.0)
    shadows = field((), torch.int32)  # 1 = shadow-casting (PointShadowPlugin)


@component
class SpotLight:
    """ref: SpotLight — cone along the entity's -Z axis; angles are
    half-angles in radians (inner fully lit, smooth falloff to outer)."""
    color = field(3, default=(1.0, 1.0, 1.0))
    intensity = field((), default=1.0)
    range = field((), default=20.0)
    inner_angle = field((), default=0.3)
    outer_angle = field((), default=0.5)
    shadows = field((), torch.int32)  # 1 = shadow-casting (SpotShadowPlugin)


@component
class RectLight:
    """Rectangular area light emitting from one face of a w×h rect in the
    entity's XY plane along -Z (ref: bevy_light/src/rect_light.rs), shaded
    with the representative-point approximation, one-sided."""
    color = field(3, default=(1.0, 1.0, 1.0))
    intensity = field((), default=1.0)
    range = field((), default=20.0)
    width = field((), default=1.0)
    height = field((), default=1.0)


@system(name="clear_gbuffer")
def clear_gbuffer(target=ResMut(RenderTarget.RESOURCE)):
    target.gbuffer = torch.zeros_like(target.gbuffer)


def specular_tinted(tint):
    """Whether any of the (n, 3) live specular_tint rows is not white: the
    worlds whose G-buffer grows to 22 planes (the mesh pass writes the
    tint into planes 19:22) and whose shade takes B3's tinted variant.
    The JAX package reads every pool row and counts an all-zero tint as
    unset; live rows need no such rule, so a black tint tints here."""
    return bool(np.any(np.abs(tint - 1.0).max(-1) > 1e-6))


def _material_flags(world):
    """Kernel variant flags from the live MeshMaterial rows (host read,
    prepare time). Unlike the JAX twin, rows without a material do not
    count: its `reflectance` test sees their 0 and turns the variant on in
    every world with spare capacity (the image is the same: 0.16*0.5*0.5
    rounds to exactly 0.04f); nor for the tint (specular_tinted)."""
    flags = dict(spot=world.component_rows(SpotLight) > 0,
                 rect=world.component_rows(RectLight) > 0,
                 clearcoat=False, anisotropy=False, reflectance=False,
                 specular_tint=False)
    if get_spec(MeshMaterial).name not in world.specs:
        return flags
    rows = world.query_rows(MeshMaterial)

    def col(name):
        return world.column(MeshMaterial, name).cpu().numpy()[rows]

    flags["anisotropy"] = bool(np.any(col("anisotropy_strength") > 0.0))
    flags["specular_tint"] = specular_tinted(col("specular_tint"))
    flags["clearcoat"] = bool(np.any(col("clearcoat") > 0.0))
    flags["reflectance"] = bool(np.any(np.abs(col("reflectance") - 0.5)
                                       > 1e-6))
    return flags


def light_records(plight, slight, rlight, spot, rect):
    """(L, F) light records over the three pools (points, then spots, then
    rects), their positions, binning ranges and active mask. F = 8 for
    points only, 16 with spots, 24 with rect lights (see ops/shade.py)."""
    dev = plight.mask.device
    np_ = plight.mask.shape[0]
    p_pos = plight.global_transform.translation
    p_rng = plight.point_light.range
    p_col = plight.point_light.color * plight.point_light.intensity[:, None]
    p_mask = plight.mask & (plight.point_light.shadows == 0)

    def z(n, w):
        return torch.zeros((n, w), device=dev)

    def full(n, v):
        return torch.full((n, 1), v, device=dev)

    if not (spot or rect):
        records = torch.cat([p_pos, p_col, p_rng[:, None], z(np_, 1)], 1)
        return records, p_pos, p_rng, p_mask
    p_rec = torch.cat([p_pos, p_col, p_rng[:, None], z(np_, 1), z(np_, 3),
                       full(np_, -2.0), full(np_, 1.0), z(np_, 3)], 1)
    ns = slight.mask.shape[0]
    s_pos = slight.global_transform.translation
    s_rng = slight.spot_light.range
    s_col = slight.spot_light.color * slight.spot_light.intensity[:, None]
    axes = consts(dev)
    fwd = axes["-z"]
    s_dir = quat_rotate_vec3(slight.global_transform.rotation, fwd)
    cos_o = torch.cos(slight.spot_light.outer_angle)
    inv_co = 1.0 / torch.clamp(torch.cos(slight.spot_light.inner_angle)
                               - cos_o, min=1e-4)
    s_rec = torch.cat([s_pos, s_col, s_rng[:, None], z(ns, 1), s_dir,
                       cos_o[:, None], inv_co[:, None], z(ns, 3)], 1)
    records = torch.cat([p_rec, s_rec])
    pos = torch.cat([p_pos, s_pos])
    rng = torch.cat([p_rng, s_rng])
    lmask = torch.cat([p_mask, slight.mask &
                       (slight.spot_light.shadows == 0)])
    if rect:
        records = torch.nn.functional.pad(records, (0, 24 - records.shape[1]))
        nr = rlight.mask.shape[0]
        r_pos = rlight.global_transform.translation
        rot = rlight.global_transform.rotation
        r_col = rlight.rect_light.color * rlight.rect_light.intensity[:, None]
        r_rng = rlight.rect_light.range
        u_ax = quat_rotate_vec3(rot, axes["x"])
        v_ax = quat_rotate_vec3(rot, axes["y"])
        n_ax = quat_rotate_vec3(rot, fwd)
        hw = rlight.rect_light.width[:, None] * 0.5
        hh = rlight.rect_light.height[:, None] * 0.5
        r_rec = torch.cat([r_pos, r_col, r_rng[:, None], z(nr, 1), n_ax,
                           full(nr, -2.0), full(nr, 1.0), z(nr, 2),
                           full(nr, 1.0), u_ax, v_ax, hw, hh], 1)
        records = torch.cat([records, r_rec])
        pos = torch.cat([pos, r_pos])
        # emission reaches `range` from the nearest rect point: bin by
        # range + the rect's half-diagonal
        rng = torch.cat([rng, r_rng + torch.sqrt(hw[:, 0] ** 2 +
                                                 hh[:, 0] ** 2)])
        lmask = torch.cat([lmask, rlight.mask])
    return records, pos, rng, lmask


def light_screen_bounds(pos, rng, view, fov, near, width, height):
    """Exact-conservative screen AABB of each light sphere from the
    extremes of its view-space box (the reference's df1dd9b bound): the
    extremes of (v ± r)/z over z in [max(vz - r, near), vz + r] lie on box
    corners; full screen only when the camera is inside the sphere.
    Returns (view depth vz, centre px (L, 2), radius px)."""
    ph = torch.cat([pos, torch.ones((pos.shape[0], 1), device=pos.device)],
                   1)
    vz = -(view[2] @ ph.T)
    vx = view[0] @ ph.T
    vy = view[1] @ ph.T
    f = 1.0 / torch.tan(fov * 0.5)
    aspect = width / height
    zmin = torch.clamp(vz - rng, min=near)
    zmax = torch.clamp(vz + rng, min=near)

    def px_range(vc, half_f):
        a, b = (vc - rng) / zmin, (vc - rng) / zmax
        c, d = (vc + rng) / zmin, (vc + rng) / zmax
        lo = torch.minimum(torch.minimum(a, b), torch.minimum(c, d))
        hi = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
        return lo * half_f, hi * half_f

    xlo, xhi = px_range(vx, f / aspect)
    ylo, yhi = px_range(vy, f)
    x0 = (xlo * 0.5 + 0.5) * width
    x1 = (xhi * 0.5 + 0.5) * width
    y0 = (0.5 - yhi * 0.5) * height
    y1 = (0.5 - ylo * 0.5) * height
    cx = (x0 + x1) * 0.5
    cy = (y0 + y1) * 0.5
    r_px = torch.maximum(x1 - x0, y1 - y0) * 0.5
    engulf = (vx * vx + vy * vy + vz * vz) <= rng * rng
    r_px = torch.where(engulf, float(max(width, height) * 2.0), r_px)
    cx = torch.where(engulf, width * 0.5, cx)
    cy = torch.where(engulf, height * 0.5, cy)
    return vz, torch.stack([cx, cy], 1), r_px


def make_deferred_shade(width, height, plugin, device, tile_h=32,
                        tile_w=128, pairs_per_light=4,
                        max_lights_per_tile=256, shards=None):
    from bevy_tpu_torch.transform import GlobalTransform

    size_pad = torch.tensor([width, height, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                            device=device)

    @system(name="deferred_shade")
    def deferred_shade_sys(cam=Query(Read(Camera3d), Read(GlobalTransform)),
                           dlight=Query(Read(DirectionalLight),
                                        Read(GlobalTransform)),
                           plight=Query(Read(PointLight),
                                        Read(GlobalTransform)),
                           slight=Query(Read(SpotLight),
                                        Read(GlobalTransform)),
                           rlight=Query(Read(RectLight),
                                        Read(GlobalTransform)),
                           amb=Res(AmbientLight),
                           clear=Res(ClearColor),
                           target=ResMut(RenderTarget.RESOURCE),
                           stats=ResMut("render_stats")):
        flags = plugin._flags
        with span("lights:bin"):
            ci, has_cam = pick_camera(cam.mask)
            cam_gt = cam.global_transform
            view = view_matrix(cam_gt.translation[ci], cam_gt.rotation[ci],
                               cam_gt.scale[ci])
            near = cam.camera3d.near[ci]
            fov = cam.camera3d.fov[ci]
            vp = perspective_infinite_reverse(fov, width / height, near) @ view
            inv_vp = torch.linalg.inv_ex(vp).inverse   # no host sync
            records, pos, rng, lmask = light_records(
                plight, slight, rlight, flags["spot"], flags["rect"])
            vz, center, r_px = light_screen_bounds(pos, rng, view, fov, near,
                                                   width, height)
            active = lmask & has_cam & (vz + rng > near)
            if shards is not None:
                # bin over the grid padded to whole bands, so each band's
                # tile rows are one slice of the table
                n = shards.size
                nty = (height + n * tile_h - 1) // (n * tile_h) * n
            else:
                nty = (height + tile_h - 1) // tile_h
            ntx = (width + tile_w - 1) // tile_w
            table, counts, lstats = bin_lights(
                center, r_px, active, nty, ntx, tile_h, tile_w,
                pairs_per_light, max_lights_per_tile, records)
            di, has_dl = pick_camera(dlight.mask)
            ldir = quat_rotate_vec3(dlight.global_transform.rotation[di],
                                    consts(device)["-z"])
            lcol = dlight.directional_light.color[di] * \
                dlight.directional_light.illuminance[di] * has_dl
            params = torch.cat([
                inv_vp.reshape(16), ldir, lcol, amb.color * amb.brightness,
                size_pad[:2], clear.color, cam_gt.translation[ci],
                size_pad[2:]])
        shadow = None
        if hasattr(target, "shadow_depth"):
            # the directional light's lit factor from the cascade maps
            # (render/shadow.py), one map gather a pixel, as B3's plane
            with span("shadow:factor"):
                shadow = shadow_factor(
                    pixel_world(inv_vp, target.depth, width, height),
                    target.shadow_depth, target.shadow_vp)
        if shards is not None:
            target.color = par_raster.sharded_deferred_shade(
                shards, target.gbuffer, target.depth, table, counts, params,
                shadow, tile_h=tile_h, tile_w=tile_w, **flags)
        else:
            with span("lights:shade_B3"):
                target.color = deferred_shade(
                    target.gbuffer, target.depth, table, counts, params,
                    shadow, tile_h=tile_h, tile_w=tile_w, **flags)
        # as the reference: into the shared counters, and the port's own
        # light-only counters beside them
        lpo = lstats["light_pair_overflow"]
        lto = lstats["light_tile_overflow"]
        stats.pair_overflow = stats.pair_overflow + lpo
        stats.tile_overflow = stats.tile_overflow + lto
        stats.light_pair_overflow = stats.light_pair_overflow + lpo
        stats.light_tile_overflow = stats.light_tile_overflow + lto

    return deferred_shade_sys


class DeferredLightingPlugin(Plugin):
    """ref: DeferredLightingPlugin. Pair it with
    Mesh3dPlugin(deferred=True). The kernel route follows the device of
    the tensors. shards: None, a device count (the first that many CUDA
    cards) or a ShardMesh: the shade then runs in row bands over them."""

    def __init__(self, tile_h=32, tile_w=128, pairs_per_light=4,
                 max_lights_per_tile=256, shards=None):
        self._flags = None
        self.cfg = dict(tile_h=tile_h, tile_w=tile_w,
                        pairs_per_light=pairs_per_light,
                        max_lights_per_tile=max_lights_per_tile,
                        shards=as_mesh(shards))

    def build(self, app):
        rp = next((p for p in app._plugins if isinstance(p, RenderPlugin)),
                  None)
        if rp is None:
            raise RuntimeError("DeferredLightingPlugin requires RenderPlugin")
        for c in (PointLight, SpotLight, RectLight):
            app.world.register_component(c)
        store = app.world.state["res"][RenderTarget.RESOURCE]
        # 19 planes: albedo rgba, normal, emissive, metallic, roughness,
        # clearcoat, ccr, anisotropy tangent + strength (14:18, zero on
        # the flat path), reflectance (18); 22 with the specular tint
        # (19:22) while a live material tints
        store["gbuffer"] = torch.zeros((19, rp.height, rp.width),
                                       device=app.device)
        add_render_stats(app, "pair_overflow", "tile_overflow",
                         "light_pair_overflow", "light_tile_overflow")
        plugin = self

        def choose_variant(world):
            plugin._flags = _material_flags(world)
            st = world.state["res"][RenderTarget.RESOURCE]
            planes = 22 if plugin._flags["specular_tint"] else 19
            if st["gbuffer"].shape[0] != planes:
                # a structural change only when the plane count changes
                # (the JAX twin bumps on every prepare of a tinted world)
                st["gbuffer"] = torch.zeros((planes, rp.height, rp.width),
                                            device=world.device)
                world.structure_version += 1

        app.add_prepare_hook(choose_variant)
        app.add_systems(Render, clear_gbuffer, in_set=CLEAR_SET)
        app.add_systems(Render,
                        make_deferred_shade(rp.width, rp.height, plugin=self,
                                            device=app.device, **self.cfg),
                        in_set=SHADE_SET)
