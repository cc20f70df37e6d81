"""Decals (port of bevy_tpu/render/decal.py; ref: bevy_pbr's clustered
decals — `src/decal/`: box projectors that stamp a colour or texture onto
the G-buffer surface inside them).

Decals are entities with a `Decal` component. One image pass after the
mesh pass (PASS_SET, after "mesh_pass") reconstructs world positions from
the depth, takes them into each decal's unit box and blends the decal's
colour (times an atlas texture through its uv rect, where the plugin has
an atlas) into the G-buffer albedo before the shade. Decals blend in row
order, the first 64 rows only, as in the JAX package; the pass walks the
live rows among them, which a prepare hook reads from the host once a
structural change (a row that holds no decal blends nothing, so skipping
it changes no bit). Needs the deferred G-buffer.
"""

from __future__ import annotations

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.quat import quat_conjugate, quat_rotate_vec3
from bevy_tpu_torch.ops.raster3d_visbuf import sample_atlas
from bevy_tpu_torch.render.camera import Camera3d, pixel_world
from bevy_tpu_torch.render.plugin import PASS_SET, RenderTarget
from bevy_tpu_torch.render.post import camera_vp, inverse
from bevy_tpu_torch.transform import GlobalTransform

MAX_DECALS = 64      # rows the pass reads, as the JAX package's loop


@component
class Decal:
    """A box projector (the entity's transform is the box): `color`
    multiplies into the surface albedo inside the unit box (ref:
    ClusteredDecal). uv_min / uv_max: an optional atlas rect (equal:
    untextured)."""
    color = field(4, default=(1.0, 1.0, 1.0, 1.0))
    uv_min = field(2)
    uv_max = field(2)


def stamp_decal(albedo, world, geom, t, rot_inv, scale, alive, color,
                uv_min=None, uv_max=None, atlas=None):
    """Blend one decal into the albedo (H, W, 4) at world positions
    (H, W, 3) inside its box, where `geom` (covered pixels) and `alive`
    (0-d bool)."""
    local = quat_rotate_vec3(rot_inv[None, None, :],
                             world - t[None, None, :])
    local = local / torch.clamp(scale[None, None, :], min=1e-6)
    inside = (torch.amax(torch.abs(local), -1) <= 0.5) & geom & alive
    if atlas is not None:
        textured = uv_max[0] > uv_min[0]
        uv = torch.stack(
            [uv_min[0] + (local[..., 0] + 0.5) * (uv_max[0] - uv_min[0]),
             uv_min[1] + (0.5 - local[..., 2]) * (uv_max[1] - uv_min[1])],
            -1)
        tex = sample_atlas(atlas, uv)
        dcol = torch.where(textured, color[None, None] * tex,
                           color.expand(tex.shape))
    else:
        dcol = color[None, None].expand(albedo.shape[:2] + (4,))
    a = dcol[..., 3] * inside.to(torch.float32)
    return torch.cat([albedo[..., :3] * (1 - a[..., None]) +
                      dcol[..., :3] * a[..., None], albedo[..., 3:4]], -1)


class DecalPlugin(Plugin):
    """ref: the decal half of bevy_pbr. Needs the deferred G-buffer; runs
    after the mesh pass, before the shade. atlas: an optional (AH, AW, 4)
    array the decals' uv rects index."""

    def __init__(self, near=0.1, atlas=None):
        self.near = near
        self.atlas = atlas
        self._rows = []

    def build(self, app):
        atlas = None if self.atlas is None else torch.as_tensor(
            np.asarray(self.atlas, np.float32), device=app.device)
        app.world.register_component(Decal)
        plugin = self

        def live_rows(world):
            plugin._rows = [int(r) for r in world.query_rows(Decal)
                            if r < MAX_DECALS]

        @system(name="decal_pass")
        def decal_pass(target=ResMut(RenderTarget.RESOURCE),
                       decals=Query(Read(Decal), Read(GlobalTransform)),
                       cam=Query(Read(Camera3d), Read(GlobalTransform))):
            if not plugin._rows:
                return
            g, z = target.gbuffer, target.depth
            h, w = z.shape
            vp, *_, has_cam = camera_vp(cam, w, h)
            world = pixel_world(inverse(vp), z, w, h)
            albedo = g[0:4].permute(1, 2, 0)
            geom = (z > 0) & has_cam
            gt, dc = decals.global_transform, decals.decal
            inv_rot = quat_conjugate(gt.rotation)
            for i in plugin._rows:
                albedo = stamp_decal(
                    albedo, world, geom, gt.translation[i], inv_rot[i],
                    gt.scale[i], decals.mask[i], dc.color[i], dc.uv_min[i],
                    dc.uv_max[i], atlas)
            target.gbuffer = torch.cat([albedo.permute(2, 0, 1), g[4:]], 0)

        app.add_prepare_hook(live_rows)
        app.add_systems(Render, decal_pass, in_set=PASS_SET,
                        after="mesh_pass")
