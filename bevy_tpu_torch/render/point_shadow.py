"""Point-light shadow cube maps (port of bevy_tpu/render/point_shadow.py;
ref: the point-shadow half of bevy_pbr/src/render/light.rs — six 90-degree
depth views a shadow-casting point light, sampled by face while shading).

The six faces are six perspective depth-only passes (the mesh pass's
group-route raster in its depth-only mode: kernels B1 and B2) into one
(6, size, size) map. The shade gathers no per-pixel view projection: each
pixel picks its face as the argmax of dot(light -> fragment, face forward)
over a static (6, 3) basis and takes its map coordinates from the
analytic 90-degree mapping x/z, y/z in that face's (right, up, forward)
frame; the depth compare stays reverse-z (near / z), as the raster's. The
binned shade (B3) leaves the light out (PointLight.shadows=1); this plugin
adds its GGX term in plain PyTorch, after the deferred shade. Needs the
deferred G-buffer.

Profiler spans: shadow:point (the six passes, mesh:* inside them) and
shadow:point_shade.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.camera import (
    Camera3d, perspective_infinite_reverse,
)
from bevy_tpu_torch.render.deferred import PointLight
from bevy_tpu_torch.render.mesh3d import Mesh3d, MeshMaterial
from bevy_tpu_torch.render.plugin import (
    CLEAR_SET, PASS_SET, SHADE_SET, RenderPlugin, RenderTarget,
)
from bevy_tpu_torch.render.shadow import depth_pass
from bevy_tpu_torch.render.spot_shadow import add_light_term, camera_world

# Per-face orthonormal camera frames (right, up, forward), chosen so that
# right x up = -forward (the camera looks down -z in view space).
_FWD = np.asarray([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                   [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
_UP = np.asarray([[0, 1, 0], [0, 1, 0], [0, 0, 1],
                  [0, 0, -1], [0, 1, 0], [0, 1, 0]], np.float32)
_RIGHT = np.asarray([[0, 0, 1], [0, 0, -1], [1, 0, 0],
                     [1, 0, 0], [-1, 0, 0], [1, 0, 0]], np.float32)


def _face_view(face, lpos, rots):
    """World -> view (4,4) of one cube face at light position `lpos` (3,);
    rots (6, 3, 3) the faces' rows [right, up, -forward]."""
    rot = rots[face]
    t = -rot @ lpos
    bottom = torch.zeros(1, 4, device=lpos.device)
    bottom[0, 3] = 1.0
    return torch.cat([torch.cat([rot, t[:, None]], 1), bottom], 0)


def _pick_shadow_point(plight):
    sel = plight.mask & (plight.point_light.shadows > 0)
    return torch.argmax(sel.to(torch.uint8)), torch.any(sel)


@system(name="clear_point_shadow")
def clear_point_shadow(target=ResMut(RenderTarget.RESOURCE)):
    target.point_shadow_depth = torch.zeros_like(target.point_shadow_depth)


class PointShadowPlugin(Plugin):
    """Cube map and shaded term of the first PointLight with shadows=1
    (ref: point_light_shadow_map + the shadow sampling of bevy_pbr's
    shadows.wesl); the map: `point_shadow_depth` (6, size, size) in the
    RenderTarget store, cleared every frame. Needs
    Mesh3dPlugin(deferred=True) + DeferredLightingPlugin."""

    def __init__(self, mesh_plugin, size=256, near=0.05, bias=2e-3):
        self.mesh_plugin = mesh_plugin
        self.size = size
        self.near = near
        self.bias = bias

    def build(self, app):
        from bevy_tpu_torch.transform import GlobalTransform

        rp = next(p for p in app._plugins if isinstance(p, RenderPlugin))
        width, height = rp.width, rp.height
        size, near, bias = self.size, self.near, self.bias
        mesh_plugin = self.mesh_plugin
        dev = app.device
        store = app.world.state["res"][RenderTarget.RESOURCE]
        store["point_shadow_depth"] = torch.zeros((6, size, size),
                                                  device=dev)
        proj = perspective_infinite_reverse(
            torch.tensor(math.pi / 2, device=dev), 1.0,
            torch.tensor(near, device=dev))
        fwd = torch.as_tensor(_FWD, device=dev)
        up = torch.as_tensor(_UP, device=dev)
        right = torch.as_tensor(_RIGHT, device=dev)
        rots = torch.stack([right, up, -fwd], 1)        # (6, 3, 3) rows

        @system(name="point_shadow_pass")
        def point_shadow_pass(q=Query(Read(Mesh3d), Read(MeshMaterial),
                                      Read(GlobalTransform)),
                              plight=Query(Read(PointLight),
                                           Read(GlobalTransform)),
                              target=ResMut(RenderTarget.RESOURCE),
                              stats=ResMut("render_stats")):
            with span("shadow:point"):
                li, has = _pick_shadow_point(plight)
                lpos = plight.global_transform.translation[li]
                target.point_shadow_depth = torch.stack([
                    depth_pass(mesh_plugin, q,
                               proj @ _face_view(face, lpos, rots), has,
                               target.point_shadow_depth[face], stats,
                               size=size)
                    for face in range(6)])

        @system(name="point_shadow_shade")
        def point_shadow_shade(cam=Query(Read(Camera3d),
                                         Read(GlobalTransform)),
                               plight=Query(Read(PointLight),
                                            Read(GlobalTransform)),
                               target=ResMut(RenderTarget.RESOURCE)):
            with span("shadow:point_shade"):
                li, has = _pick_shadow_point(plight)
                ci, has_cam, cam_gt, world = camera_world(cam, target, width,
                                                          height)
                z = target.depth
                pl = plight.point_light
                lpos = plight.global_transform.translation[li]
                to_frag = world - lpos[None, None, :]    # light -> fragment
                d2 = torch.sum(to_frag * to_frag, -1)
                inv_d = torch.rsqrt(torch.clamp(d2, min=1e-9))
                ldir = -to_frag * inv_d[..., None]       # toward the light
                rng = pl.range[li]
                win = torch.clamp(
                    1.0 - (d2 / torch.clamp(rng * rng, min=1e-9)) ** 2,
                    0.0, 1.0)
                atten = win * win / (d2 + 1.0)
                # the face pick and the analytic 90-degree projection in
                # that face's frame
                scores = torch.einsum("hwj,fj->hwf", to_frag, fwd)
                face = torch.argmax(scores, -1)          # first of ties
                zf = torch.clamp(torch.amax(scores, -1), min=1e-6)
                sx = torch.sum(to_frag * right[face], -1) / zf
                sy = torch.sum(to_frag * up[face], -1) / zf
                # truncation toward zero before the clamp (the JAX int32
                # cast), not floor
                ix = torch.clamp(((sx * 0.5 + 0.5) * size).to(torch.int32),
                                 0, size - 1).long()
                iy = torch.clamp(((0.5 - sy * 0.5) * size).to(torch.int32),
                                 0, size - 1).long()
                lz = near / zf                           # reverse-z depth
                occ = target.point_shadow_depth[face, iy, ix]
                lit = (occ <= lz + bias).to(torch.float32)
                lcol = (pl.color[li] * pl.intensity[li])[None, None, :] * \
                    (atten * lit)[..., None]
                target.color = add_light_term(target, cam_gt, ci, world,
                                              ldir, lcol,
                                              (z > 0) & has & has_cam)

        app.add_systems(Render, clear_point_shadow, in_set=CLEAR_SET)
        app.add_systems(Render, point_shadow_pass, in_set=PASS_SET,
                        before="mesh_pass")
        app.add_systems(Render, point_shadow_shade, in_set=SHADE_SET,
                        after="deferred_shade")
