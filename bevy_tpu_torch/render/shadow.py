"""Cascaded directional shadow maps (port of bevy_tpu/render/shadow.py;
ref: bevy_pbr's shadow pass — the shadow views of `src/render/light.rs`
and a depth-only raster; cascade splits after `bevy_light/src/cascade.rs`
CascadeShadowConfig).

N orthographic light-view passes raster the scene's depth into the
cascade layers (reverse-z, the mesh pass's own group-route raster in its
depth-only mode: kernels B1 and B2), each cascade centred on the camera
with a growing extent. The deferred shade (render/deferred.py)
reconstructs each pixel's world position, picks the tightest cascade that
holds it, PCF-filters four map taps (`shadow_factor`) and hands the lit
factor to B3 as its (H, W) shadow plane, which attenuates the directional
light.

Profiler spans: shadow:dir around the passes (the mesh:* spans of
raster_batched inside it); deferred.py opens shadow:factor.
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.affine import TRS, trs_to_mat4
from bevy_tpu_torch.math.quat import quat_rotate_vec3
from bevy_tpu_torch.render.camera import (
    Camera3d, consts, pick_camera, view_matrix,
)
from bevy_tpu_torch.render.mesh3d import (
    DirectionalLight, Mesh3d, MeshMaterial, raster_batched,
)
from bevy_tpu_torch.render.plugin import CLEAR_SET, PASS_SET, RenderTarget


def ortho_reverse(extent, far, device=None):
    """(4,4) orthographic projection, reverse-z in [0,1] (near 0 -> 1, far
    -> 0), symmetric +-extent."""
    e = torch.as_tensor(extent, dtype=torch.float32, device=device)
    f = torch.as_tensor(far, dtype=torch.float32, device=e.device)
    z = torch.zeros((), device=e.device)
    o = torch.ones((), device=e.device)
    return torch.stack([
        torch.stack([o / e, z, z, z]),
        torch.stack([z, o / e, z, z]),
        torch.stack([z, z, o / f, o]),      # z_ndc = (view_z + far) / far
        torch.stack([z, z, z, o]),
    ])


@lru_cache(maxsize=None)
def _ortho(extent, far, device):
    return ortho_reverse(extent, far, device)


def light_view_proj(light_rot, focus, extent, distance):
    """World -> light clip (4,4) for a directional light looking along its
    -Z from `distance` behind the focus point (extent, distance: floats)."""
    c = consts(light_rot.device)
    fwd = quat_rotate_vec3(light_rot, c["-z"])
    eye = focus - fwd * distance
    view = view_matrix(eye, light_rot, c["ones"])
    return _ortho(float(extent), float(distance * 2.0), light_rot.device) \
        @ view


@system(name="clear_shadow_map")
def clear_shadow_map(target=ResMut(RenderTarget.RESOURCE)):
    target.shadow_depth = torch.zeros_like(target.shadow_depth)


def depth_pass(mesh_plugin, q, lvp, ok, depth, stats, *, size, tile_h=16,
               tile_w=128, max_per_tile=512):
    """One depth-only raster of every mesh group of `mesh_plugin` (its
    `_groups`, built on structural change) under the light's view
    projection `lvp` (4,4) into `depth` (size, size); `ok` a bool scalar
    tensor gating every instance (a light exists). Returns the new depth;
    the raster's overflows and fallback clusters add to `stats`. As the
    JAX package's shadow passes, no coplanar-quad records (the windows
    take the triangles) and no instance cull."""
    t = SimpleNamespace(depth=depth)
    gt = q.global_transform
    for grp in mesh_plugin._groups or ():
        rows = grp["rows"]
        mats = trs_to_mat4(TRS(translation=gt.translation[rows],
                               rotation=gt.rotation[rows],
                               scale=gt.scale[rows]))
        mvp = torch.einsum("ij,njk->nik", lvp, mats)
        clip = torch.einsum("nij,vj->nvi", mvp, grp["ph"])
        raster_batched(clip, None, dict(grp, quads=None), q.mask[rows] & ok,
                       None, None, t, stats, width=size, height=size,
                       tile_h=tile_h, tile_w=tile_w,
                       max_per_tile=max_per_tile, depth_only=True)
    return t.depth


def make_shadow_pass(plugin, size, extents, distance, tile_h=32, tile_w=128,
                     max_per_tile=512):
    """Depth-only passes over the mesh plugin's groups from the first
    directional light's view, one per cascade, each centred on the camera
    position with its own extent (ref: the per-cascade shadow views of
    light.rs + cascade.rs). Span shadow:dir."""
    from bevy_tpu_torch.transform import GlobalTransform

    @system(name="shadow_pass")
    def shadow_pass(q=Query(Read(Mesh3d), Read(MeshMaterial),
                            Read(GlobalTransform)),
                    light=Query(Read(DirectionalLight),
                                Read(GlobalTransform)),
                    cam=Query(Read(Camera3d), Read(GlobalTransform)),
                    target=ResMut(RenderTarget.RESOURCE),
                    stats=ResMut("render_stats")):
        with span("shadow:dir"):
            li, has_light = pick_camera(light.mask)
            ci, has_cam = pick_camera(cam.mask)
            focus = cam.global_transform.translation[ci] * has_cam
            rot = light.global_transform.rotation[li]
            depths, vps = [], []
            for casc, extent in enumerate(extents):
                lvp = light_view_proj(rot, focus, extent, distance)
                depths.append(depth_pass(
                    plugin, q, lvp, has_light, target.shadow_depth[casc],
                    stats, size=size, tile_h=tile_h, tile_w=tile_w,
                    max_per_tile=max_per_tile))
                vps.append(lvp)
            target.shadow_depth = torch.stack(depths)
            target.shadow_vp = torch.stack(vps)

    return shadow_pass


def shadow_factor(world_xyz, shadow_depth, shadow_vp, bias=2e-3):
    """(H, W) lit factor from world positions (H, W, 3): what B3 takes as
    its shadow plane. shadow_depth (N, S, S) cascade layers, shadow_vp
    (N, 4, 4); each pixel uses the tightest cascade
    that holds its light-space position and averages 4 neighbouring taps
    (ref: the cascade pick of shadows.wesl + sample_shadow_map's PCF).
    Texel coordinates truncate toward zero before the clamp, as the JAX
    package's int32 casts do."""
    size = shadow_depth.shape[1]
    h, w = world_xyz.shape[:2]
    ph = torch.cat([world_xyz, torch.ones((h, w, 1),
                                          device=world_xyz.device)], -1)
    clip = torch.einsum("nij,hwj->nhwi", shadow_vp, ph)    # (N, H, W, 4)
    x, y, z = clip[..., 0], clip[..., 1], clip[..., 2]
    inside = (torch.abs(x) < 0.999) & (torch.abs(y) < 0.999)
    # the tightest cascade that holds the pixel: the first along N
    # (extents ascend); argmax returns the first of equal maxima
    first = torch.argmax(inside.to(torch.uint8), 0)        # (H, W)
    any_in = torch.any(inside, 0)
    sel = first[None]
    xs = torch.gather(x, 0, sel)[0]
    ys = torch.gather(y, 0, sel)[0]
    zs = torch.gather(z, 0, sel)[0]
    fx = (xs * 0.5 + 0.5) * size
    fy = (0.5 - ys * 0.5) * size
    # slope-scaled bias: a texel of light-space travel changes the surface
    # depth by up to texel_world * dz/dworld (both from the projection
    # rows), so the PCF neighbours do not self-shadow slopes
    s_xy = torch.linalg.vector_norm(shadow_vp[:, 0, :3], dim=-1)  # 1/extent
    s_z = torch.linalg.vector_norm(shadow_vp[:, 2, :3], dim=-1)   # 1/far
    texel_bias = 4.0 * s_z / (size * torch.clamp(s_xy, min=1e-8))
    b = bias + texel_bias[first]
    taps = ((0, 0), (1, 0), (0, 1), (1, 1))
    lit_acc = torch.zeros_like(zs)
    ix0, iy0 = fx.to(torch.int32), fy.to(torch.int32)
    for dy, dx in taps:
        ix = torch.clamp(ix0 + dx, 0, size - 1).long()
        iy = torch.clamp(iy0 + dy, 0, size - 1).long()
        occluder = shadow_depth[first, iy, ix]
        # reverse-z: nearer the light is larger; occluded where the map
        # holds something nearer the light than this pixel
        lit_acc = lit_acc + (occluder <= zs + b).to(torch.float32)
    return torch.where(any_in, lit_acc / len(taps), 1.0)


class ShadowPlugin(Plugin):
    """ref: the shadow half of PbrPlugin + CascadeShadowConfig. Needs
    Mesh3dPlugin(deferred=True) (its group route) + DeferredLightingPlugin.
    `extent` is the half-size of the largest cascade around the camera;
    `cascades` maps with `cascade_ratio` to tighter near cascades
    (extent * ratio^k). The maps: `shadow_depth` (N, size, size) and
    `shadow_vp` (N, 4, 4) in the RenderTarget store, cleared every frame."""

    def __init__(self, mesh_plugin, size=1024, extent=60.0, distance=80.0,
                 cascades=1, cascade_ratio=0.35):
        self.mesh_plugin = mesh_plugin
        self.size = size
        self.extents = [extent * cascade_ratio ** (cascades - 1 - i)
                        for i in range(cascades)]
        self.distance = distance

    def build(self, app):
        n, size = len(self.extents), self.size
        store = app.world.state["res"][RenderTarget.RESOURCE]
        store["shadow_depth"] = torch.zeros((n, size, size),
                                            device=app.device)
        store["shadow_vp"] = torch.eye(4, device=app.device) \
            .expand(n, 4, 4).clone()
        app.add_systems(Render, clear_shadow_map, in_set=CLEAR_SET)
        app.add_systems(Render,
                        make_shadow_pass(self.mesh_plugin, size,
                                         self.extents, self.distance),
                        in_set=PASS_SET, before="mesh_pass")
