"""Sprites (port of bevy_tpu/render/sprite.py; ref: bevy_sprite Sprite /
Anchor + bevy_sprite_render extract / queue / prepare / draw,
`src/render/mod.rs:360,442,499`, collapsed into one extract-and-raster
system, since phases are sort keys here, not GPU passes).

The sprite pass draws the first Camera2d over the whole target, in the
overlay set (after the clear and any 3D pass): `mode="tiles"` (or
"tile") through kernel B4 (ops/raster2d.py), `mode="splat"` through
kernel B5 (ops/raster2d_splat.py).

Not ported, each raising NotImplementedError that names its ROADMAP
item: several 2D cameras (`max_cameras > 1`, split-screen viewports),
9-slice and tiled sprites (`spawn_sliced`, `spawn_tiled`) and atlas
animation (`AtlasAnimation`), all A6b.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Read, Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.ops.raster2d import (
    bin_sprites, pack_sprite_instances, sprite_tiles,
)
from bevy_tpu_torch.ops.raster2d_splat import (
    build_sprite_windows, sprite_splat,
)
from bevy_tpu_torch.render.camera import Camera2d, pick_camera, quat_z_angle
from bevy_tpu_torch.render.plugin import (
    OVERLAY_SET, RenderPlugin, RenderTarget, add_render_stats,
)
from bevy_tpu_torch.render.texture import TextureAtlas
from bevy_tpu_torch.transform import GlobalTransform, Transform

MODES = {"tiles": "tiles", "tile": "tiles", "splat": "splat"}


def _unported(feature):
    return NotImplementedError(
        f"{feature} is not ported to bevy_tpu_torch yet (ROADMAP A6b)")


class Anchor:
    """ref: bevy_sprite Anchor variants (anchor point inside the rect, in
    [-0.5, 0.5]² sprite-local units; the translation sits at the anchor)."""
    CENTER = (0.0, 0.0)
    BOTTOM_LEFT = (-0.5, -0.5)
    BOTTOM_CENTER = (0.0, -0.5)
    BOTTOM_RIGHT = (0.5, -0.5)
    CENTER_LEFT = (-0.5, 0.0)
    CENTER_RIGHT = (0.5, 0.0)
    TOP_LEFT = (-0.5, 0.5)
    TOP_CENTER = (0.0, 0.5)
    TOP_RIGHT = (0.5, 0.5)


@component
class Sprite:
    """ref: Sprite (`size` is required: images give their natural size
    through the atlas handle at spawn). The uv rect and tex index address
    the global atlas; tex < 0 draws a solid colour."""
    color = field(4, default=(1.0, 1.0, 1.0, 1.0))
    size = field(2, default=(1.0, 1.0))
    anchor = field(2, default=(0.0, 0.0))
    uv_min = field(2, default=(0.0, 0.0))
    uv_max = field(2, default=(1.0, 1.0))
    tex = field((), torch.int32, default=-1)
    layers = field((), torch.int32, default=1)  # ref: RenderLayers bitmask


def sprite_from_handle(handle, color=(1.0, 1.0, 1.0, 1.0), size=None,
                       anchor=Anchor.CENTER, flip_x=False, flip_y=False):
    """Sprite bound to an AtlasBuilder handle (ref: Sprite::from_image;
    flip_x / flip_y swap the uv rect like the reference's flip flags)."""
    u0, v0 = handle["uv_min"]
    u1, v1 = handle["uv_max"]
    if flip_x:
        u0, u1 = u1, u0
    if flip_y:
        v0, v1 = v1, v0
    return Sprite(
        color=color, size=tuple(size) if size is not None else handle["size"],
        anchor=anchor, uv_min=(u0, v0), uv_max=(u1, v1), tex=handle["tex"])


def spawn_sliced(*args, **kwargs):
    """9-slice sprite (ref: SpriteImageMode::Sliced)."""
    raise _unported("spawn_sliced (9-slice sprites)")


def spawn_tiled(*args, **kwargs):
    """Tiled sprite (ref: SpriteImageMode::Tiled)."""
    raise _unported("spawn_tiled (tiled sprites)")


class AtlasAnimation:
    """Sprite-sheet animation (ref: the sprite_sheet example's timer-driven
    TextureAtlas index)."""

    def __new__(cls, *args, **kwargs):
        raise _unported("AtlasAnimation")


def make_atlas_animation_system(frames):
    raise _unported("AtlasAnimation")


def make_sprite_pass(width, height, tile_h=32, tile_w=128,
                     pairs_per_sprite=4, max_per_tile=256, bilinear=True,
                     max_visible=None, max_cameras=1, sample_dtype="f32",
                     mode="tiles", win_h=40, rotated=True, alpha_only=False):
    """The 2D transparent pass (ref: queue_sprites -> Transparent2d sorted
    phase -> instanced draw, render/mod.rs:499) for the first alive
    Camera2d. The raster configuration is static, closed over."""
    if max_cameras > 1:
        raise _unported("max_cameras > 1 (several 2D cameras)")
    if mode not in MODES:
        raise ValueError(f"SpritePlugin mode {mode!r}: one of {list(MODES)}")
    if sample_dtype not in ("f32", "bf16"):
        raise ValueError(f"sample_dtype {sample_dtype!r}: 'f32' or 'bf16'")
    splat = MODES[mode] == "splat"
    bf16 = sample_dtype == "bf16"

    @system(name="sprite_pass")
    def sprite_pass(q=Query(Read(Sprite), Read(GlobalTransform)),
                    cam=Query(Read(Camera2d), Read(GlobalTransform)),
                    target=ResMut(RenderTarget.RESOURCE),
                    atlas=Res(TextureAtlas.RESOURCE),
                    stats=ResMut("render_stats")):
        with record_function("sprite:prep"):
            gt = q.global_transform
            t = gt.translation
            angle = quat_z_angle(gt.rotation)
            size_w = q.sprite.size * gt.scale[:, :2]
            # anchor offset, rotated into world space (y up)
            off = -q.sprite.anchor * size_w
            ca, sa = torch.cos(angle), torch.sin(angle)
            center_w = t[:, :2] + torch.stack(
                [ca * off[:, 0] - sa * off[:, 1],
                 sa * off[:, 0] + ca * off[:, 1]], -1)
            idx, has_cam = pick_camera(cam.mask)
            cg = cam.global_transform
            cam_xy = cg.translation[idx, :2]
            cam_angle = quat_z_angle(cg.rotation[idx])
            cc, cs = torch.cos(cam_angle), torch.sin(cam_angle)
            scale = cam.camera2d.scale[idx]
            vmin, vmax = cam.camera2d.vp_min[idx], cam.camera2d.vp_max[idx]
            d = center_w - cam_xy
            vx = cc * d[:, 0] + cs * d[:, 1]
            vy = -cs * d[:, 0] + cc * d[:, 1]
            center_px = torch.stack(
                [(vmin[0] * width + vmax[0] * width) * 0.5 + vx / scale,
                 (vmin[1] * height + vmax[1] * height) * 0.5 - vy / scale],
                -1)
            # world CCW rotation appears CW on a y-down screen
            packed = pack_sprite_instances(
                center=center_px, half=size_w * 0.5 / scale,
                rot=-(angle - cam_angle), color=q.sprite.color,
                uv_min=q.sprite.uv_min, uv_max=q.sprite.uv_max,
                tex=q.sprite.tex, z=t[:, 2],
                active=q.mask & has_cam &
                ((q.sprite.layers & cam.camera2d.layers[idx]) != 0))
            planar = atlas.data.permute(2, 0, 1).contiguous()
            fb = target.color.contiguous()   # the clear writes an expand
            if splat:
                lists = build_sprite_windows(
                    packed, height, width, win_h=win_h,
                    windows_per_sprite=pairs_per_sprite,
                    max_visible=max_visible)
            else:
                lists = bin_sprites(
                    packed, height, width, tile_h=tile_h, tile_w=tile_w,
                    pairs_per_sprite=pairs_per_sprite,
                    max_per_tile=max_per_tile, max_visible=max_visible)
        *lists, st = lists
        if splat:
            with record_function("sprite:splat_B5"):
                fb = sprite_splat(fb, *lists, planar, win_h=win_h,
                                  bilinear=bilinear, bf16=bf16,
                                  rotated=rotated, alpha_only=alpha_only)
        else:
            with record_function("sprite:tiles_B4"):
                fb = sprite_tiles(fb, *lists, planar, tile_h=tile_h,
                                  tile_w=tile_w, bilinear=bilinear,
                                  bf16=bf16)
        for k in ("pair_overflow", "tile_overflow", "visible_overflow"):
            setattr(stats, k, getattr(stats, k) + st[k])
        target.color = fb

    return sprite_pass


class SpritePlugin(Plugin):
    """ref: SpritePlugin + SpriteRenderPlugin. The raster's static knobs
    surface here (the reference's equivalents are pipeline specialization
    keys). sample_dtype="bf16" samples the atlas with bf16 operands;
    rotated=False and alpha_only=True are splat-mode specializations (no
    sprite rotates; the atlas RGB planes are all ones)."""

    def __init__(self, tile_h=32, tile_w=128, pairs_per_sprite=4,
                 max_per_tile=256, bilinear=True, max_visible=None,
                 max_cameras=1, sample_dtype="f32", mode="tiles", win_h=40,
                 rotated=True, alpha_only=False):
        self.cfg = dict(tile_h=tile_h, tile_w=tile_w,
                        pairs_per_sprite=pairs_per_sprite,
                        max_per_tile=max_per_tile, bilinear=bilinear,
                        max_visible=max_visible, max_cameras=max_cameras,
                        sample_dtype=sample_dtype, mode=mode, win_h=win_h,
                        rotated=rotated, alpha_only=alpha_only)

    def build(self, app):
        rp = next((p for p in app._plugins if isinstance(p, RenderPlugin)),
                  None)
        if rp is None:
            raise RuntimeError("SpritePlugin requires RenderPlugin")
        for c in (Sprite, Camera2d, Transform, GlobalTransform):
            app.world.register_component(c)
        add_render_stats(app, "pair_overflow", "tile_overflow",
                         "visible_overflow")
        app.add_systems(Render, make_sprite_pass(rp.width, rp.height,
                                                 **self.cfg),
                        in_set=OVERLAY_SET)
