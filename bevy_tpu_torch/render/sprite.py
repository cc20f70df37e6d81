"""Sprites (port of bevy_tpu/render/sprite.py; ref: bevy_sprite Sprite /
Anchor + bevy_sprite_render extract / queue / prepare / draw,
`src/render/mod.rs:360,442,499`, collapsed into one extract-and-raster
system, since phases are sort keys here, not GPU passes).

The sprite pass draws in the overlay set (after the clear and any 3D
pass): `mode="tiles"` (or "tile") through kernel B4 (ops/raster2d.py),
`mode="splat"` through kernel B5 (ops/raster2d_splat.py). With
`max_cameras=1` it draws the first alive Camera2d over the whole target;
with `max_cameras > 1`, the first k alive cameras in ascending `order`
(2D split-screen), one kernel call each, recentred on the camera's
viewport, whose rect alone is then composited over the frame.

Also here: 9-slice and tiled sprites (`spawn_sliced`, `spawn_tiled`,
host spawns) and sprite-sheet animation (`AtlasAnimation`).
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
from bevy_tpu_torch.render.camera import (
    Camera2d, camera_row, pick_camera, quat_z_angle, select_cameras,
)
from bevy_tpu_torch.render.plugin import (
    OVERLAY_SET, RenderPlugin, RenderTarget, add_render_stats,
)
from bevy_tpu_torch.render.texture import TextureAtlas
from bevy_tpu_torch.transform import GlobalTransform, Transform

MODES = {"tiles": "tiles", "tile": "tiles", "splat": "splat"}


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


def spawn_sliced(world, handle, size, border, pos=(0.0, 0.0), z=10.0,
                 color=(1.0, 1.0, 1.0, 1.0)):
    """9-slice sprite (ref: SpriteImageMode::Sliced + ComputedTextureSlices
    — corner patches keep their pixel size, edges stretch one axis, the
    centre stretches both). `border` = (left, top, right, bottom) px in
    image space, or one number for all four. Spawns up to 9 sprite
    entities, row by row from the top left; returns their rows."""
    u0, v0 = handle["uv_min"]
    u1, v1 = handle["uv_max"]
    iw, ih = handle["size"]
    bl, bt, br, bb = (border, border, border, border) \
        if isinstance(border, (int, float)) else border
    w, h = size
    cw = max(w - bl - br, 0.0)          # stretched centre width
    chh = max(h - bt - bb, 0.0)
    # x slice edges (screen, from the left) and u edges (texture)
    xs = [0.0, bl, bl + cw, w]
    us = [u0, u0 + (u1 - u0) * bl / iw, u1 - (u1 - u0) * br / iw, u1]
    ys = [0.0, bt, bt + chh, h]
    vs = [v0, v0 + (v1 - v0) * bt / ih, v1 - (v1 - v0) * bb / ih, v1]
    rows = []
    px, py = pos
    for j in range(3):
        for i in range(3):
            sw = xs[i + 1] - xs[i]
            sh = ys[j + 1] - ys[j]
            if sw <= 0 or sh <= 0:
                continue
            cx = px - w / 2 + xs[i] + sw / 2
            cy = py + h / 2 - ys[j] - sh / 2
            rows.append(world.spawn(
                Sprite(color=color, size=(sw, sh),
                       uv_min=(us[i], vs[j]), uv_max=(us[i + 1], vs[j + 1]),
                       tex=handle["tex"]),
                Transform(translation=(cx, cy, z)),
                GlobalTransform(translation=(cx, cy, z))).index)
    return rows


def spawn_tiled(world, handle, size, pos=(0.0, 0.0), z=10.0, scale=1.0,
                color=(1.0, 1.0, 1.0, 1.0)):
    """Tiled sprite (ref: SpriteImageMode::Tiled): repeats the image at its
    natural size (x scale) to fill `size`, row by row from the top left;
    edge tiles crop through a trimmed uv rect. Returns the spawned rows."""
    u0, v0 = handle["uv_min"]
    u1, v1 = handle["uv_max"]
    tw = handle["size"][0] * scale
    th = handle["size"][1] * scale
    w, h = size
    px, py = pos
    rows = []
    y = 0.0
    while y < h - 1e-6:
        sh = min(th, h - y)
        x = 0.0
        while x < w - 1e-6:
            sw = min(tw, w - x)
            t = (px - w / 2 + x + sw / 2, py + h / 2 - y - sh / 2, z)
            rows.append(world.spawn(
                Sprite(color=color, size=(sw, sh), uv_min=(u0, v0),
                       uv_max=(u0 + (u1 - u0) * sw / tw,
                               v0 + (v1 - v0) * sh / th),
                       tex=handle["tex"]),
                Transform(translation=t), GlobalTransform(translation=t))
                .index)
            x += tw
        y += th
    return rows


def make_sprite_pass(width, height, tile_h=32, tile_w=128,
                     pairs_per_sprite=4, max_per_tile=256, bilinear=True,
                     max_visible=None, max_cameras=1, sample_dtype="f32",
                     mode="tiles", win_h=40, rotated=True, alpha_only=False):
    """The 2D transparent pass (ref: queue_sprites -> Transparent2d sorted
    phase -> instanced draw, render/mod.rs:499). The raster configuration
    is static, closed over. max_cameras: the static count of Camera2d
    views a frame (ref: one pass per camera in ascending Camera::order,
    each scoped to its Camera2d.vp_min / vp_max rect); 1 draws the first
    alive camera over the whole target."""
    if mode not in MODES:
        raise ValueError(f"SpritePlugin mode {mode!r}: one of {list(MODES)}")
    if sample_dtype not in ("f32", "bf16"):
        raise ValueError(f"sample_dtype {sample_dtype!r}: 'f32' or 'bf16'")
    splat = MODES[mode] == "splat"
    bf16 = sample_dtype == "bf16"
    grids = {}       # device -> pixel x (1, W), y (H, 1): the viewport test

    def one_camera(fb, q, cam, center_w, size_w, angle, planar, ci, alive):
        """Draw the sprites as camera row `ci` sees them (recentred on
        its viewport) over fb; with several cameras, keep only the
        viewport rect of the result. Returns (fb, stats)."""
        with record_function("sprite:prep"):
            cg, c2 = cam.global_transform, cam.camera2d
            cam_xy = camera_row(cg.translation, ci)[:2]
            cam_angle = quat_z_angle(camera_row(cg.rotation, ci))
            cc, cs = torch.cos(cam_angle), torch.sin(cam_angle)
            scale = camera_row(c2.scale, ci)
            # the viewport rect in pixels; the projection recentres on it
            vp_min, vp_max = camera_row(c2.vp_min, ci), camera_row(c2.vp_max,
                                                                  ci)
            vx0, vy0 = vp_min[0] * width, vp_min[1] * height
            vx1, vy1 = vp_max[0] * width, vp_max[1] * height
            d = center_w - cam_xy
            vx = cc * d[:, 0] + cs * d[:, 1]
            vy = -cs * d[:, 0] + cc * d[:, 1]
            center_px = torch.stack([(vx0 + vx1) * 0.5 + vx / scale,
                                     (vy0 + vy1) * 0.5 - vy / scale], -1)
            # world CCW rotation appears CW on a y-down screen
            packed = pack_sprite_instances(
                center=center_px, half=size_w * 0.5 / scale,
                rot=-(angle - cam_angle), color=q.sprite.color,
                uv_min=q.sprite.uv_min, uv_max=q.sprite.uv_max,
                tex=q.sprite.tex, z=q.global_transform.translation[:, 2],
                active=q.mask & alive &
                ((q.sprite.layers & camera_row(c2.layers, ci)) != 0))
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
                out = sprite_splat(fb, *lists, planar, win_h=win_h,
                                   bilinear=bilinear, bf16=bf16,
                                   rotated=rotated, alpha_only=alpha_only)
        else:
            with record_function("sprite:tiles_B4"):
                out = sprite_tiles(fb, *lists, planar, tile_h=tile_h,
                                   tile_w=tile_w, bilinear=bilinear,
                                   bf16=bf16)
        if max_cameras > 1:
            # the viewport as a scissor (ref: RenderPass::set_viewport):
            # composite the rect alone
            with record_function("sprite:viewport"):
                dev = fb.device
                if dev not in grids:
                    grids[dev] = (
                        torch.arange(width, dtype=torch.float32,
                                     device=dev)[None, :],
                        torch.arange(height, dtype=torch.float32,
                                     device=dev)[:, None])
                px, py = grids[dev]
                in_rect = (px >= vx0) & (px < vx1) & (py >= vy0) & \
                    (py < vy1) & alive
                out = torch.where(in_rect[None], out, fb)
        return out, st

    @system(name="sprite_pass")
    def sprite_pass(q=Query(Read(Sprite), Read(GlobalTransform)),
                    cam=Query(Read(Camera2d), Read(GlobalTransform)),
                    target=ResMut(RenderTarget.RESOURCE),
                    atlas=Res(TextureAtlas.RESOURCE),
                    stats=ResMut("render_stats")):
        with record_function("sprite:prep"):
            gt = q.global_transform
            angle = quat_z_angle(gt.rotation)
            size_w = q.sprite.size * gt.scale[:, :2]
            # anchor offset, rotated into world space (y up)
            off = -q.sprite.anchor * size_w
            ca, sa = torch.cos(angle), torch.sin(angle)
            center_w = gt.translation[:, :2] + torch.stack(
                [ca * off[:, 0] - sa * off[:, 1],
                 sa * off[:, 0] + ca * off[:, 1]], -1)
            if max_cameras > 1:
                cam_ids, cam_valid = select_cameras(
                    cam.camera2d.order, cam.mask, max_cameras)
            else:
                idx, has_cam = pick_camera(cam.mask)
                cam_ids, cam_valid = idx.reshape(1), has_cam.reshape(1)
            planar = atlas.data.permute(2, 0, 1).contiguous()
            fb = target.color.contiguous()   # the clear writes an expand
        for k in range(cam_ids.shape[0]):
            fb, st = one_camera(fb, q, cam, center_w, size_w, angle, planar,
                                cam_ids[k], cam_valid[k])
            for key in ("pair_overflow", "tile_overflow",
                        "visible_overflow"):
                setattr(stats, key, getattr(stats, key) + st[key])
        target.color = fb

    return sprite_pass


@component
class AtlasAnimation:
    """Cycles a sprite through atlas frames (ref: the sprite-sheet
    animation pattern of bevy's sprite_sheet example — a TextureAtlas
    index advanced by a timer)."""
    frame = field(())
    fps = field((), default=10.0)
    first = field((), torch.int32)
    count = field((), torch.int32, default=1)


def make_atlas_animation_system(frames):
    """`frames`: a list of atlas handles (e.g. AtlasBuilder.grid(...)
    rects), which become a constant uv table on the world's device, made
    at the first run and indexed there every frame."""
    uv0 = [f["uv_min"] for f in frames]
    uv1 = [f["uv_max"] for f in frames]
    tex = int(frames[0]["tex"])
    n_table = len(frames)
    tables = {}                          # device -> (uv0, uv1)

    @system(name="animate_atlas_sprites")
    def animate_atlas_sprites(q=Query(Sprite, AtlasAnimation),
                              time=Res("time")):
        a = q.atlas_animation
        dev = a.frame.device
        if dev not in tables:
            tables[dev] = (torch.tensor(uv0, dtype=torch.float32, device=dev),
                           torch.tensor(uv1, dtype=torch.float32, device=dev))
        t0, t1 = tables[dev]
        # frame + delta * fps as one rounding, as XLA's CPU backend fuses
        frame = torch.addcmul(a.frame, time.delta, a.fps)
        cnt = torch.clamp(a.count.to(torch.float32), min=1.0)
        frame = torch.remainder(frame, cnt)
        a.frame = frame                  # the merge keeps unmatched rows
        # .to(int32) truncates toward zero, as JAX's astype
        idx = torch.clamp(a.first + frame.to(torch.int32), 0,
                          n_table - 1).long()
        q.sprite.uv_min = t0[idx]
        q.sprite.uv_max = t1[idx]
        q.sprite.tex = torch.full_like(q.sprite.tex, tex)

    return animate_atlas_sprites


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
