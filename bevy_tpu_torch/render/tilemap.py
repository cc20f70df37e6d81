"""Tilemap chunk renderer (port of bevy_tpu/render/tilemap.py; ref:
bevy_sprite_render's `tilemap_chunk/` — a grid of tile indices drawn as
one chunk instead of one sprite a tile).

A chunk is one image pass (plain PyTorch, as the JAX package's is plain
XLA): every framebuffer pixel inside the chunk's rect finds its cell from
its camera-relative position, reads the cell's tile index from the
(rows, cols) grid and samples the tile sheet through
`raster3d_visbuf.sample_atlas`. The cost follows the screen, not the tile
count. The tile indices are a device resource ("tilemap<i>"), so editing
or animating tiles is a resource write with no structural change.

As in the JAX package, the pass reads only the Camera2d's translation:
its scale and rotation do not move the chunk (ROADMAP C3).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.ops.raster3d_visbuf import sample_atlas
from bevy_tpu_torch.render.camera import Camera2d, camera_row, pick_camera
from bevy_tpu_torch.render.plugin import (
    OVERLAY_SET, RenderPlugin, RenderTarget,
)
from bevy_tpu_torch.render.texture import TextureAtlas
from bevy_tpu_torch.transform import GlobalTransform


class TilemapChunk:
    """Host descriptor: a (rows, cols) int grid of tile ids (-1 = empty;
    row 0 is the top row) into a `sheet` atlas handle laid out
    `sheet_cols` x `sheet_rows`; `origin` is the world position of the
    chunk's bottom-left corner."""

    def __init__(self, tiles, sheet, sheet_cols, sheet_rows,
                 tile_size=16.0, origin=(0.0, 0.0), z=5.0):
        self.tiles = np.asarray(tiles, np.int32)
        self.sheet = sheet
        self.sheet_cols = int(sheet_cols)
        self.sheet_rows = int(sheet_rows)
        self.tile_size = float(tile_size)
        self.origin = origin
        self.z = z


def make_tilemap_pass(idx, chunk):
    """The image pass of chunk `idx` (resource "tilemap<idx>")."""
    u0, v0 = chunk.sheet["uv_min"]
    u1, v1 = chunk.sheet["uv_max"]
    du = (u1 - u0) / chunk.sheet_cols
    dv = (v1 - v0) / chunk.sheet_rows
    rows_n, cols_n = chunk.tiles.shape
    sheet_cols = chunk.sheet_cols
    ts = chunk.tile_size
    ox, oy = chunk.origin
    grids = {}                # (device, h, w) -> pixel x (1, W), y (H, 1)

    @system(name=f"tilemap_pass_{idx}")
    def tilemap_chunk_pass(target=ResMut(RenderTarget.RESOURCE),
                           cam=Query(Read(Camera2d), Read(GlobalTransform)),
                           atlas=Res(TextureAtlas.RESOURCE),
                           tm=Res(f"tilemap{idx}")):
        with record_function("tilemap:pass"):
            c = target.color
            _, h, w = c.shape
            key = (c.device, h, w)
            if key not in grids:
                grids[key] = (
                    torch.arange(w, dtype=torch.float32,
                                 device=c.device)[None, :],
                    torch.arange(h, dtype=torch.float32,
                                 device=c.device)[:, None])
            px, py = grids[key]
            ci, has_cam = pick_camera(cam.mask)
            cpos = camera_row(cam.global_transform.translation, ci)
            # world x / y a pixel (1 unit = 1 px, the camera centred)
            wx = px - w / 2 + 0.5 + cpos[0]
            wy = h / 2 - py - 0.5 + cpos[1]
            gx = (wx - ox) / ts
            gy = (wy - oy) / ts
            fgx, fgy = torch.floor(gx), torch.floor(gy)
            cxi, cyi = fgx.to(torch.int32), fgy.to(torch.int32)
            inside = (cxi >= 0) & (cxi < cols_n) & (cyi >= 0) & \
                (cyi < rows_n)
            cxi_c = torch.clamp(cxi, 0, cols_n - 1).long()
            cyi_c = torch.clamp(cyi, 0, rows_n - 1).long()
            # row 0 = the TOP row of the grid (authoring order)
            tile = tm.tiles[rows_n - 1 - cyi_c, cxi_c]
            has_tile = inside & (tile >= 0) & has_cam
            tcol = torch.remainder(tile, sheet_cols)
            trow = torch.div(tile, sheet_cols, rounding_mode="floor")
            fu = gx - fgx
            fv = 1.0 - (gy - fgy)
            au = u0 + (tcol + fu) * du
            av = v0 + (trow + fv) * dv
            texel = sample_atlas(atlas.data, torch.stack([au, av], -1))
            a = texel[..., 3] * has_tile.to(torch.float32)
            rgb = c[:3] * (1 - a[None]) + \
                texel[..., :3].permute(2, 0, 1) * a[None]
            target.color = torch.cat([rgb, c[3:4]], 0)

    return tilemap_chunk_pass


class TilemapPlugin(Plugin):
    """ref: TilemapChunkPlugin. Chunks register before the build; each
    chunk's tile grid becomes a device resource ("tilemap<i>": {"tiles":
    (rows, cols) int32}) that systems may rewrite, and its pass draws in
    the overlay set before the sprite pass."""

    def __init__(self, chunks=None):
        self.chunks = list(chunks or [])

    def add_chunk(self, chunk: TilemapChunk):
        self.chunks.append(chunk)
        return len(self.chunks) - 1

    def build(self, app):
        rp = next((p for p in app._plugins if isinstance(p, RenderPlugin)),
                  None)
        if rp is None:
            raise RuntimeError("TilemapPlugin requires RenderPlugin")
        for i, ch in enumerate(self.chunks):
            app.insert_resource(f"tilemap{i}", {
                "tiles": torch.tensor(ch.tiles, device=app.device)})
            app.add_systems(Render, make_tilemap_pass(i, ch),
                            in_set=OVERLAY_SET, before="sprite_pass")
