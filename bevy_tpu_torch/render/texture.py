"""Texture atlas (port of bevy_tpu/render/texture.py; ref: bevy_image
texture_atlas*.rs + the GpuImage upload of bevy_render/src/render_asset.rs).

All sprite textures live in ONE device-resident atlas (AH, AW, 4) linear
f32: the sprite kernels index it with uv rects, with no per-texture
binding. Packing happens on the host at build time (shelf packing, like
the reference's TextureAtlasBuilder); this module keeps its own copy of
the JAX package's host code.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bevy_tpu_torch.color import srgb_to_linear


class TextureAtlas:
    """Resource name of the packed atlas: `{'data': (AH, AW, 4) f32}`."""
    RESOURCE = "texture_atlas"


class AtlasBuilder:
    """Host-side shelf packer (ref: TextureAtlasBuilder,
    bevy_image/src/texture_atlas_builder.rs). add() returns a handle dict
    usable directly as Sprite uv fields."""

    def __init__(self, width: int = 1024, height: int = 1024):
        self.width = width
        self.height = height
        self.data = np.zeros((height, width, 4), np.float32)
        self._shelf_y = 0
        self._shelf_h = 0
        self._cursor_x = 0
        self.handles: Dict[str, dict] = {}
        self._count = 0

    def add(self, image: np.ndarray, name: str = None,
            srgb: bool = True) -> dict:
        """Pack an (h, w, 3|4) image (u8 or float). Returns
        {'tex', 'uv_min', 'uv_max', 'size'}."""
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.ones(img.shape[:2] + (1,), np.float32)], -1)
        if srgb:
            img = np.concatenate(
                [srgb_to_linear(img[..., :3]).numpy(), img[..., 3:]], -1)
        h, w = img.shape[:2]
        if self._cursor_x + w > self.width:
            self._shelf_y += self._shelf_h
            self._cursor_x = 0
            self._shelf_h = 0
        if self._shelf_y + h > self.height or w > self.width:
            raise ValueError(f"atlas full packing {w}x{h}")
        x, y = self._cursor_x, self._shelf_y
        self.data[y:y + h, x:x + w] = img
        self._cursor_x += w
        self._shelf_h = max(self._shelf_h, h)
        handle = {
            "tex": self._count,
            "uv_min": (x / self.width, y / self.height),
            "uv_max": ((x + w) / self.width, (y + h) / self.height),
            "size": (float(w), float(h)),
        }
        self._count += 1
        if name:
            self.handles[name] = handle
        return handle

    def add_solid(self, name: str = None) -> dict:
        """A 1x1 white texel (the reference's fallback white GpuImage)."""
        return self.add(np.ones((1, 1, 4), np.float32), name, srgb=False)

    def grid(self, handle: dict, cols: int, rows: int, index: int) -> dict:
        """Sub-rect of a packed sheet (ref: TextureAtlasLayout::from_grid)."""
        u0, v0 = handle["uv_min"]
        u1, v1 = handle["uv_max"]
        du, dv = (u1 - u0) / cols, (v1 - v0) / rows
        c, r = index % cols, index // cols
        return {
            "tex": handle["tex"],
            "uv_min": (u0 + c * du, v0 + r * dv),
            "uv_max": (u0 + (c + 1) * du, v0 + (r + 1) * dv),
            "size": (handle["size"][0] / cols, handle["size"][1] / rows),
        }

    def build(self, device) -> torch.Tensor:
        """The atlas as an (AH, AW, 4) f32 tensor on `device`. Install it
        as the TextureAtlas resource: app.insert_resource(
        TextureAtlas.RESOURCE, {'data': builder.build(app.device)})."""
        return torch.tensor(self.data, device=device)


def checkerboard(size: int = 64, cells: int = 8,
                 c0=(1.0, 1.0, 1.0, 1.0),
                 c1=(0.0, 0.0, 0.0, 1.0)) -> np.ndarray:
    """Deterministic test texture (host numpy)."""
    yy, xx = np.mgrid[0:size, 0:size]
    m = ((yy // (size // cells)) + (xx // (size // cells))) % 2
    return np.where(m[..., None] > 0, np.asarray(c1, np.float32),
                    np.asarray(c0, np.float32))
