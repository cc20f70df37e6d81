"""Text rendering (port of bevy_tpu/render/text.py; ref: bevy_text — font
assets, glyph atlases `src/font_atlas*.rs`, the layout pipeline; parley
shaping is replaced by the monospace layout of a bitmap font).

Two tiers:
  * static text: `spawn_text` bakes a string on the host into one glyph
    sprite a character (re-spawn to change it; the reference relayouts
    too);
  * dynamic numbers: `DigitText` slots pick their glyph's uv rect on the
    device every frame from a numeric resource (no host round trip), the
    way counters such as an FPS overlay are drawn.

The font is the JAX package's default one (PIL's built-in font, baked
monospace): its 95 printable ASCII glyphs are stored in
`default_font.npz` beside this file (written by tests/make_torch_font.py),
so this package reads no PIL. TrueType fonts (`FontAtlas(path=...)`,
`FontAtlas(size=...)`), glyphs outside the table and whole-run shaping
(`shape_run`, `spawn_shaped_text`) raise NotImplementedError (ROADMAP
A6c).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Res
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.sprite import Sprite
from bevy_tpu_torch.transform import GlobalTransform, Transform

ASCII_START, ASCII_END = 32, 127
FONT_TABLE = Path(__file__).resolve().parent / "default_font.npz"


def _unported(feature):
    return NotImplementedError(
        f"{feature} is not ported to bevy_tpu_torch yet (ROADMAP A6c: "
        f"TrueType fonts, shaping and glyphs outside the default font)")


@lru_cache(maxsize=None)
def default_font():
    """The stored default font: ({char: (h, w) u8 coverage}, ascent,
    descent)."""
    t = np.load(FONT_TABLE)
    glyphs = {}
    for code, (h, w), o in zip(t["codes"], t["sizes"], t["offsets"]):
        glyphs[chr(int(code))] = t["alpha"][o:o + h * w].reshape(h, w)
    ascent, descent = (int(v) for v in t["metrics"])
    return glyphs, ascent, descent


class FontAtlas:
    """Glyph atlas baked on the host (ref: bevy_text font_atlas_set.rs —
    rasterize once into a texture atlas, sample a glyph quad). The default
    font only, monospace: each glyph's coverage scaled `scale` times into
    the builder under `glyph:<char>`; advance = its scaled width, char_w
    = the width of "M", char_h = the font's line height (ascent +
    descent, unscaled, as the JAX FontAtlas reads it)."""

    def __init__(self, builder, scale: int = 2, path: str | None = None,
                 size: int | None = None):
        if path is not None or size is not None:
            raise _unported("FontAtlas(path=..., size=...)")
        self.proportional = False
        self.handles: Dict[str, dict] = {}
        self.advances: Dict[str, float] = {}
        self.bearings: Dict[str, tuple] = {}
        self.scale = scale
        self._builder = builder
        self._path = None
        glyphs, ascent, descent = default_font()
        for code in range(ASCII_START, ASCII_END):
            ch = chr(code)
            a = glyphs[ch].astype(np.float32) / 255.0
            if scale != 1:
                a = np.repeat(np.repeat(a, scale, 0), scale, 1)
            rgba = np.ones(a.shape + (4,), np.float32)
            rgba[..., 3] = a
            self.handles[ch] = builder.add(rgba, f"glyph:{ch}", srgb=False)
            self.advances[ch] = float(glyphs[ch].shape[1]) * scale
            self.bearings[ch] = (0.0, 0.0)
        self.char_w = self.handles["M"]["size"][0]
        self.char_h = float(ascent + descent)
        self.ascent = float(ascent)

    def has(self, ch: str) -> bool:
        """Does this font cover `ch`? (printable ASCII; the rich-text
        fallback chain walks this, ref: bevy_text's FontFamily fallback
        in parley_context.rs)."""
        return ch in self.handles

    def glyph(self, ch: str) -> dict:
        """Atlas handle for `ch`."""
        if ch not in self.handles:
            raise _unported(f"glyph {ch!r} (U+{ord(ch):04X})")
        return self.handles[ch]

    def measure(self, text: str) -> float:
        """Pixel width of a single line at native size."""
        return sum(self.advances.get(ch, self.char_w) for ch in text)


def wrap_lines_measured(text: str, max_width: float, measure):
    """Word wrap by measured pixel width (proportional fonts)."""
    lines = []
    for raw in text.split("\n"):
        cur = ""
        for word in raw.split(" "):
            while measure(word) > max_width:      # unbreakable long word
                if cur:
                    lines.append(cur)
                    cur = ""
                cut = len(word)
                while cut > 1 and measure(word[:cut]) > max_width:
                    cut -= 1
                lines.append(word[:cut])
                word = word[cut:]
            cand = f"{cur} {word}" if cur else word
            if measure(cand) <= max_width:
                cur = cand
            else:
                lines.append(cur)
                cur = word
        lines.append(cur)
    return lines


def wrap_lines(text: str, chars_per_line: int):
    """Word wrap at spaces, breaking words longer than a line (ref: the
    Linebreak::WordBoundary policy, bevy_text/src/text.rs)."""
    lines = []
    for raw in text.split("\n"):
        cur = ""
        for word in raw.split(" "):
            while len(word) > chars_per_line:     # unbreakable long word
                if cur:
                    lines.append(cur)
                    cur = ""
                lines.append(word[:chars_per_line])
                word = word[chars_per_line:]
            cand = f"{cur} {word}" if cur else word
            if len(cand) <= chars_per_line:
                cur = cand
            else:
                lines.append(cur)
                cur = word
        lines.append(cur)
    return lines


def shape_run(*args, **kwargs):
    """Shape a complex-script run with HarfBuzz + FriBiDi (ref: bevy_text's
    parley shaping)."""
    raise _unported("shape_run")


def spawn_shaped_text(*args, **kwargs):
    """Shape and spawn a complex-script run as one sprite."""
    raise _unported("spawn_shaped_text")


def spawn_text(world, font: FontAtlas, text: str, pos=(0.0, 0.0), z=10.0,
               color=(1.0, 1.0, 1.0, 1.0), size=None, max_width=None,
               justify="left"):
    """Bake a string into glyph sprites (monospace advance), one spawn a
    glyph in reading order. Returns their rows. `max_width` wraps at word
    boundaries (ref: TextLayout::linebreak); `justify` is "left" /
    "center" / "right" within max_width, or within the widest line when
    max_width is None (ref: Justify). Every glyph of a call shares `z`,
    so the sprite rasters order overlaps by spawn order."""
    rows = []
    cw = size or font.char_w
    ch_h = font.char_h * (cw / font.char_w)
    if max_width is not None:
        lines = wrap_lines(text, max(1, int(max_width // cw)))
        box_w = float(max_width)
    else:
        lines = text.split("\n")
        box_w = max(len(line) * cw for line in lines) if lines else 0.0
    y = float(pos[1])
    for line in lines:
        slack = box_w - len(line) * cw
        x = float(pos[0]) + {"left": 0.0, "center": slack / 2,
                             "right": slack}[justify]
        for ch in line:
            if ch != " " and ch in font.handles:
                h = font.handles[ch]
                gx, gy = x + cw / 2, y - ch_h / 2
                rows.append(world.spawn(
                    Sprite(size=(cw, ch_h), color=color, uv_min=h["uv_min"],
                           uv_max=h["uv_max"], tex=h["tex"]),
                    Transform(translation=(gx, gy, z)),
                    GlobalTransform(translation=(gx, gy, z))))
            x += cw
        y -= ch_h * 1.2
    return rows


@component
class DigitText:
    """One digit slot of a device-side counter: shows digit `slot` of the
    value in the `source` resource field (the value read as int32)."""
    slot = field((), torch.int32)       # 0 = least significant
    num_slots = field((), torch.int32, default=5)


def make_digit_system(font: FontAtlas, source_res: str, source_field: str):
    """Updates the DigitText sprites' uv rects from a numeric resource:
    digit = value // 10**slot % 10 in int32, and alpha 0 above the top
    significant digit (slot 0 always shows). The ten glyphs' uv table is
    made on the world's device at the first run."""
    uv0 = np.stack([font.handles[str(d)]["uv_min"] for d in range(10)])
    uv1 = np.stack([font.handles[str(d)]["uv_max"] for d in range(10)])
    tex = font.handles["0"]["tex"]
    tables = {}                          # device -> (uv0, uv1)

    @system(name=f"digit_text_{source_res}_{source_field}")
    def digit_text(q=Query(Sprite, DigitText), src=Res(source_res)):
        raw = torch.as_tensor(getattr(src, source_field))
        dev = raw.device
        if dev not in tables:
            tables[dev] = (torch.tensor(uv0, dtype=torch.float32, device=dev),
                           torch.tensor(uv1, dtype=torch.float32, device=dev))
        t0, t1 = tables[dev]
        value = torch.clamp(raw.to(torch.int32), min=0)   # truncates
        slot = q.digit_text.slot
        p = 10 ** slot
        digit = (value // p % 10).long()
        # leading-zero blanking: alpha 0 above the top significant digit
        show = (slot == 0) | (value >= p)
        q.sprite.uv_min = t0[digit]
        q.sprite.uv_max = t1[digit]
        q.sprite.tex = torch.full_like(q.sprite.tex, tex)
        c = q.sprite.color
        q.sprite.color = torch.cat([c[:, :3], show.to(torch.float32)[:, None]],
                                   1)

    return digit_text


def spawn_digit_counter(world, font: FontAtlas, num_digits=5, pos=(0.0, 0.0),
                        z=10.0, color=(1.0, 1.0, 1.0, 1.0), size=None):
    """Fixed digit slots, the most significant on the left."""
    cw = size or font.char_w
    ch_h = cw * font.char_h / font.char_w
    rows = []
    for i in range(num_digits):
        slot = num_digits - 1 - i
        x = pos[0] + i * cw + cw / 2
        rows.append(world.spawn(
            Sprite(size=(cw, ch_h), color=color),
            DigitText(slot=slot, num_slots=num_digits),
            Transform(translation=(x, pos[1] - ch_h / 2, z)),
            GlobalTransform(translation=(x, pos[1] - ch_h / 2, z))))
    return rows
