"""Writes bevy_tpu_torch/render/default_font.npz: the glyph table of the
JAX package's default FontAtlas (PIL's `ImageFont.load_default()`, baked
monospace), which bevy_tpu_torch's FontAtlas reads instead of PIL.

For each of the 95 printable ASCII characters (32-126) the table holds
the glyph's bitmap before the atlas scale (PIL's 8-bit coverage, h x w,
each at least 1 x 1), read back from a JAX `FontAtlas(builder, scale=1)`;
and the font's line metrics (ascent, descent) from PIL. The port scales
the bitmaps itself, so `FontAtlas(builder, scale=k)` packs what JAX's
packs, bit for bit (tests/test_torch_text.py holds the two atlases equal).

    python tests/make_torch_font.py

Run it again only where PIL's default font changes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bevy_tpu.render.text import ASCII_END, ASCII_START, FontAtlas  # noqa: E402
from bevy_tpu.render.texture import AtlasBuilder  # noqa: E402

OUT = ROOT / "bevy_tpu_torch" / "render" / "default_font.npz"


def main():
    builder = AtlasBuilder(512, 512)
    font = FontAtlas(builder, scale=1)
    if font.proportional or font._font is not None:
        raise SystemExit("the default font baked proportional: not the "
                         "monospace table this file stores")
    ascent, descent = font._pil.getmetrics()
    codes, sizes, bitmaps = [], [], []
    for code in range(ASCII_START, ASCII_END):
        h = font.handles[chr(code)]
        w, hh = (int(v) for v in h["size"])
        x = round(h["uv_min"][0] * builder.width)
        y = round(h["uv_min"][1] * builder.height)
        alpha = builder.data[y:y + hh, x:x + w, 3]
        u8 = np.rint(alpha * 255.0).astype(np.uint8)
        if not np.array_equal(u8.astype(np.float32) / 255.0, alpha):
            raise SystemExit(f"glyph {chr(code)!r}: coverage is not k/255")
        if font.advances[chr(code)] != float(w):
            raise SystemExit(f"glyph {chr(code)!r}: advance != width")
        codes.append(code)
        sizes.append((hh, w))
        bitmaps.append(u8.ravel())
    offsets = np.cumsum([0] + [b.size for b in bitmaps]).astype(np.int32)
    np.savez_compressed(
        OUT, codes=np.asarray(codes, np.int32),
        sizes=np.asarray(sizes, np.int32), offsets=offsets,
        alpha=np.concatenate(bitmaps),
        metrics=np.asarray([ascent, descent], np.int32))
    print(f"wrote {OUT.relative_to(ROOT)}: {len(codes)} glyphs, "
          f"{offsets[-1]} coverage bytes, ascent {ascent}, descent "
          f"{descent}")


if __name__ == "__main__":
    main()
