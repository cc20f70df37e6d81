"""Text in bevy_tpu_torch (render/text.py, render/rich_text.py) against the
JAX package, on the CPU.

- The stored default font (bevy_tpu_torch/render/default_font.npz, written
  by tests/make_torch_font.py) builds an atlas bit-equal to the JAX
  FontAtlas's (PIL's default font): the same handles, advances, char_w,
  char_h, ascent and atlas texels, at scale 2 and 1.
- The UAX #9 pass, line_reset, visual_order, mirror and arabic_join equal
  JAX's on the strings of tests/test_rich_text.py, and layout_rich places
  the same glyphs at the same positions.
- The text2d twin's frame against examples/text2d.py's, and
  torch_scenes.text_world (a DigitText counter over the frame count; rich
  text with mixed span sizes, wrap, a long-word split, justify="center"
  and a Hebrew word without glyphs) after 12 frames. On CPU the JAX
  sprite pass takes its XLA raster, the port B4's plain version, both in
  f32: at most 1 sRGB step (measured: text2d 1, at 8 pixels; text_world
  0). The counter's sprite columns are equal.
"""

import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402
from bevy_tpu.render import rich_text as jrich  # noqa: E402
from bevy_tpu_torch.render import rich_text as prich  # noqa: E402
from bevy_tpu_torch.render import text as ptext  # noqa: E402
from bevy_tpu_torch.render.texture import AtlasBuilder  # noqa: E402

DT = 1 / 60
HEB = ts.HEB
ARA = "بسم"                    # beh-seen-meem
# the strings of tests/test_rich_text.py
STRINGS = ["hello", HEB, "ab " + HEB + " cd", HEB + " 123 " + HEB,
           "abc " + HEB + "  ", ARA, "لا", "بلا",
           "ربا", "بَس", "plain ascii",
           "(" + HEB + ")", "x [1.5 + " + ARA + "] -> %"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the suite runs six
    workers on one machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8_diff(a, b):
    return np.abs(a.astype(int) - b.astype(int)).max(-1)


def _jax_modules():
    return {k: importlib.import_module(f"bevy_tpu{v}")
            for k, v in ts.SCENE_MODULES.items()}


@pytest.mark.parametrize("scale", [2, 1])
def test_stored_font_builds_the_jax_atlas(scale):
    from bevy_tpu.render.text import FontAtlas as JaxFontAtlas
    from bevy_tpu.render.texture import AtlasBuilder as JaxAtlasBuilder

    jb, pb = JaxAtlasBuilder(512, 512), AtlasBuilder(512, 512)
    jf, pf = JaxFontAtlas(jb, scale=scale), ptext.FontAtlas(pb, scale=scale)
    assert pf.handles == jf.handles
    assert pf.advances == jf.advances
    assert pf.bearings == jf.bearings
    assert (pf.char_w, pf.char_h, pf.ascent) == \
        (jf.char_w, jf.char_h, jf.ascent)
    assert pf.proportional is jf.proportional is False
    assert np.array_equal(pb.data.view(np.int32), jb.data.view(np.int32))
    if scale == 2:
        assert (pf.char_w, pf.char_h) == (18.0, 13.0)
        assert pf.handles["M"]["size"] == (18.0, 20.0)
    for s in ("Hello, world", "a b", "été"):
        assert pf.measure(s) == jf.measure(s)


def test_outside_the_default_font_names_a6c():
    pf = ptext.FontAtlas(AtlasBuilder(512, 512))
    assert pf.has("A") and not pf.has("é")
    for call in (lambda: ptext.FontAtlas(AtlasBuilder(8, 8), path="x.ttf"),
                 lambda: ptext.FontAtlas(AtlasBuilder(8, 8), size=20),
                 lambda: pf.glyph("é"),
                 lambda: ptext.shape_run(None, "x", "x.ttf")):
        with pytest.raises(NotImplementedError, match="A6c"):
            call()


@pytest.mark.parametrize("text", STRINGS)
def test_bidi_and_joining_match_jax(text):
    lv, base = prich.bidi_levels(text)
    assert (lv, base) == jrich.bidi_levels(text)
    reset = prich.line_reset(text, lv, base)
    assert reset == jrich.line_reset(text, lv, base)
    assert prich.visual_order(reset) == jrich.visual_order(reset)
    for level in (0, 1):
        assert [prich.mirror(c, level) for c in text] == \
            [jrich.mirror(c, level) for c in text]
    assert prich.arabic_join(text) == jrich.arabic_join(text)


def test_wrap_matches_jax():
    from bevy_tpu.render import text as jtext

    text = "wrapped paragraph: the quick brown fox\nsupercalifragilistic x"
    for n in (1, 4, 9, 30):
        assert ptext.wrap_lines(text, n) == jtext.wrap_lines(text, n)
    measure = ptext.FontAtlas(AtlasBuilder(512, 512)).measure
    for w in (20.0, 75.0, 200.0):
        assert ptext.wrap_lines_measured(text, w, measure) == \
            jtext.wrap_lines_measured(text, w, measure)


@pytest.mark.parametrize("max_width,justify", [(None, "left"),
                                               (150.0, "center"),
                                               (90.0, "right")])
def test_layout_rich_matches_jax(max_width, justify):
    from bevy_tpu.render.text import FontAtlas as JaxFontAtlas
    from bevy_tpu.render.texture import AtlasBuilder as JaxAtlasBuilder

    out = []
    for rich, font in ((jrich, JaxFontAtlas(JaxAtlasBuilder(512, 512))),
                       (prich, ptext.FontAtlas(AtlasBuilder(512, 512)))):
        spans = [rich.TextSpan("Big ", size=26.0),
                 rich.TextSpan("mixed " + HEB + " and 42 ", size=13.0),
                 rich.TextSpan("unbreakablewordsplit\nnext " + ARA,
                               size=9.75, color=(0.5, 0.8, 1.0, 1.0))]
        glyphs, w, h = rich.layout_rich(spans, font, max_width=max_width,
                                        justify=justify)
        out.append(([(g.ch, g.k, g.color, g.x, g.y, g.adv, g.level)
                     for g in glyphs], w, h))
    assert out[0] == out[1]


@pytest.fixture(scope="module")
def jax_text2d_frame():
    import text2d
    from bevy_tpu.render.plugin import frame_image

    app = text2d.build_app()
    app.update(dt=DT)
    return frame_image(app)


def test_torch_text2d_matches_jax(jax_text2d_frame):
    import torch_text2d
    from bevy_tpu_torch.render.plugin import frame_image

    app = torch_text2d.build_app(device="cpu")
    app.update(dt=DT)
    img = frame_image(app)
    assert _u8_diff(img, jax_text2d_frame).max() <= 1
    assert (img[..., :3] != img[0, 0, :3]).any(-1).mean() > 0.05  # drawn


def test_digits_and_rich_text_match_jax():
    """12 frames of text_world: the frame count 12 on the counter (its
    two top slots blanked), the same image and sprite columns."""
    jm, pm = _jax_modules(), ts.port_scene_modules()
    japp = ts.text_world(jm, {})
    papp = ts.text_world(pm, {"device": "cpu"})
    for app in (japp, papp):
        app.run(max_frames=12, dt=DT)
    jimg, pimg = jm["plug"].frame_image(japp), pm["plug"].frame_image(papp)
    assert _u8_diff(pimg, jimg).max() <= 1
    jstate = jax.device_get(japp.world.state)
    for f in ("uv_min", "uv_max", "color", "tex"):
        assert np.array_equal(
            papp.world.state["comp"]["sprite"]["f"][f].numpy(),
            jstate["comp"]["sprite"]["f"][f]), f
    rows = papp.world.query_rows(pm["text"].DigitText)
    slots = papp.world.state["comp"]["digit_text"]["f"]["slot"][rows]
    alpha = papp.world.state["comp"]["sprite"]["f"]["color"][rows, 3]
    assert slots.tolist() == [3, 2, 1, 0]
    assert alpha.tolist() == [0.0, 0.0, 1.0, 1.0]
