"""Owned rich-text layout (port of bevy_tpu/render/rich_text.py, a copy of
its host code; ref: bevy_text/src/pipeline.rs + parley_context.rs — the
parley shaping / layout stack, owned in-engine): multi-style spans,
font-fallback chains, UAX #9 bidirectional paragraph ordering and Arabic
contextual joining.

Layout runs on the host (as the reference's text pipeline runs on the CPU
and uploads glyph quads); its output is glyph sprites in the packed
atlas, drawn by the same sprite kernels as every other sprite.

Bidi subset: the implicit algorithm — P2/P3 paragraph level, weak rules
W1–W7, neutral rules N1–N2, implicit levels I1–I2, line rules L1/L2 and
mirroring L4. Explicit directional embeddings / overrides / isolates
(LRE/RLE/LRO/RLO/PDF/LRI/RLI/FSI/PDI) are stripped as BN; the implicit
marks LRM/RLM work (they are strong L/R).

The OpenType stage (`_apply_opentype`: GSUB ligatures, GPOS mark
attachment) keeps its hook: `shaping_tables` returns None for a font
without a file, which every font of this package is (the default font,
render/text.py), so the stage passes glyphs through. Glyphs the chain's
fonts lack lay out with the first font's char_w and are not spawned, as
in the JAX package; baking them (the TrueType fallback chain) is ROADMAP
A6c.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional, Sequence

from bevy_tpu_torch.render.sprite import Sprite
from bevy_tpu_torch.transform import GlobalTransform, Transform


def shaping_tables(font):
    """The GSUB / GPOS tables of a file font (the JAX package's
    render/opentype.py); None for a font without a path."""
    if getattr(font, "_path", None) is None:
        return None
    raise NotImplementedError(
        "OpenType shaping tables are not ported to bevy_tpu_torch yet "
        "(ROADMAP A6c)")


def px_per_unit(font) -> float:
    """Font-unit -> pixel scale of a file font (it needs the font's
    tables; 0.0 without them, as the JAX package's)."""
    shaping_tables(font)
    return 0.0


# ---------------------------------------------------------------------------
# UAX #9 — implicit bidirectional algorithm over unicodedata classes
# ---------------------------------------------------------------------------

_EXPLICIT = {"LRE", "RLE", "LRO", "RLO", "PDF", "LRI", "RLI", "FSI", "PDI"}
_NEUTRAL = {"B", "S", "WS", "ON", "BN"}


def _classes(text: str) -> List[str]:
    out = []
    for ch in text:
        c = unicodedata.bidirectional(ch) or "L"
        out.append("BN" if c in _EXPLICIT else c)
    return out


def paragraph_level(text: str) -> int:
    """P2/P3: level of the first strong character (AL/R → 1)."""
    for c in _classes(text):
        if c == "L":
            return 0
        if c in ("R", "AL"):
            return 1
    return 0


def bidi_levels(text: str, base: Optional[int] = None):
    """Resolved embedding level per character (UAX #9 implicit path).
    Returns (levels, base_level)."""
    n = len(text)
    if base is None:
        base = paragraph_level(text)
    cls = _classes(text)
    if n == 0:
        return [], base
    sos = "L" if base % 2 == 0 else "R"

    # W1: NSM takes the class of the previous character (sos at start)
    prev = sos
    for i in range(n):
        if cls[i] == "NSM":
            cls[i] = prev
        if cls[i] != "BN":
            prev = cls[i]

    # W2: EN → AN when the last strong type was AL
    strong = sos
    for i in range(n):
        if cls[i] in ("L", "R", "AL"):
            strong = cls[i]
        elif cls[i] == "EN" and strong == "AL":
            cls[i] = "AN"

    # W3: AL → R
    cls = ["R" if c == "AL" else c for c in cls]

    # W4: single separator between two numbers of the same kind joins them
    for i in range(1, n - 1):
        if cls[i] == "ES" and cls[i - 1] == "EN" and cls[i + 1] == "EN":
            cls[i] = "EN"
        elif cls[i] == "CS" and cls[i - 1] == cls[i + 1] and \
                cls[i - 1] in ("EN", "AN"):
            cls[i] = cls[i - 1]

    # W5: runs of ET adjacent to EN become EN
    i = 0
    while i < n:
        if cls[i] == "ET":
            j = i
            while j < n and cls[j] == "ET":
                j += 1
            before = cls[i - 1] if i > 0 else sos
            after = cls[j] if j < n else sos
            if before == "EN" or after == "EN":
                for k in range(i, j):
                    cls[k] = "EN"
            i = j
        else:
            i += 1

    # W6: stray separators/terminators are neutral
    cls = ["ON" if c in ("ET", "ES", "CS") else c for c in cls]

    # W7: EN → L when the last strong type was L
    strong = sos
    for i in range(n):
        if cls[i] in ("L", "R"):
            strong = cls[i]
        elif cls[i] == "EN" and strong == "L":
            cls[i] = "L"

    # N1/N2: neutral runs take the surrounding direction when it matches
    # on both sides (EN/AN count as R), else the base direction
    def _dir(c):
        return "R" if c in ("R", "EN", "AN") else ("L" if c == "L" else None)

    i = 0
    while i < n:
        if cls[i] in _NEUTRAL:
            j = i
            while j < n and cls[j] in _NEUTRAL:
                j += 1
            before = _dir(cls[i - 1]) if i > 0 else sos
            after = _dir(cls[j]) if j < n else sos
            pick = before if (before == after and before) else \
                ("L" if base % 2 == 0 else "R")
            for k in range(i, j):
                cls[k] = pick
            i = j
        else:
            i += 1

    # I1/I2: implicit level assignment
    levels = []
    for c in cls:
        lv = base
        if base % 2 == 0:
            if c == "R":
                lv = base + 1
            elif c in ("AN", "EN"):
                lv = base + 2
        else:
            if c in ("L", "AN", "EN"):
                lv = base + 1
        levels.append(lv)
    return levels, base


def line_reset(text: str, levels: List[int], base: int) -> List[int]:
    """L1: segment separators and trailing whitespace revert to the
    paragraph level."""
    out = list(levels)
    for i, ch in enumerate(text):
        if unicodedata.bidirectional(ch) in ("S", "B"):
            out[i] = base
    i = len(text)
    while i > 0 and unicodedata.bidirectional(text[i - 1]) in ("WS", "S",
                                                               "B"):
        out[i - 1] = base
        i -= 1
    return out


def visual_order(levels: Sequence[int]) -> List[int]:
    """L2: reverse contiguous runs from the highest level down to the
    lowest odd level. Returns logical indices in visual order."""
    order = list(range(len(levels)))
    if not levels:
        return order
    hi = max(levels)
    lo = min(lv | 1 for lv in levels)
    for lv in range(hi, lo - 1, -1):
        i = 0
        while i < len(levels):
            if levels[order[i]] >= lv:
                j = i
                while j < len(levels) and levels[order[j]] >= lv:
                    j += 1
                order[i:j] = order[i:j][::-1]
                i = j
            else:
                i += 1
    return order


_MIRROR = {"(": ")", ")": "(", "[": "]", "]": "[", "{": "}", "}": "{",
           "<": ">", ">": "<", "«": "»", "»": "«", "‹": "›", "›": "‹",
           "⟨": "⟩", "⟩": "⟨"}


def mirror(ch: str, level: int) -> str:
    """L4: mirrored characters swap their glyph in RTL runs."""
    if level % 2 == 1 and unicodedata.mirrored(ch):
        return _MIRROR.get(ch, ch)
    return ch


# ---------------------------------------------------------------------------
# Arabic contextual joining → presentation forms B (U+FE70–U+FEFF)
# ---------------------------------------------------------------------------
# (isolated, final, initial, medial); initial/medial None = right-joining
# (the letter never connects to the following letter).
_ARABIC_FORMS = {
    0x0621: (0xFE80, None, None, None),            # hamza
    0x0622: (0xFE81, 0xFE82, None, None),          # alef madda
    0x0623: (0xFE83, 0xFE84, None, None),          # alef hamza above
    0x0624: (0xFE85, 0xFE86, None, None),          # waw hamza
    0x0625: (0xFE87, 0xFE88, None, None),          # alef hamza below
    0x0626: (0xFE89, 0xFE8A, 0xFE8B, 0xFE8C),      # yeh hamza
    0x0627: (0xFE8D, 0xFE8E, None, None),          # alef
    0x0628: (0xFE8F, 0xFE90, 0xFE91, 0xFE92),      # beh
    0x0629: (0xFE93, 0xFE94, None, None),          # teh marbuta
    0x062A: (0xFE95, 0xFE96, 0xFE97, 0xFE98),      # teh
    0x062B: (0xFE99, 0xFE9A, 0xFE9B, 0xFE9C),      # theh
    0x062C: (0xFE9D, 0xFE9E, 0xFE9F, 0xFEA0),      # jeem
    0x062D: (0xFEA1, 0xFEA2, 0xFEA3, 0xFEA4),      # hah
    0x062E: (0xFEA5, 0xFEA6, 0xFEA7, 0xFEA8),      # khah
    0x062F: (0xFEA9, 0xFEAA, None, None),          # dal
    0x0630: (0xFEAB, 0xFEAC, None, None),          # thal
    0x0631: (0xFEAD, 0xFEAE, None, None),          # reh
    0x0632: (0xFEAF, 0xFEB0, None, None),          # zain
    0x0633: (0xFEB1, 0xFEB2, 0xFEB3, 0xFEB4),      # seen
    0x0634: (0xFEB5, 0xFEB6, 0xFEB7, 0xFEB8),      # sheen
    0x0635: (0xFEB9, 0xFEBA, 0xFEBB, 0xFEBC),      # sad
    0x0636: (0xFEBD, 0xFEBE, 0xFEBF, 0xFEC0),      # dad
    0x0637: (0xFEC1, 0xFEC2, 0xFEC3, 0xFEC4),      # tah
    0x0638: (0xFEC5, 0xFEC6, 0xFEC7, 0xFEC8),      # zah
    0x0639: (0xFEC9, 0xFECA, 0xFECB, 0xFECC),      # ain
    0x063A: (0xFECD, 0xFECE, 0xFECF, 0xFED0),      # ghain
    0x0641: (0xFED1, 0xFED2, 0xFED3, 0xFED4),      # feh
    0x0642: (0xFED5, 0xFED6, 0xFED7, 0xFED8),      # qaf
    0x0643: (0xFED9, 0xFEDA, 0xFEDB, 0xFEDC),      # kaf
    0x0644: (0xFEDD, 0xFEDE, 0xFEDF, 0xFEE0),      # lam
    0x0645: (0xFEE1, 0xFEE2, 0xFEE3, 0xFEE4),      # meem
    0x0646: (0xFEE5, 0xFEE6, 0xFEE7, 0xFEE8),      # noon
    0x0647: (0xFEE9, 0xFEEA, 0xFEEB, 0xFEEC),      # heh
    0x0648: (0xFEED, 0xFEEE, None, None),          # waw
    0x0649: (0xFEEF, 0xFEF0, None, None),          # alef maksura
    0x064A: (0xFEF1, 0xFEF2, 0xFEF3, 0xFEF4),      # yeh
}
# lam-alef mandatory ligatures: (alef codepoint) → (isolated, final)
_LAM_ALEF = {0x0622: (0xFEF5, 0xFEF6), 0x0623: (0xFEF7, 0xFEF8),
             0x0625: (0xFEF9, 0xFEFA), 0x0627: (0xFEFB, 0xFEFC)}
_TASHKEEL = set(range(0x064B, 0x0660))  # combining marks: transparent


def arabic_join(text: str) -> str:
    """Contextual joining: map Arabic base letters to their presentation
    forms (isolated/final/initial/medial) plus the mandatory lam-alef
    ligatures — the engine-owned slice of what HarfBuzz's Arabic shaper
    does. Characters outside the table pass through unchanged."""

    def joins_left(cp):   # letter connects to the FOLLOWING letter
        f = _ARABIC_FORMS.get(cp)
        return f is not None and f[2] is not None

    def joins_right(cp):  # letter connects to the PRECEDING letter
        return cp in _ARABIC_FORMS

    cps = [ord(c) for c in text]
    out: List[str] = []
    i = 0
    while i < len(cps):
        cp = cps[i]
        if cp in _TASHKEEL or cp not in _ARABIC_FORMS:
            out.append(chr(cp))
            i += 1
            continue

        def skip(j, step):
            while 0 <= j < len(cps) and cps[j] in _TASHKEEL:
                j += step
            return j

        pj = skip(i - 1, -1)
        prev_joins = pj >= 0 and joins_left(cps[pj])

        # lam-alef ligature
        nj = skip(i + 1, 1)
        if cp == 0x0644 and nj < len(cps) and cps[nj] in _LAM_ALEF:
            iso, fin = _LAM_ALEF[cps[nj]]
            out.append(chr(fin if prev_joins else iso))
            i = nj + 1
            continue

        next_joins = nj < len(cps) and joins_right(cps[nj]) and \
            joins_left(cp)
        iso, fin, ini, med = _ARABIC_FORMS[cp]
        if prev_joins and next_joins and med is not None:
            out.append(chr(med))
        elif prev_joins and fin is not None:
            out.append(chr(fin))
        elif next_joins and ini is not None:
            out.append(chr(ini))
        else:
            out.append(chr(iso))
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# Spans + layout
# ---------------------------------------------------------------------------


class TextSpan:
    """One style run (ref: bevy_text TextSpan child entities — a block's
    text is the concatenation of its spans, each with its own font, size
    and color; layout treats the block as one paragraph)."""

    def __init__(self, text: str, font=None, size: Optional[float] = None,
                 color=(1.0, 1.0, 1.0, 1.0)):
        self.text = text
        self.font = font
        self.size = size
        self.color = color


class _Glyph:
    __slots__ = ("ch", "font", "k", "color", "x", "y", "adv", "level",
                 "space", "attach", "off")

    def __init__(self, ch, font, k, color, adv, level, space):
        self.ch, self.font, self.k = ch, font, k
        self.color, self.adv, self.level = color, adv, level
        self.x = 0.0
        self.y = 0.0
        self.space = space
        # GPOS mark attachment: when set, this glyph is a combining mark
        # anchored to `attach` at pixel offset `off` (x right, y up) —
        # resolved AFTER pen placement so bidi reorder cannot break it
        self.attach = None
        self.off = (0.0, 0.0)


def _resolve_font(ch, chain):
    for f in chain:
        if f.has(ch):
            return f
    return chain[0]


def _apply_opentype(para):
    """GSUB liga + GPOS mark-to-base over one logical paragraph (ref:
    parley's shaping stage; see render/opentype.py). Ligatures collapse
    same-style runs; marks zero their advance and anchor to their base."""
    out = []
    i = 0
    while i < len(para):
        g = para[i]
        tabs = shaping_tables(g.font)
        if tabs is not None and not g.space:
            # candidate run: same font/size/color, up to 3 more glyphs
            run = [g.ch]
            j = i + 1
            while (j < len(para) and len(run) < 4 and
                   para[j].font is g.font and para[j].k == g.k and
                   para[j].color == g.color and not para[j].space):
                run.append(para[j].ch)
                j += 1
            lig = tabs.ligate("".join(run))
            if lig is not None:
                ch, consumed, adv_units = lig
                if g.font.has(ch):
                    s_px = px_per_unit(g.font)
                    ng = _Glyph(ch, g.font, g.k, g.color,
                                adv_units * s_px * g.k, g.level, False)
                    out.append(ng)
                    i += consumed
                    continue
        out.append(g)
        i += 1
    # mark attachment (after ligation; base = previous non-mark glyph)
    for idx in range(1, len(out)):
        g = out[idx]
        tabs = shaping_tables(g.font)
        if tabs is None or not tabs.is_mark(g.ch):
            continue
        b = idx - 1
        while b >= 0 and out[b].attach is not None:
            b -= 1                       # chains anchor to the real base
        if b < 0 or out[b].font is not g.font:
            continue
        off = tabs.mark_offset(out[b].ch, g.ch)
        if off is None:
            continue
        s_px = px_per_unit(g.font)
        g.attach = out[b]
        g.off = (off[0] * s_px * g.k, off[1] * s_px * g.k)
        g.adv = 0.0
    return out


def layout_rich(spans: Sequence[TextSpan], default_font,
                fallbacks: Sequence = (), max_width: Optional[float] = None,
                justify: str = "left", line_gap: float = 1.2,
                shape_arabic: bool = True):
    """Lay out styled spans as one paragraph block. Returns
    (glyphs, width, height) where each glyph carries ch/font/k/color and
    a baseline-relative (x, y) position; (0,0) is the block's top-left.

    Pipeline (the parley stages, owned): span concat → Arabic joining →
    per-paragraph UAX#9 levels → measured word wrap (logical order) →
    L1 reset + L2 visual reorder + L4 mirroring per line → pen placement
    with per-glyph font fallback."""
    # 1. flatten spans into (ch, style) records, shaping Arabic per span
    recs = []  # (ch, chain, k, color)
    for sp in spans:
        font = sp.font or default_font
        chain = [font] + [f for f in fallbacks if f is not font]
        k = (sp.size / font.char_h) if sp.size else 1.0
        text = arabic_join(sp.text) if shape_arabic else sp.text
        for ch in text:
            recs.append((ch, chain, k, sp.color))
    if not recs:
        return [], 0.0, 0.0

    # 2. paragraph split + bidi levels over the logical text
    glyphs: List[_Glyph] = []
    para: List[_Glyph] = []
    paras: List[List[_Glyph]] = []
    for ch, chain, k, color in recs:
        if ch == "\n":
            paras.append(para)
            para = []
            continue
        font = _resolve_font(ch, chain)
        adv = font.advances.get(ch)
        if adv is None and font.has(ch):
            font.glyph(ch)
            adv = font.advances[ch]
        elif adv is None:
            adv = font.char_w
        para.append(_Glyph(ch, font, k, color, adv * k, 0, ch == " "))
    paras.append(para)
    paras = [_apply_opentype(p) for p in paras]

    lines: List[tuple] = []  # (visual glyph list, base, line_w, ascent, h)
    for para in paras:
        text = "".join(g.ch for g in para)
        levels, base = bidi_levels(text)
        for g, lv in zip(para, levels):
            g.level = lv

        # 3. measured word wrap in LOGICAL order (UAX#9 wraps logically,
        # then reorders per line)
        if max_width is None:
            chunks = [para]
        else:
            chunks = []
            cur: List[_Glyph] = []
            cur_w = 0.0
            word: List[_Glyph] = []
            word_w = 0.0

            def flush_word():
                nonlocal cur, cur_w, word, word_w
                if cur and cur_w + word_w > max_width:
                    chunks.append(cur)
                    cur, cur_w = [], 0.0
                while word_w > max_width and len(word) > 1:
                    # unbreakable long word: hard split
                    acc, aw = [], 0.0
                    for g in word:
                        if acc and aw + g.adv > max_width:
                            break
                        acc.append(g)
                        aw += g.adv
                    chunks.append(acc)
                    word = word[len(acc):]
                    word_w -= aw
                cur.extend(word)
                cur_w += word_w
                word, word_w = [], 0.0

            for g in para:
                if g.space:
                    flush_word()
                    cur.append(g)
                    cur_w += g.adv
                else:
                    word.append(g)
                    word_w += g.adv
            flush_word()
            chunks.append(cur)

        for line in chunks:
            ltext = "".join(g.ch for g in line)
            llv = line_reset(ltext, [g.level for g in line], base)
            order = visual_order(llv)
            vis = [line[i] for i in order]
            for g, lv in zip(line, llv):
                g.level = lv
            trail = len(line)
            while trail > 0 and line[trail - 1].space:
                trail -= 1
            w = sum(g.adv for g in line[:trail])
            asc = max((g.font.ascent * g.k for g in line),
                      default=default_font.ascent)
            h = max((g.font.char_h * g.k for g in line),
                    default=default_font.char_h)
            lines.append((vis, base, w, asc, h))

    # 4. pen placement
    box_w = max_width if max_width is not None else \
        max((w for _, _, w, _, _ in lines), default=0.0)
    y = 0.0
    for vis, base, w, asc, h in lines:
        slack = max(box_w - w, 0.0)
        if justify == "center":
            x = slack / 2
        elif justify == "right":
            x = slack
        else:  # left — an RTL paragraph naturally right-aligns (ref:
            # JustifyText honors the paragraph direction)
            x = slack if base % 2 == 1 and justify == "left" else 0.0
        for g in vis:
            g.ch = mirror(g.ch, g.level)
            g.x = x
            g.y = y + asc
            x += g.adv
        for g in vis:
            if g.attach is not None:     # GPOS anchors win over the pen
                g.x = g.attach.x + g.off[0]
        y += h * line_gap
        glyphs.extend(vis)
    return [g for g in glyphs if not g.space], box_w, y


def spawn_rich_text(world, spans, default_font, pos=(0.0, 0.0), z=10.0,
                    fallbacks=(), max_width=None, justify="left",
                    line_gap=1.2):
    """Spawn a rich block as glyph sprites (the rich counterpart of
    spawn_text; ref: bevy_text's extracted glyph quads). Returns
    (rows, placed_glyphs)."""
    glyphs, _, _ = layout_rich(spans, default_font, fallbacks=fallbacks,
                               max_width=max_width, justify=justify,
                               line_gap=line_gap)
    rows = []
    for g in glyphs:
        if not g.font.has(g.ch):
            continue
        h = g.font.glyph(g.ch)
        gw, gh = h["size"][0] * g.k, h["size"][1] * g.k
        bx, by = g.font.bearings.get(g.ch, (0.0, 0.0))
        gx = pos[0] + g.x + bx * g.k + gw / 2
        # g.y is the baseline distance below the block top; PIL bearings
        # are measured from the top of the font's em box, which sits
        # ascent*k above the baseline (mixed sizes share the baseline)
        gy = pos[1] - g.y + g.font.ascent * g.k - by * g.k - gh / 2
        if g.attach is not None:
            gy += g.off[1]               # anchor dy, y-up
        rows.append(world.spawn(
            Sprite(size=(gw, gh), color=g.color, uv_min=h["uv_min"],
                   uv_max=h["uv_max"], tex=h["tex"]),
            Transform(translation=(gx, gy, z)),
            GlobalTransform(translation=(gx, gy, z))))
    return rows, glyphs
