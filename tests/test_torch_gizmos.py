"""Gizmos in bevy_tpu_torch (render/gizmos.py, render/stroke_font.py)
against the JAX package, on the CPU.

- The merge: a system's batches (single segments, a batch past its
  budget, a masked batch, per-row colours and widths, appends past the
  buffer's capacity) give the JAX merge's buffer rows, count and drops
  exactly; the port writes them with one index_copy_ a field, JAX one
  scatter a batch.
- The kernel path: the gizmo pass's packed quads (torch_scenes.
  gizmo_world) through the JAX Pallas kernel `raster_sprites_pallas(
  interpret=True)` and through the port's B4 (`bin_sprites` +
  `sprite_tiles`, its plain version on the CPU): bit for bit. (On the CPU
  the JAX gizmo pass itself takes the XLA raster.)
- The 2d_gizmos twin's frame against examples/2d_gizmos.py's, and
  gizmo_world (2D, 3D and retained gizmos, 2D and 3D stroke text): at
  most 1 sRGB step (measured 0 in both).
- The stroke font's table and layout equal JAX's.
"""

import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402
from bevy_tpu.render import gizmos as jgz  # noqa: E402
from bevy_tpu_torch.render import gizmos as pgz  # noqa: E402

DT = 1 / 60
CAP = 40
FIELDS = ("a", "b", "color", "width", "is3d")


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


def _batches(seed):
    """Host inputs of one system's appends, in append order: (method, a,
    b, color, width) and, for the masked batch, (is3d, valid) rows. A
    batch with a colour (or width) a row keeps at most the budget's rows
    (JAX broadcasts the colours to the rows it keeps)."""
    rng = np.random.RandomState(seed)

    def f32(*shape):
        return rng.uniform(-50, 50, shape).astype(np.float32)

    return [
        ("line_2d", f32(2), f32(2), (1.0, 0.5, 0.25, 1.0), 2.0),
        ("line", f32(10, 3), f32(10, 3), (0.2, 0.4, 0.6, 0.8), 1.5),
        ("masked", f32(6, 3), f32(6, 3),
         rng.uniform(0, 1, (6, 4)).astype(np.float32),
         rng.uniform(1, 4, 6).astype(np.float32),
         rng.uniform(size=6) < 0.5, rng.uniform(size=6) < 0.6),
        ("line_2d", f32(5, 2), f32(5, 2),
         rng.uniform(0, 1, (5, 4)).astype(np.float32), 3.0),
        ("line", f32(3), f32(3), (1.0, 1.0, 1.0, 1.0), 2.5),
        ("line_2d", f32(9, 2), f32(9, 2), (0.0, 1.0, 0.0, 1.0), 1.0),
    ]


def _merge(pkg, store, batches, budget):
    """Run one system's appends through `pkg`'s GizmosView (the masked
    batch as draw_retained_gizmos appends it) and merge."""
    conv = jnp.asarray if pkg is jgz else torch.tensor
    view = pkg.GizmosView(pkg.Gizmos(budget=budget), store)
    for method, a, b, color, width, *masked in batches:
        if method == "masked":
            view._segments.append((conv(a), conv(b), conv(color),
                                   conv(width), conv(masked[0]),
                                   conv(masked[1])))
        else:
            getattr(view, method)(conv(a), conv(b), color, width)
    return view.merge({"res": {pkg.GIZMO_RES: store}}, 0)["res"][
        pkg.GIZMO_RES]


def _store(pkg, count, seed=0):
    rng = np.random.RandomState(seed)
    init = {"a": rng.uniform(size=(CAP, 3)), "b": rng.uniform(size=(CAP, 3)),
            "color": rng.uniform(size=(CAP, 4)), "width": rng.uniform(size=CAP)}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    init["is3d"] = rng.uniform(size=CAP) < 0.5
    if pkg is jgz:
        out = {k: jnp.asarray(v) for k, v in init.items()}
        out["count"] = jnp.asarray(count, jnp.int32)
    else:
        out = {k: torch.tensor(v) for k, v in init.items()}
        out["count"] = torch.tensor(count, dtype=torch.int32)
    return out


@pytest.mark.parametrize("count,budget", [(0, 256), (3, 8), (17, 6),
                                          (CAP - 2, 256), (CAP, 256)])
def test_gizmo_merge_matches_jax(count, budget):
    """Rows from `count` on, each batch cut to `budget` rows (the masked
    one keeps its valid rows among those), the rest dropped at CAP; twice
    in a row (a second system's merge on the first's buffer)."""
    jstore, pstore = _store(jgz, count), _store(pgz, count)
    for seed in (1, 2):
        batches = _batches(seed)
        jstore = _merge(jgz, jstore, batches, budget)
        pstore = _merge(pgz, pstore, batches, budget)
        assert int(pstore["count"]) == int(jstore["count"])
        assert pstore["count"].dtype == torch.int32
        for f in FIELDS:
            j, p = np.asarray(jstore[f]), pstore[f].numpy()
            assert p.shape == j.shape and p.dtype == j.dtype, f
            assert np.array_equal(p, j), (f, seed)
    assert int(pstore["count"]) <= CAP


def test_stroke_font_matches_jax():
    from bevy_tpu.render import stroke_font as jsf
    from bevy_tpu_torch.render import stroke_font as psf

    assert psf.GLYPHS == jsf.GLYPHS
    for text in ("Gizmo 2D 42", "multi\nline ?~", ""):
        for size in (1.0, 12.0):
            assert psf.layout(text, size) == jsf.layout(text, size)
            assert psf.measure(text, size) == jsf.measure(text, size)


def test_gizmo_quads_through_pallas_bit_equal():
    """gizmo_world's second frame: the packed quads the gizmo pass hands
    B4 (rotated solid quads, z = lane) and the frame it draws them over,
    through the JAX Pallas kernel in interpret mode and the port's B4."""
    from bevy_tpu.ops.raster2d_pallas import raster_sprites_pallas

    seen = {}
    bin_sprites, sprite_tiles = pgz.bin_sprites, pgz.sprite_tiles

    def keep_packed(packed, *a, **kw):
        seen["packed"] = packed
        return bin_sprites(packed, *a, **kw)

    def keep_frame(fb, *a, **kw):
        seen["fb"] = fb.clone()
        seen["out"] = sprite_tiles(fb, *a, **kw)
        return seen["out"]

    pgz.bin_sprites, pgz.sprite_tiles = keep_packed, keep_frame
    try:
        app = ts.gizmo_world(ts.port_scene_modules(), {"device": "cpu"})
        app.run(max_frames=2, dt=DT)
    finally:
        pgz.bin_sprites, pgz.sprite_tiles = bin_sprites, sprite_tiles
    packed = seen["packed"]
    assert int(packed[:, 16].sum()) > 150              # visible segments
    out, st = raster_sprites_pallas(
        jnp.asarray(seen["fb"].numpy()), jnp.asarray(packed.numpy()),
        jnp.ones((4, 1, 1), jnp.float32), interpret=True)
    assert {k: int(v) for k, v in st.items()} == {
        "pair_overflow": 0, "tile_overflow": 0, "visible_overflow": 0}
    port = seen["out"].numpy()
    assert np.array_equal(np.asarray(out).view(np.int32),
                          port.view(np.int32))
    assert not np.array_equal(port, seen["fb"].numpy())


@pytest.fixture(scope="module")
def jax_2d_gizmos_frame():
    import importlib as il

    from bevy_tpu.render.plugin import frame_image

    app = il.import_module("2d_gizmos").build_app()
    app.run(max_frames=3, dt=DT)
    return frame_image(app)


def test_torch_2d_gizmos_matches_jax(jax_2d_gizmos_frame):
    import torch_2d_gizmos
    from bevy_tpu_torch.render.plugin import frame_image

    app = torch_2d_gizmos.build_app(device="cpu")
    app.run(max_frames=3, dt=DT)
    img = frame_image(app)
    assert _u8_diff(img, jax_2d_gizmos_frame).max() <= 1
    assert (img[..., :3] != img[0, 0, :3]).any(-1).mean() > 0.01
    stats = {k: int(v) for k, v in
             app.world.state["res"]["render_stats"].items()}
    assert stats["gizmo_pair_overflow"] == stats["gizmo_tile_overflow"] == 0
    # the buffer cleared after the overlay; 36 + 4 + 3 + 7 + 1 appended
    assert int(app.world.state["res"]["gizmo_lines"]["count"]) == 0


def test_gizmo_world_matches_jax():
    """2 frames of gizmo_world: 2D, 3D (through the Camera3d) and retained
    gizmos with stroke text. The buffer keeps the last frame's rows after
    its count clears: the same count of rows, the same values (the 2D and
    3D shapes' arithmetic, on the CPU in the port and in XLA in JAX,
    rounds alike to 1e-5)."""
    jm = {k: importlib.import_module(f"bevy_tpu{v}")
          for k, v in ts.SCENE_MODULES.items()}
    pm = ts.port_scene_modules()
    japp, papp = ts.gizmo_world(jm, {}), ts.gizmo_world(pm, {"device": "cpu"})
    for app in (japp, papp):
        app.run(max_frames=2, dt=DT)
    jimg, pimg = jm["plug"].frame_image(japp), pm["plug"].frame_image(papp)
    assert _u8_diff(pimg, jimg).max() <= 1
    assert (pimg[..., :3] != pimg[0, 0, :3]).any(-1).mean() > 0.05
    jbuf = japp.world.state["res"]["gizmo_lines"]
    pbuf = papp.world.state["res"]["gizmo_lines"]
    for f in FIELDS:
        np.testing.assert_allclose(pbuf[f].numpy(), np.asarray(jbuf[f]),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert int(pbuf["count"]) == int(jbuf["count"]) == 0
