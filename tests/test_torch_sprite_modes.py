"""The rest of the 2D sprite pass in bevy_tpu_torch (render/sprite.py,
render/camera.py) against the JAX package, on the CPU: sprite-sheet
animation, 9-slice and tiled sprites, and 2D split-screen.

- sprite_sheet: the twin's frame after 5 frames of 0.1 s (the sheet's
  counter wraps) against examples/sprite_sheet.py's, with the
  AtlasAnimation frame counter and the sprite's uv rect equal (the frame
  advance rounds once, as XLA's fused multiply-add on the CPU).
- torch_scenes.slice_world: spawn_sliced (one border, four borders) and
  spawn_tiled (natural size; scale 1.5, cropped edges) spawn the same rows
  and draw the same frame.
- split_screen_2d at 640x360 (two cameras, `max_cameras=2`, ascending
  `order`): the twin's frame after 3 frames against the JAX example's, in
  tiles (B4) and splat (B5) mode, as built and with camera 1's viewport
  moved over camera 0's and the orders swapped; swapping the orders
  changes the overlap alone; `select_cameras` picks JAX's rows.
Images: the JAX sprite pass takes its XLA raster on the CPU, the port its
kernels' plain versions, all f32: at most 1 sRGB step (measured 0).
"""

import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402

DT = 1 / 60


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


def _stats(app):
    return {k: int(v) for k, v in
            app.world.state["res"]["render_stats"].items()}


def test_torch_sprite_sheet_matches_jax():
    import sprite_sheet
    import torch_sprite_sheet
    from bevy_tpu.render.plugin import frame_image as jax_frame_image
    from bevy_tpu_torch.render.plugin import frame_image

    japp = sprite_sheet.build_app()
    papp = torch_sprite_sheet.build_app(device="cpu")
    for app in (japp, papp):
        app.run(max_frames=5, dt=0.1)   # 12 fps: 1.2 sheet frames a step
    assert _u8_diff(frame_image(papp), jax_frame_image(japp)).max() <= 1
    jstate = jax.device_get(japp.world.state)
    for comp, f in (("atlas_animation", "frame"), ("sprite", "uv_min"),
                    ("sprite", "uv_max"), ("sprite", "tex")):
        assert np.array_equal(papp.world.state["comp"][comp]["f"][f].numpy(),
                              jstate["comp"][comp]["f"][f]), (comp, f)
    # 5 x 1.2 sheet frames: the counter wrapped past the sheet's 6 once
    row = papp.world.query_rows(torch_sprite_sheet.AtlasAnimation)[0]
    frame = float(papp.world.state["comp"]["atlas_animation"]["f"]["frame"]
                  [row])
    assert frame < 1.0 or frame > 5.9


def test_sliced_and_tiled_sprites_match_jax():
    jm = {k: importlib.import_module(f"bevy_tpu{v}")
          for k, v in ts.SCENE_MODULES.items()}
    pm = ts.port_scene_modules()
    japp, papp = ts.slice_world(jm, {}), ts.slice_world(pm, {"device": "cpu"})
    jstate = jax.device_get(japp.world.state)
    for f in ("size", "uv_min", "uv_max", "color", "tex"):
        assert np.array_equal(papp.world.state["comp"]["sprite"]["f"][f]
                              .numpy(), jstate["comp"]["sprite"]["f"][f]), f
    assert np.array_equal(
        papp.world.state["comp"]["transform"]["f"]["translation"].numpy(),
        jstate["comp"]["transform"]["f"]["translation"])
    # 9 + 9 slices, 4 x 2 + 4 x 3 tiles and the anchored sprite
    assert papp.world.entity_count(pm["sprite"].Sprite) == 9 + 9 + 8 + 12 + 1
    for app in (japp, papp):
        app.update(dt=DT)
    pimg = pm["plug"].frame_image(papp)
    assert _u8_diff(pimg, jm["plug"].frame_image(japp)).max() <= 1
    assert (pimg[..., :3] != pimg[0, 0, :3]).any(-1).mean() > 0.2


FRAMES = 3


def _vary(app, variant):
    """"pip": camera 1's viewport moves into the middle, over camera 0's
    (picture in picture); "pip_swapped": also the two cameras' orders
    swap, so camera 0 draws last and covers the overlap."""
    if variant == "split":
        return
    f = app.world.state["comp"]["camera2d"]["f"]
    vp_min, vp_max = f["vp_min"], f["vp_max"]
    if isinstance(vp_min, torch.Tensor):
        vp_min, vp_max = vp_min.clone(), vp_max.clone()
        vp_min[1] = torch.tensor([0.25, 0.25])
        vp_max[1] = torch.tensor([0.75, 0.75])
    else:
        vp_min = vp_min.at[1].set(jnp.asarray([0.25, 0.25]))
        vp_max = vp_max.at[1].set(jnp.asarray([0.75, 0.75]))
    f["vp_min"], f["vp_max"] = vp_min, vp_max
    if variant == "pip_swapped":
        f["order"] = f["order"][np.r_[1, 0, 2:f["order"].shape[0]]]


@pytest.fixture(scope="module")
def jax_split_frames():
    """examples/split_screen_2d.py after FRAMES frames, as built and in
    picture-in-picture with the orders swapped (one app, one compile; a
    JAX frame of this world takes about 1 s on the CPU)."""
    import split_screen_2d
    from bevy_tpu.render.plugin import frame_image

    out = {}
    app = split_screen_2d.build_app()
    state0 = jax.device_get(app.world.state)   # the frame donates it
    for variant in ("split", "pip_swapped"):
        app.world.state = jax.tree_util.tree_map(jnp.asarray, state0)
        _vary(app, variant)
        app.run(max_frames=FRAMES, dt=DT)
        out[variant] = frame_image(app)
    return out


def _port_split(mode, variant):
    import torch_split_screen_2d
    from bevy_tpu_torch.render.plugin import frame_image

    app = torch_split_screen_2d.build_app(width=640, height=360, mode=mode,
                                          device="cpu")
    _vary(app, variant)
    app.run(max_frames=FRAMES, dt=DT)
    assert _stats(app) == {"pair_overflow": 0, "tile_overflow": 0,
                           "visible_overflow": 0}
    return frame_image(app)


@pytest.mark.parametrize("mode,variant", [("tiles", "split"),
                                          ("splat", "split"),
                                          ("tiles", "pip_swapped"),
                                          ("splat", "pip_swapped")])
def test_torch_split_screen_matches_jax(jax_split_frames, mode, variant):
    img = _port_split(mode, variant)
    assert _u8_diff(img, jax_split_frames[variant]).max() <= 1
    # each viewport shows its own arena: blue props left, yellow right
    left, right = img[:, :160, :3].astype(int), img[:, 480:, :3].astype(int)
    assert ((left[..., 2] - left[..., 0]) > 60).any()
    if variant == "split":
        assert ((right[..., 0] - right[..., 2]) > 60).any()


def test_split_screen_draws_in_camera_order():
    """Picture in picture: the camera with the higher order covers the
    overlap, so swapping the orders changes the frame there only."""
    pip, swapped = _port_split("tiles", "pip"), \
        _port_split("tiles", "pip_swapped")
    diff = (pip != swapped).any(-1)
    assert diff.any()
    ys, xs = np.nonzero(diff)
    assert ys.min() >= 90 and ys.max() < 270
    assert xs.min() >= 160 and xs.max() < 480


@pytest.mark.parametrize("seed", range(3))
def test_select_cameras_matches_jax(seed):
    from bevy_tpu.render.camera import select_cameras as jax_select
    from bevy_tpu_torch.render.camera import select_cameras

    rng = np.random.RandomState(seed)
    order = rng.randint(-3, 3, 12).astype(np.int32)          # ties
    mask = rng.uniform(size=12) < 0.6
    for k in (1, 2, 5, 12):
        ids, valid = select_cameras(torch.tensor(order), torch.tensor(mask),
                                    k)
        jids, jvalid = jax_select(jnp.asarray(order), jnp.asarray(mask), k)
        assert ids.dtype == torch.int32
        assert ids.tolist() == np.asarray(jids).tolist()
        assert valid.tolist() == np.asarray(jvalid).tolist()
