"""Tilemap chunks (render/tilemap.py) and a 2D world carried across from
the JAX package, on the CPU.

- tilemap: the twin against examples/tilemap.py before the tide's tile
  edit (2 frames of 0.25 s: the sand flooded) and after it (5 frames:
  the clock passed 1 s, the sand back), images and tile resources; and
  the chunk pass ignores the camera's scale and rotation, as JAX's does
  (ROADMAP C3).
- torch_scenes.carried_world (a tilemap with empty cells, a DigitText
  counter, an AtlasAnimation sprite, two retained gizmos): the JAX world
  after 5 frames is loaded into the port (interop.load_world), then both
  run 4 more frames: the same image, tiles, counter, animation and gizmo
  buffer.
Images: at most 1 sRGB step in f32 (measured 0).
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
from bevy_tpu_torch.interop import load_world  # noqa: E402

STEP = 0.25          # the clock's largest step (TimeVirtual.max_delta)


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


def test_torch_tilemap_matches_jax_across_a_tile_edit():
    import tilemap
    import torch_tilemap
    from bevy_tpu.render.plugin import frame_image as jax_frame_image
    from bevy_tpu_torch.render.plugin import frame_image

    japp = tilemap.build_app()
    papp = torch_tilemap.build_app(device="cpu")
    imgs = []
    for frames in (2, 3):                # elapsed 0.5 s, then 1.25 s
        for app in (japp, papp):
            app.run(max_frames=frames, dt=STEP)
        jimg, pimg = jax_frame_image(japp), frame_image(papp)
        assert _u8_diff(pimg, jimg).max() <= 1
        tiles = papp.world.state["res"]["tilemap0"]["tiles"]
        assert tiles.dtype == torch.int32
        assert np.array_equal(tiles.numpy(), np.asarray(
            japp.world.state["res"]["tilemap0"]["tiles"]))
        imgs.append((pimg, tiles.numpy()))
    (flooded, t0), (dry, t1) = imgs
    assert (t0 == 2).sum() == 0 and (t1 == 2).sum() > 10
    assert (flooded != dry).any(-1).mean() > 0.05      # the edit shows


def test_tilemap_ignores_camera_scale_and_rotation():
    """The chunk pass reads the camera's translation only (ROADMAP C3):
    a scaled, turned camera gives the same chunk pixels."""
    import torch_tilemap
    from bevy_tpu_torch.render.plugin import frame_image

    imgs = []
    for scale, rot in ((1.0, (0.0, 0.0, 0.0, 1.0)),
                       (2.5, (0.0, 0.0, 0.3827, 0.9239))):
        app = torch_tilemap.build_app(device="cpu")
        cam = app.world.state["comp"]["camera2d"]["f"]
        cam["scale"] = torch.full_like(cam["scale"], scale)
        gt = app.world.state["comp"]["global_transform"]["f"]
        gt["rotation"] = gt["rotation"].clone()
        gt["rotation"][0] = torch.tensor(rot)
        app.update(dt=1 / 60)
        imgs.append(frame_image(app))
    assert np.array_equal(imgs[0], imgs[1])


def test_carried_world_continues_from_jax():
    jm = {k: importlib.import_module(f"bevy_tpu{v}")
          for k, v in ts.SCENE_MODULES.items()}
    pm = ts.port_scene_modules()
    japp = ts.carried_world(jm, {})
    japp.run(max_frames=5, dt=1 / 60)
    papp = ts.carried_world(pm, {"device": "cpu"})
    load_world(papp.world, jax.device_get(japp.world.state))
    assert int(papp.world.state["frame"]) == 5
    for app in (japp, papp):
        app.run(max_frames=4, dt=1 / 60)
    jstate = jax.device_get(japp.world.state)
    pstate = papp.world.state
    assert _u8_diff(pm["plug"].frame_image(papp),
                    jm["plug"].frame_image(japp)).max() <= 1
    for comp, f in (("atlas_animation", "frame"), ("sprite", "uv_min"),
                    ("sprite", "color"), ("digit_text", "slot"),
                    ("retained_gizmo", "b")):
        assert np.array_equal(pstate["comp"][comp]["f"][f].numpy(),
                              jstate["comp"][comp]["f"][f]), (comp, f)
    assert np.array_equal(pstate["res"]["tilemap0"]["tiles"].numpy(),
                          jstate["res"]["tilemap0"]["tiles"])
    for f in ("a", "b", "color", "width", "is3d"):
        assert np.array_equal(pstate["res"]["gizmo_lines"][f].numpy(),
                              jstate["res"]["gizmo_lines"][f]), f
    # the counter reads 9 (slots 2 and 1 blank), the sheet sprite is on
    # frame 1 (9 / 60 s at 7 fps)
    rows = papp.world.query_rows(pm["text"].DigitText)
    assert pstate["comp"]["sprite"]["f"]["color"][rows, 3].tolist() == \
        [0.0, 0.0, 1.0]
    row = papp.world.query_rows(pm["sprite"].AtlasAnimation)[0]
    assert int(pstate["comp"]["atlas_animation"]["f"]["frame"][row]) == 1
