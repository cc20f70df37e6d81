"""The 2D sprite slice end to end: the bevy_tpu_torch twins of breakout,
many_sprites and bevymark (examples/torch_*.py) on the CPU, where every
kernel wrapper runs its plain PyTorch version.

- breakout at the golden configuration of tests/test_goldens.py against
  tests/goldens/breakout_f25.png (that file's rule: under 1% of pixels may
  drift by more than 8 in any channel), and the port's own bit-exact
  replay (tests/test_breakout.py::test_determinism_bit_exact).
- bevymark carried across from a JAX world after 10 frames
  (interop.load_world), then run on to JAX's frame 15.
- many_sprites (300 sprites, 320x180) and bevymark (15 frames, 192x96)
  against the JAX examples' frames. On CPU the JAX sprite pass takes its
  XLA raster (which has no bf16), so the JAX apps are built with
  sample_dtype="f32". Tolerances on the sRGB u8 images: the port in f32,
  at most 1 step (measured 0); the port's default bf16 sampling, at most 2
  steps (measured 1).
- bevymark's bird positions, velocities and live count exactly equal.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

from bevy_tpu_torch.interop import load_world  # noqa: E402
from bevy_tpu_torch.render.plugin import frame_image  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "goldens" / "breakout_f25.png"
BREAKOUT_KW = dict(width=320, height=200, camera_scale=3.2,
                   ball_velocity=(120.0, 380.0))
DT = 1 / 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs
    six workers on one machine's cores (measured on 8 cores: the three 2D
    port files take 83 s with 1 thread and 78 s with 8, at 41% of the CPU
    time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8_diff(a, b):
    return np.abs(a.astype(int) - b.astype(int)).max(-1)


def _stats(app):
    return {k: int(v) for k, v in
            app.world.state["res"]["render_stats"].items()}


def test_torch_breakout_matches_golden():
    from PIL import Image

    import torch_breakout

    app = torch_breakout.build_app(device="cpu", **BREAKOUT_KW)
    app.run(max_frames=25, dt=DT)
    img = frame_image(app)
    golden = np.asarray(Image.open(GOLDEN))
    assert img.shape == golden.shape
    assert (_u8_diff(img, golden) > 8).mean() < 0.01
    assert _stats(app) == {"pair_overflow": 0, "tile_overflow": 0,
                           "visible_overflow": 0}


def test_torch_breakout_replay_bit_exact():
    import torch_breakout

    imgs, scores = [], []
    for _ in range(2):
        app = torch_breakout.build_app(device="cpu", width=256, height=160,
                                       camera_scale=4.0,
                                       ball_velocity=(120.0, 380.0))
        app.run(max_frames=30, dt=DT)
        imgs.append(frame_image(app))
        scores.append(int(app.world.state["res"]["score"]["value"]))
    assert scores[0] == scores[1] >= 1
    assert np.array_equal(imgs[0], imgs[1])


@pytest.fixture(scope="module")
def jax_sprites_frame():
    import many_sprites

    app = many_sprites.build_app(n_sprites=300, width=320, height=180,
                                 sample_dtype="f32")
    app.run(max_frames=2, dt=DT)
    from bevy_tpu.render.plugin import frame_image as jax_frame_image
    return jax_frame_image(app)


@pytest.mark.parametrize("dtype,tol", [("f32", 1), ("bf16", 2)])
def test_torch_many_sprites_matches_jax(jax_sprites_frame, dtype, tol):
    import torch_many_sprites

    app = torch_many_sprites.build_app(n_sprites=300, width=320, height=180,
                                       sample_dtype=dtype, device="cpu")
    app.run(max_frames=2, dt=DT)
    img = frame_image(app)
    assert _u8_diff(img, jax_sprites_frame).max() <= tol
    assert (img[..., :3] != img[0, 0, :3]).any(-1).mean() > 0.1  # drawn
    assert _stats(app) == {"pair_overflow": 0, "tile_overflow": 0,
                           "visible_overflow": 0}


BEVY_KW = dict(width=192, height=96, capacity=1024, spawn_budget=16,
               max_per_tile=256)


@pytest.fixture(scope="module")
def jax_bevymark():
    """Host copies of the JAX bevymark world after 10 frames, and after
    15 with its image. (At 15 frames the spawn corner's tile holds 240
    birds, under the 256 that the JAX XLA raster keeps a tile.)"""
    import bevymark
    from bevy_tpu.render.plugin import frame_image as jax_frame_image

    app = bevymark.build_app(sample_dtype="f32", **BEVY_KW)
    app.run(max_frames=10, dt=DT)
    state10 = jax.device_get(app.world.state)
    app.run(max_frames=5, dt=DT)
    return state10, jax.device_get(app.world.state), jax_frame_image(app)


def _same_birds(state, jstate):
    assert np.array_equal(state["ent"]["alive"].numpy(),
                          jstate["ent"]["alive"])
    for comp, f in (("transform", "translation"), ("bird", "velocity"),
                    ("sprite", "color")):
        assert np.array_equal(state["comp"][comp]["f"][f].numpy(),
                              jstate["comp"][comp]["f"][f]), (comp, f)


@pytest.mark.parametrize("dtype,tol", [("f32", 1), ("bf16", 2)])
def test_torch_bevymark_matches_jax(jax_bevymark, dtype, tol):
    import torch_bevymark

    _, jstate, jimg = jax_bevymark
    app = torch_bevymark.build_app(device="cpu", sample_dtype=dtype,
                                   **BEVY_KW)
    app.run(max_frames=15, dt=DT)
    assert app.world.entity_count(torch_bevymark.Bird) == 15 * 16
    _same_birds(app.world.state, jstate)
    assert _u8_diff(frame_image(app), jimg).max() <= tol
    assert _stats(app) == {"pair_overflow": 0, "tile_overflow": 0,
                           "visible_overflow": 0}


def test_bevymark_continues_from_a_jax_world(jax_bevymark):
    """The port loads the JAX world at frame 10 (interop.load_world:
    columns, resources with the atlas and the frame counter, tick and
    frame) and runs 5 frames: the same birds and image as JAX's frame 15
    (the port in f32)."""
    import torch_bevymark

    state10, jstate, jimg = jax_bevymark
    app = torch_bevymark.build_app(device="cpu", sample_dtype="f32",
                                   **BEVY_KW)
    load_world(app.world, state10)
    assert app.world.entity_count(torch_bevymark.Bird) == 10 * 16
    app.run(max_frames=5, dt=DT)
    assert int(app.world.state["frame"]) == int(jstate["frame"]) == 15
    _same_birds(app.world.state, jstate)
    assert _u8_diff(frame_image(app), jimg).max() <= 1
