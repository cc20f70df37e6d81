"""many_gizmos on bevy_tpu_torch — the PyTorch + CUDA twin of
examples/many_gizmos.py (reference: examples/stress_tests/many_gizmos.rs —
thousands of immediate-mode lines a frame).

The JAX example's scene (seed 11, segments up to 40 px) at its line
density: 1,000 lines at 320x180, so 16,000 at the default 1280x720, with
room for four times as many in the buffer. One system appends them all
each frame as one batch (`line_2d(A, B, colors)`; the JAX example appends
one line a call: the same buffer rows); the gizmo pass draws them through
the tile raster (kernel B4).

    python examples/torch_many_gizmos.py              # 1280x720, 16,000
    python examples/torch_many_gizmos.py --profile 10 # + per-span time
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bevy_tpu_torch import App, Update  # noqa: E402
from bevy_tpu_torch.ecs.system import system  # noqa: E402
from bevy_tpu_torch.render import (  # noqa: E402
    Camera2d, RenderPlugin, SpritePlugin,
)
from bevy_tpu_torch.render.gizmos import Gizmos, GizmosPlugin  # noqa: E402
from bevy_tpu_torch.time import TimePlugin  # noqa: E402
from bevy_tpu_torch.transform import (  # noqa: E402
    TransformPlugin, transform_bundle,
)


def n_lines_for(width, height):
    """The JAX example's density: 1,000 lines on 320x180."""
    return round(1000 * width * height / (320 * 180))


def scene(width, height, n_lines):
    """The JAX example's lines: endpoints (n, 2) a and b and rgba (n, 4),
    f32 (rounded from its float64 draws, as jnp rounds them)."""
    rng = np.random.default_rng(11)
    a = (rng.random((n_lines, 2)) - 0.5) * [width, height]
    b = a + (rng.random((n_lines, 2)) - 0.5) * 40.0
    cols = rng.random((n_lines, 3)) * 0.8 + 0.2
    rgba = np.concatenate([cols, np.ones((n_lines, 1))], 1)
    return (a.astype(np.float32), b.astype(np.float32),
            rgba.astype(np.float32))


def build_app(width=1280, height=720, n_lines=None, device="cuda") -> App:
    n_lines = n_lines_for(width, height) if n_lines is None else n_lines
    app = App(capacity=8, device=device)
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=width, height=height),
                    SpritePlugin(), GizmosPlugin(capacity=4 * n_lines))
    app.world.spawn(Camera2d(), *transform_bundle())
    a, b, rgba = (torch.tensor(x, device=app.device)
                  for x in scene(width, height, n_lines))

    @system
    def draw(g=Gizmos(budget=n_lines)):
        g.line_2d(a, b, rgba)

    app.add_systems(Update, draw)
    return app


def main():
    import argparse

    from torch_many_sprites import run_timed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", type=int, default=0, metavar="FRAMES",
                    help="also profile this many frames (torch.profiler)")
    args = ap.parse_args()
    run_timed(build_app(), f"many_gizmos {n_lines_for(1280, 720)} lines",
              profile_frames=args.profile)


if __name__ == "__main__":
    main()
