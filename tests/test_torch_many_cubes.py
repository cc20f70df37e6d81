"""The slice end to end: the bevy_tpu_torch many_cubes twin, in the golden
configuration of tests/test_goldens.py::test_golden_cubes_splat, against
the image the JAX package's Pallas path locked in
tests/goldens/cubes_splat_f2.png (rendering that scene live through JAX
in interpret mode takes about a minute on a CPU, so the stored golden
stands in for it). Golden rule of tests/test_goldens.py: under 1% of
pixels may drift by more than 8 in any channel."""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

GOLDEN = Path(__file__).resolve().parent / "goldens" / "cubes_splat_f2.png"


def test_torch_many_cubes_matches_golden():
    from PIL import Image

    import torch_many_cubes
    from bevy_tpu_torch.render.plugin import frame_image

    app = torch_many_cubes.build_app(n_cubes=300, width=320, height=180,
                                     capacity=512, window_budget=4096,
                                     device="cpu")
    app.run(max_frames=2, dt=1 / 60)
    img = frame_image(app).astype(int)
    golden = np.asarray(Image.open(GOLDEN)).astype(int)
    assert img.shape == golden.shape
    diff = np.abs(golden - img).max(-1)
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0
    assert int(stats["tile_overflow"]) == 0
    depth = app.world.state["res"]["render_target"]["depth"]
    assert torch.isfinite(depth).all() and (depth > 0).float().mean() > 0.02
    assert app.frame == 2
