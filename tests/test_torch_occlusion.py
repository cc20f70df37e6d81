"""bevy_tpu_torch's two-phase occlusion culling and visible-budget
compaction against the JAX package: the hi-z (coarse_min_depth,
occlusion_test; plain PyTorch, as the JAX package's are XLA) on seeded
inputs, equal; tests/test_occlusion.py's world over three frames and a
world compacted to 64 visible clusters, against the JAX package's frames
stored by tests/make_torch_goldens.py (its Pallas kernels in interpret
mode), under the golden rule (under 1% of pixels drift by more than 8);
and the reference test's own bounds on the port: the culled frames match
the unculled ones (under 0.2% of pixels drift by more than 8) and the
mask shrinks.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402

GOLDENS = ROOT / "tests" / "goldens"
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def m():
    return ts.port_scene_modules()


def _keyed(name):
    keys = json.loads((GOLDENS / "torch_goldens.json").read_text())
    assert keys[name] == ts.golden_key(name), \
        f"{name}: the scene changed; run tests/make_torch_goldens.py {name}"


def golden_rule(img, ref, bound=0.01):
    assert img.shape == ref.shape
    d = np.abs(img - ref).max(-1)
    assert (d > 8).mean() < bound, ((d > 8).mean(), d.max())


def test_hiz_functions_match_jax():
    import jax.numpy as jnp

    from bevy_tpu.ops import raster3d_splat as jsplat
    from bevy_tpu_torch.ops import raster3d_splat as tsplat
    rng = np.random.RandomState(0)
    depth = np.where(rng.uniform(size=(90, 150)) < 0.7,
                     rng.uniform(0, 1, (90, 150)), 0.0).astype(np.float32)
    jc = jsplat.coarse_min_depth(jnp.asarray(depth))
    tc = tsplat.coarse_min_depth(torch.from_numpy(depth))
    assert np.array_equal(np.asarray(jc), tc.numpy())
    # boxes from a pixel to whole-frame, some off screen
    x0 = rng.uniform(-40, 160, 300)
    y0 = rng.uniform(-20, 100, 300)
    w = np.exp(rng.uniform(0, 5.5, 300))
    h = np.exp(rng.uniform(0, 4.5, 300))
    aabb = np.stack([x0, y0, x0 + w, y0 + h], 1).astype(np.float32)
    zmax = rng.uniform(0, 0.3, 300).astype(np.float32)
    coarse = np.asarray(jc) + 0.2
    jo = jsplat.occlusion_test(jnp.asarray(aabb), jnp.asarray(zmax),
                               jnp.asarray(coarse))
    to = tsplat.occlusion_test(torch.from_numpy(aabb),
                               torch.from_numpy(zmax),
                               torch.from_numpy(coarse))
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert 0 < int(to.sum()) < 300


def test_occlusion_frames_match_jax_and_unculled(m):
    _keyed("occl_f3")
    stored = np.load(GOLDENS / "occl_f3.npz")["frames"].astype(int)
    culled, app = ts.occl_world(m, CPU, {}, True)
    unculled, _ = ts.occl_world(m, CPU, {}, False)
    for a, b, c in zip(culled, stored, unculled):
        golden_rule(a, b)
        golden_rule(a, c, bound=0.002)
    vis = app.world.state["res"]["mesh_vis"]["g0v0"]
    assert 0 < int(vis.sum()) < vis.numel()
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0 == int(stats["tile_overflow"])


def test_visible_budget_compaction_matches_jax(m):
    """visible_budget below the visible clusters: the first 64 in cluster
    order draw (a cumsum compaction, as the JAX package's run_phase), the
    rest count into pair_overflow."""
    _keyed("budget_64")
    from PIL import Image
    img, app = ts.budget_world(m, CPU, {}, 64)
    golden_rule(img, np.asarray(Image.open(GOLDENS / "budget_64.png"))
                .astype(int))
    full, _ = ts.budget_world(m, CPU, {}, 65536)
    assert not np.array_equal(img, full)
    assert int(app.world.state["res"]["render_stats"]["pair_overflow"]) > 0
