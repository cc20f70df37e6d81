"""The many_lights slice end to end: the bevy_tpu_torch twin
(examples/torch_many_lights.py) on the CPU, where every kernel wrapper
runs its plain PyTorch version.

- The golden configuration of tests/test_goldens.py::test_golden_lights
  against the image the JAX package's Pallas path locked in
  tests/goldens/lights_f1.png (rendering that scene live through JAX in
  interpret mode takes about a minute on a CPU, so the stored golden
  stands in for it). Golden rule of tests/test_goldens.py: under 1% of
  pixels may drift by more than 8 in any channel.
- The JAX many_lights world carries across to the port column for column.
- The three behaviours of tests/test_lights.py, at that file's size.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

from bevy_tpu_torch.interop import state_from_numpy  # noqa: E402
from bevy_tpu_torch.render.plugin import frame_image  # noqa: E402

GOLDEN = Path(__file__).resolve().parent / "goldens" / "lights_f1.png"
GOLDEN_KW = dict(n_lights=48, n_cubes=16, width=256, height=144,
                 capacity=256, camera=(0.0, 9.0, 22.0))


def test_torch_many_lights_matches_golden():
    from PIL import Image

    import torch_many_lights

    app = torch_many_lights.build_app(device="cpu", **GOLDEN_KW)
    app.update(dt=1 / 60)
    img = frame_image(app).astype(int)
    golden = np.asarray(Image.open(GOLDEN)).astype(int)
    assert img.shape == golden.shape
    diff = np.abs(golden - img).max(-1)
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
    stats = app.world.state["res"]["render_stats"]
    for k in ("pair_overflow", "tile_overflow", "light_pair_overflow",
              "light_tile_overflow"):
        assert int(stats[k]) == 0, k
    target = app.world.state["res"]["render_target"]
    assert target["gbuffer"].shape == (19, 144, 256)
    assert target["gbuffer"].is_contiguous()
    assert torch.isfinite(target["gbuffer"]).all()
    assert (target["depth"] > 0).float().mean() > 0.3


def test_state_from_numpy_carries_the_many_lights_world():
    """The JAX many_lights world (build_app renders nothing) converted with
    state_from_numpy holds every column and resource of the torch twin's
    world, with the same dtypes: PointLight, the 19-plane G-buffer and
    render_stats included."""
    import many_lights
    import torch_many_lights

    japp = many_lights.build_app(backend="pallas_interpret", **GOLDEN_KW)
    tapp = torch_many_lights.build_app(device="cpu", **GOLDEN_KW)
    state = state_from_numpy(jax.device_get(japp.world.state), "cpu")
    tstate = tapp.world.state
    assert {"point_light", "spot_light", "rect_light"} <= set(tstate["comp"])
    assert set(tstate["comp"]) <= set(state["comp"])
    for name, store in tstate["comp"].items():
        for key in ("has", "added", "changed", "removed"):
            assert torch.equal(state["comp"][name][key] > 0,
                               store[key] > 0), (name, key)
        for f, col in store["f"].items():
            got = state["comp"][name]["f"][f]
            assert got.dtype == col.dtype, (name, f)
            assert torch.equal(got, col), (name, f)
    missing = []
    for name, store in tstate["res"].items():
        for f, v in store.items():
            if f not in state["res"][name]:
                missing.append((name, f))
                continue
            got = state["res"][name][f]
            assert got.dtype == v.dtype and torch.equal(got, v), (name, f)
    assert tstate["res"]["render_target"]["gbuffer"].shape == (19, 144, 256)
    # the port's own counters: clusters routed to B2, and the light part
    # of the shared overflow counters
    assert sorted(missing) == [("render_stats", "fallback_clusters"),
                               ("render_stats", "light_pair_overflow"),
                               ("render_stats", "light_tile_overflow")]
    assert torch.equal(state["ent"]["alive"], tstate["ent"]["alive"])


# -- tests/test_lights.py's behaviours on the port ------------------------


def _frame(**kw):
    import torch_many_lights

    kw = dict(dict(n_lights=32, n_cubes=9, width=192, height=96,
                   capacity=128, camera=(0.0, 8.0, 20.0)), **kw)
    app = torch_many_lights.build_app(device="cpu", **kw)
    app.update(dt=1 / 60)
    return frame_image(app)


def _saturated(img):
    rgb = img[..., :3].astype(int)
    return int(((rgb.max(-1) - rgb.min(-1)) > 30).sum())


def test_floor_and_light_pools_render():
    img = _frame()
    h = img.shape[0]
    # the floor fills the lower view: pixels differ from the clear colour
    clear = np.asarray([88, 88, 102])
    lower = img[int(h * 0.7):, :, :3].astype(int)
    assert (np.abs(lower - clear).sum(-1) > 20).mean() > 0.9
    # some pixels are clearly lit by tinted point lights
    rgb = img[..., :3].astype(int)
    assert ((rgb.max(-1) - rgb.min(-1)) > 25).sum() > 20


def test_light_range_limits_pool():
    assert _saturated(_frame(light_range=2.0)) < \
        _saturated(_frame(light_range=10.0))


def test_no_lights_leaves_ambient_only():
    assert _saturated(_frame(n_lights=0)) < 10


def test_deferred_plugin_refuses_unported_features():
    """Specular tint (A4b) and anisotropy (A5) in the plugin raise instead
    of rendering something else; sharded shading (ported) over more CUDA
    cards than exist raises instead of falling back to fewer or the CPU."""
    import torch_many_lights
    from bevy_tpu_torch.render.deferred import DeferredLightingPlugin
    from bevy_tpu_torch.render.mesh3d import MeshMaterial

    with pytest.raises(ValueError, match="devices"):
        DeferredLightingPlugin(shards=torch.cuda.device_count() + 1)
    for values, item in (({"specular_tint": (1.0, 0.5, 0.5)}, "A4b"),
                         ({"anisotropy_strength": 0.5}, "A5")):
        app = torch_many_lights.build_app(device="cpu", n_lights=4,
                                          n_cubes=1, width=128, height=64,
                                          capacity=16)
        app.world.spawn(MeshMaterial(**values))
        with pytest.raises(NotImplementedError, match=item):
            app.update(dt=1 / 60)
