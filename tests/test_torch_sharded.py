"""The multi-device raster of bevy_tpu_torch (parallel/), on a ShardMesh of
eight `cpu` entries, as the JAX package's tests run it on eight virtual
CPU devices (tests/conftest.py): the cluster-sharded flat raster against
the port's single-device two-pass path and against JAX's
`sharded_flat_raster` (tests/test_sharded_raster.py's scene), the
many_cubes twin with 8 shards against no shards
(tests/test_sharded_cubes.py), and the row-band deferred shade against the
unsharded one (tests/test_sharded_shade.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from bevy_tpu_torch.ops import raster3d_splat as splat
from bevy_tpu_torch.ops import raster3d_visbuf as vis
from bevy_tpu_torch.parallel import ShardMesh, as_mesh, make_mesh
from bevy_tpu_torch.parallel import raster as par_raster
from test_sharded_raster import CS, H, W, _scene

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

CPU8 = ["cpu"] * 8


def test_make_mesh():
    mesh = make_mesh(devices=CPU8)
    assert isinstance(mesh, ShardMesh) and mesh.size == 8
    assert mesh.devices == [torch.device("cpu")] * 8
    assert make_mesh(3, devices=CPU8).size == 3
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)
    # CUDA cards only, never a silent fallback: here (no card) even one
    # card is too many
    with pytest.raises(ValueError):
        make_mesh(torch.cuda.device_count() + 1)


def test_both_plugins_take_shards_through_as_mesh():
    from bevy_tpu_torch.render.deferred import DeferredLightingPlugin
    from bevy_tpu_torch.render.mesh3d import Mesh3dPlugin
    mesh = make_mesh(devices=CPU8)
    assert as_mesh(None) is None and as_mesh(mesh) is mesh
    assert Mesh3dPlugin(shards=mesh).shard_mesh is mesh
    assert DeferredLightingPlugin(shards=mesh).cfg["shards"] is mesh
    too_many = torch.cuda.device_count() + 1
    for make in (as_mesh, lambda n: Mesh3dPlugin(shards=n),
                 lambda n: DeferredLightingPlugin(shards=n)):
        with pytest.raises(ValueError, match="devices"):
            make(too_many)


def _torch_scene():
    return [torch.tensor(np.asarray(x)) for x in _scene()]


def _single_device(cc, cn, ok, mat, light):
    """The port's one-device two-pass path (tests/test_sharded_raster.py's
    `_single_device`)."""
    n_cl = cc.shape[0] // CS
    aabb, cl_valid, _ = vis.cluster_screen_aabbs(
        cc, torch.ones(n_cl, dtype=torch.bool), ok, CS, W, H)
    zrec, valid = vis.pack_planes_h(cc, cn, ok, W, H)
    frec = vis.pack_flat_shade(cn, mat, light, valid)
    zrec_c, _ = splat.compact_cluster_tris(zrec, CS)
    wins = splat.build_windows(aabb, cl_valid, win_h=16, width=W, height=H,
                               budget=2048)
    assert int(wins["overflow"]) == 0
    windows = splat.eval_windows(zrec_c, CS, wins["owner"], wins["meta"],
                                 wins["wvalid"], win_h=16)
    depth, winner = splat.composite_windows(
        torch.zeros((H, W)), torch.full((H, W), -1.0), windows,
        wins["owner"], wins["meta"], wins["wvalid"], win_h=16, cs=CS)
    color = vis.resolve_flat(winner.to(torch.int32), frec,
                             torch.zeros((4, H, W)))
    return color.numpy(), depth.numpy()


def test_sharded_flat_raster_matches_single_device_and_jax():
    """Colour bit-identical to the port's single-device path (every pixel
    resolves the same global record row), depth within 5e-5 (as
    tests/test_sharded_raster.py); against JAX's sharded_flat_raster on
    the 8-device CPU mesh: depth within 5e-5, colour equal on >= 99.5% of
    pixels (an edge pixel may flip where XLA fuses a plane's multiply-add,
    see tests/test_torch_composite.py)."""
    from bevy_tpu.parallel import make_mesh as jax_make_mesh
    from bevy_tpu.parallel.raster import sharded_flat_raster as jax_sharded

    scene = _torch_scene()
    ref_color, ref_depth = _single_device(*scene)
    color, depth = par_raster.sharded_flat_raster(
        make_mesh(devices=CPU8), *scene, width=W, height=H, cluster_size=CS,
        win_h=16, visible_budget=8 * 8, window_budget=2048)
    color, depth = color.numpy(), depth.numpy()
    assert depth.shape == (H, W)
    assert np.array_equal(color, ref_color)
    assert np.allclose(depth, ref_depth, atol=5e-5)
    assert (depth > 0).mean() > 0.05

    jcolor, jdepth = jax_sharded(
        jax_make_mesh(8), *_scene(), width=W, height=H, cluster_size=CS,
        win_h=16, visible_budget=8 * 8, window_budget=2048, interpret=True)
    jcolor = np.asarray(jax.device_get(jcolor))
    jdepth = np.asarray(jax.device_get(jdepth))
    assert np.allclose(depth, jdepth, atol=5e-5)
    assert np.all(color == jcolor, 0).mean() >= 0.995


def _render_cubes(shards, frames=2):
    """tests/test_sharded_cubes.py's configuration on the port."""
    import torch_many_cubes
    from bevy_tpu_torch.render.plugin import frame_image

    app = torch_many_cubes.build_app(
        n_cubes=512, width=256, height=128, capacity=1024,
        window_budget=8192, cull_budget=None, shards=shards, device="cpu")
    app.run(max_frames=frames, dt=1 / 60)
    return app, frame_image(app)


def test_sharded_many_cubes_image_identity(monkeypatch):
    """8 shards against none: images identical; and the sharded path ran
    (the spy of tests/test_sharded_cubes.py's
    test_sharded_path_actually_engages)."""
    calls = {"n": 0}
    orig = par_raster.sharded_instance_raster

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(par_raster, "sharded_instance_raster", spy)
    _, single = _render_cubes(None)
    assert calls["n"] == 0
    app, sharded = _render_cubes(make_mesh(devices=CPU8))
    assert calls["n"] == 2                       # one group, two frames
    assert single.shape == sharded.shape
    assert np.array_equal(single, sharded), (
        f"max diff {np.abs(single.astype(int) - sharded).max()}")
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0
    assert int(stats["fallback_clusters"]) == 0


def _deferred_scene(shards):
    """tests/test_sharded_shade.py's scene on the port."""
    from bevy_tpu_torch import App
    from bevy_tpu_torch.render import RenderPlugin
    from bevy_tpu_torch.render.camera import Camera3d
    from bevy_tpu_torch.render.deferred import (
        DeferredLightingPlugin, PointLight)
    from bevy_tpu_torch.render.mesh import cuboid
    from bevy_tpu_torch.render.mesh3d import (
        AmbientLight, DirectionalLight, Mesh3d, MeshMaterial, Mesh3dPlugin)
    from bevy_tpu_torch.render.plugin import frame_image
    from bevy_tpu_torch.time import TimePlugin
    from bevy_tpu_torch.transform import TransformPlugin, transform_bundle

    app = App(capacity=64, device="cpu")
    plugin = Mesh3dPlugin(deferred=True)
    cube = plugin.add_mesh(cuboid(1.0, 1.0, 1.0))
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=256, height=160), plugin,
                    DeferredLightingPlugin(shards=shards))
    app.insert_resource(AmbientLight(brightness=0.1))
    app.world.spawn(Mesh3d(mesh=cube),
                    MeshMaterial(base_color=(0.8, 0.8, 0.8, 1.0)),
                    *transform_bundle(translation=(0.0, -0.55, -4.0),
                                      scale=(12.0, 0.1, 12.0)))
    for i in range(4):
        app.world.spawn(Mesh3d(mesh=cube),
                        MeshMaterial(base_color=(0.7, 0.4, 0.3, 1.0)),
                        *transform_bundle(
                            translation=(-3.0 + 2.0 * i, 0.0, -5.0)))
    for i in range(6):
        app.world.spawn(
            PointLight(color=(1.0, 0.6 + 0.05 * i, 0.3), intensity=2.0,
                       range=6.0),
            *transform_bundle(translation=(-4.0 + 1.6 * i, 1.5, -4.0)))
    app.world.spawn(DirectionalLight(illuminance=0.4),
                    *transform_bundle(rotation=(-0.38, 0.0, 0.0, 0.92)))
    app.world.spawn(Camera3d(), *transform_bundle(
        translation=(0.0, 2.5, 2.0), rotation=(-0.3, 0.0, 0.0, 0.954)))
    app.update(dt=1 / 60)
    return frame_image(app)


def test_sharded_deferred_shade_image_identical():
    calls = {"n": 0}
    orig = par_raster.sharded_deferred_shade

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    ref = _deferred_scene(None)
    par_raster.sharded_deferred_shade = spy
    try:
        sharded = _deferred_scene(make_mesh(devices=CPU8))
    finally:
        par_raster.sharded_deferred_shade = orig
    assert calls["n"] == 1
    assert ref.shape == sharded.shape
    diff = np.abs(ref.astype(int) - sharded.astype(int))
    assert diff.max() == 0, f"max diff {diff.max()}"
    assert (ref[..., :3] > 0).mean() > 0.5
