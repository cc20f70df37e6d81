"""The two-pass window path of bevy_tpu_torch (ops/raster3d_splat.py
`compact_cluster_tris`, `eval_windows`, `composite_windows` with kernel B6)
against the JAX package on the same numpy inputs: the scene of
tests/test_sharded_raster.py, evaluated by the JAX package's
`eval_windows`, then composited by JAX's `_composite_kernel` in interpret
mode and by the port's plain version. Also: the two-pass path against the
port's fused B1 path (as tests/test_splat.py::test_fused_matches_two_pass),
and every kernel wrapper's refusal of a call whose tensors sit on
different devices. (B6 against its plain version on the card:
tests/test_torch_package.py and chip_smoke.py.)

The multi-device raster of bevy_tpu_torch (parallel/), at the end of this
file, on a ShardMesh of eight `cpu` entries, as the JAX package's tests
run it on eight virtual CPU devices (tests/conftest.py): the
cluster-sharded flat raster against the port's single-device two-pass
path and against JAX's `sharded_flat_raster` (tests/test_sharded_raster.py's
scene), the many_cubes twin with 8 shards against no shards
(tests/test_sharded_cubes.py), and the row-band deferred shade against the
unsharded one (tests/test_sharded_shade.py)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bevy_tpu.ops import raster3d_splat as jsplat
from bevy_tpu.ops import raster3d_visbuf as jvis
from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops import raster2d, raster2d_splat, shade
from bevy_tpu_torch.ops import raster3d_splat as splat
from bevy_tpu_torch.ops import raster3d_visbuf as vis
from bevy_tpu_torch.parallel import ShardMesh, as_mesh, make_mesh
from bevy_tpu_torch.parallel import raster as par_raster
from test_sharded_raster import CS, H, W, _scene

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

WIN_H = 16
CPU8 = ["cpu"] * 8


def _jax_windows(win_h=WIN_H):
    """The sharded-raster test scene through the JAX package up to the
    evaluated windows. Returns numpy (zrec, aabb, cl_valid, windows, owner,
    meta, wvalid)."""
    cc, cn, ok, _, _ = _scene()
    n_cl = cc.shape[0] // CS
    aabb, cl_valid, _ = jvis.cluster_screen_aabbs(
        cc, jnp.ones((n_cl,), bool), ok, CS, W, H)
    zrec, _, _ = jvis.pack_planes_h(cc, cn, ok, W, H, build_srec=False)
    zrec_c, _ = jsplat.compact_cluster_tris(zrec, CS)
    wins = jsplat.build_windows(aabb, cl_valid, win_h=win_h, width=W,
                                height=H, budget=2048)
    windows = jsplat.eval_windows(zrec_c, CS, wins["owner"], wins["meta"],
                                  wins["wvalid"], win_h=win_h)
    return [np.array(x) for x in (zrec, aabb, cl_valid, windows,
                                    wins["owner"], wins["meta"],
                                    wins["wvalid"])]


@pytest.fixture(scope="module")
def jax_windows():
    return _jax_windows()


@pytest.mark.parametrize("incoming", ["clear", "prefilled", "negative"])
def test_composite_plain_bit_equal_to_jax_interpret(jax_windows, incoming):
    """Depth and winner bit for bit. `prefilled` starts from a framebuffer
    whose depth equals some windows' packed values exactly (the incoming
    value must win those ties) and beats others. `negative` starts from
    depths below 0 on half the pixels (and -0.0 on a tenth): there an
    empty window pixel (dz = 0, "no hit") beats the depth and is written,
    as the reference's strict `dz > depth` does (B6 skips empty pixels only
    when no depth is below 0)."""
    _, _, _, windows, owner, meta, wvalid = jax_windows
    rng = np.random.RandomState(1)
    depth = np.zeros((H, W), np.float32)
    winner = np.full((H, W), -1.0, np.float32)
    if incoming == "prefilled":
        hit = windows[wvalid].max(0)              # (win_h, 128) best values
        depth[:WIN_H] = np.where(rng.uniform(size=hit.shape) < 0.5, hit,
                                 rng.uniform(0, 1, hit.shape))[:, :W]
        winner[:WIN_H] = 5.0
    elif incoming == "negative":
        u = rng.uniform(size=(H, W))
        depth = np.where(u < 0.5, -rng.uniform(0.01, 1, (H, W)),
                         np.where(u < 0.6, -0.0, 0.0)).astype(np.float32)
        winner[:] = 5.0
    dj, wj = jsplat.composite_windows(
        jnp.asarray(depth), jnp.asarray(winner), jnp.asarray(windows),
        jnp.asarray(owner), jnp.asarray(meta), jnp.asarray(wvalid),
        win_h=WIN_H, cs=CS, interpret=True)
    t = [torch.from_numpy(x) for x in (depth, winner, windows, owner, meta,
                                       wvalid)]
    splat.composite_windows.launches = 0
    dp, wp = splat.composite_windows(*t, win_h=WIN_H, cs=CS)
    assert np.array_equal(dp.numpy().view(np.int32),
                          np.asarray(dj).view(np.int32))
    assert np.array_equal(wp.numpy().view(np.int32),
                          np.asarray(wj).view(np.int32))
    assert (wp.numpy() >= 0).mean() > 0.05
    if incoming == "negative":    # empty pixels wrote over depths below 0
        wrote_empty = (depth < 0) & (dp.numpy() == 0) & (wp.numpy() != 5.0)
        assert wrote_empty.sum() > 100
    assert splat.composite_windows.launches == 0       # CPU: plain version
    assert _cuda._Loaded.lib is None


def test_compact_and_eval_windows_match_jax(jax_windows):
    """compact_cluster_tris exactly; eval_windows' packed values within
    atol 5e-5 (XLA's CPU backend may fuse a plane's multiply-add into an
    FMA, so z may differ by an ulp and an edge pixel may flip), the packed
    triangle ids agreeing on >= 99.5% of the pixels both cover. Windows
    past the valid prefix are not compared: composite_windows never reads
    them, and the two evaluate different subsets of them."""
    zrec, _, _, windows, owner, meta, wvalid = jax_windows
    zrec_c, nmax = splat.compact_cluster_tris(torch.from_numpy(zrec), CS)
    zj, nj = jsplat.compact_cluster_tris(jnp.asarray(zrec), CS)
    assert np.array_equal(zrec_c.numpy(), np.asarray(zj))
    assert int(nmax) == int(nj)
    got = splat.eval_windows(zrec_c, CS, torch.from_numpy(owner),
                             torch.from_numpy(meta), torch.from_numpy(wvalid),
                             win_h=WIN_H, chunk=64).numpy()[wvalid]
    want = windows[wvalid]
    assert np.abs(got - want).max() <= 5e-5
    both = (got > 0) & (want > 0)
    assert both.sum() > 1000
    ids_equal = (got.view(np.int32) & 15) == (want.view(np.int32) & 15)
    assert ids_equal[both].mean() >= 0.995


def _cubes(n=40, seed=3, w=256, h=128):
    """tests/test_splat.py's cube scene (n cubes, seed 3) through the port's
    setup: clip-space corners (n*12, 3, 4) and normals."""
    from bevy_tpu_torch.math.affine import TRS, trs_to_mat4
    from bevy_tpu_torch.math.quat import quat_rotate_vec3
    from bevy_tpu_torch.render.camera import (
        perspective_infinite_reverse, view_matrix)
    from bevy_tpu_torch.render.mesh import cuboid

    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(-18.0, 18.0, n), rng.uniform(-9.0, 9.0, n),
                    rng.uniform(-60.0, -25.0, n)], 1).astype(np.float32)
    m = cuboid(1.0, 1.0, 1.0)
    vc, tc = m.num_vertices, m.num_triangles
    view = view_matrix(torch.zeros(3), torch.tensor([0.0, 0.0, 0.0, 1.0]),
                       torch.ones(3))
    proj = perspective_infinite_reverse(torch.tensor(0.9), w / h,
                                        torch.tensor(0.1))
    rot = torch.tensor([0.2474, 0.0, 0.0, 0.9689]).repeat(n, 1)
    mats = trs_to_mat4(TRS(translation=torch.from_numpy(xyz), rotation=rot,
                           scale=torch.ones((n, 3))))
    mvp = torch.einsum("ij,njk->nik", proj @ view, mats)
    ph = torch.cat([torch.from_numpy(m.positions), torch.ones((vc, 1))], 1)
    clip = torch.einsum("nij,vj->nvi", mvp, ph)
    nrm = quat_rotate_vec3(rot[:, None, :], torch.from_numpy(m.normals)[None])
    tri = torch.from_numpy(m.triangles.astype(np.int64))
    return (clip[:, tri].reshape(n * tc, 3, 4),
            nrm[:, tri].reshape(n * tc, 3, 3), tc)


def test_two_pass_matches_fused():
    """eval_windows + composite_windows against fused_eval_composite (B1's
    plain version) on the same windows: winner ids equal, depth within
    1e-4 where covered (the two-pass depth carries the id bits)."""
    w, h = 256, 128
    cc, cn, tc = _cubes(w=w, h=h)
    n = cc.shape[0] // tc
    ok = torch.ones(n * tc, dtype=torch.bool)
    zrec, valid = vis.pack_planes_h(cc, cn, ok, w, h)
    zrec_c, _ = splat.compact_cluster_tris(zrec, tc)
    aabb, cl_valid, _ = vis.cluster_screen_aabbs(
        cc, torch.ones(n, dtype=torch.bool), valid, tc, w, h)
    wins = splat.build_windows(aabb, cl_valid, win_h=WIN_H, width=w,
                               height=h, budget=max(16 * n, 64))
    args = (wins["owner"], wins["meta"], wins["wvalid"])
    dep0 = torch.zeros((h, w))
    win0 = torch.full((h, w), -1.0)
    windows = splat.eval_windows(zrec_c, tc, *args, win_h=WIN_H, eval_tris=8)
    dep_a, win_a = splat.composite_windows(dep0, win0, windows, *args,
                                           win_h=WIN_H, cs=tc)
    rec_rows = splat.build_rec_rows(zrec, tc, 8)
    dep_b, win_b = splat.fused_eval_composite(dep0, win0, rec_rows, *args,
                                              win_h=WIN_H, ntri=8)
    assert torch.equal(win_a, win_b)
    hit = dep_a > 0
    assert hit.float().mean() > 0.01
    assert torch.allclose(dep_a[hit], dep_b[hit], atol=1e-4)


def _wrapper_calls():
    """Each kernel wrapper with its first tensor on the `meta` device and
    the rest on the CPU."""
    m = torch.device("meta")
    z = torch.zeros
    i32 = dict(dtype=torch.int32)
    return {
        "B1": lambda: splat.fused_eval_composite(
            z((8, 8), device=m), z(8, 8), z(1, 1, 128), z(1, **i32),
            z(1, **i32), z(1, dtype=torch.bool), win_h=8, ntri=1),
        "B2": lambda: vis.raster_visbuf(
            z((8, 8), device=m), z(8, 8), z(1, 256), z(1, 4, **i32),
            z(1, **i32), tile_h=8, tile_w=8, cs=1),
        "B3": lambda: shade.deferred_shade(
            z((19, 32, 128), device=m), z(32, 128), z(1, 8, 4),
            z(1, **i32), z(40), None, spot=False, clearcoat=False),
        "B4": lambda: raster2d.sprite_tiles(
            z((4, 32, 128), device=m), z(1, 17), z(1, **i32), z(1, **i32),
            z(1, **i32), z(4, 2, 2)),
        "B5": lambda: raster2d_splat.sprite_splat(
            z((4, 8, 128), device=m), z(1, 17), z(1, 3, **i32),
            z(1, **i32), z(1, **i32), z(1, **i32), z(4, 2, 2)),
        "B6": lambda: splat.composite_windows(
            z((8, 8), device=m), z(8, 8), z(1, 8, 128), z(1, **i32),
            z(1, **i32), z(1, dtype=torch.bool), win_h=8),
    }


@pytest.mark.parametrize("kid", sorted(_wrapper_calls()))
def test_wrapper_refuses_tensors_on_two_devices(kid):
    """A launch runs on the one device of its call's tensors: a call that
    mixes devices raises before anything is built."""
    with pytest.raises(ValueError, match="different devices"):
        _wrapper_calls()[kid]()
    assert _cuda._Loaded.lib is None


# -- the multi-device raster (parallel/) -------------------------------------


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
