"""bevy_tpu_torch's cameras and viewports against the JAX package: the
viewport mapping of the plane setup and the cluster cull, the
split-screen worlds on both mesh routes, the per-camera views gathered
on the device, the sharded route's choice, and JAX split-screen worlds
carried across.

The JAX package's group route renders no viewport (its
`fused_eval_composite` takes the viewport as a static argument, which
the mesh pass builds from device camera columns: ROADMAP C3), so the
stored whole-frame oracle (tests/goldens/split_*.png, made by
tests/make_torch_goldens.py, keyed by torch_scenes.golden_key) is its
general route (`backend="xla"`). Frames: the golden rule (under 1% of
pixels drift by more than 8). Functions: rtol 1e-5 / atol 1e-6 on planes
(XLA's CPU backend contracts multiply-adds), validity equal.
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
VIEWPORT = (40.0, 12.0, 168.0, 84.0)


@pytest.fixture(scope="module")
def m():
    return ts.port_scene_modules()


def _stored(name):
    keys = json.loads((GOLDENS / "torch_goldens.json").read_text())
    assert keys[name] == ts.golden_key(name), \
        f"{name}: the scene changed; run tests/make_torch_goldens.py {name}"
    from PIL import Image
    return np.asarray(Image.open(GOLDENS / f"{name}.png")).astype(int)


def golden_rule(img, ref):
    assert img.shape == ref.shape
    d = np.abs(img - ref).max(-1)
    assert (d > 8).mean() < 0.01, ((d > 8).mean(), d.max())


def _corners(seed, n=24, cs=12):
    """Clip-space corners (n, cs, 3, 4) of random triangles around the
    view, some across the near plane, and their normals."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-1.5, 1.5, (n, cs, 3, 4)).astype(np.float32)
    c[..., 3] = rng.uniform(0.5, 4.0, (n, cs, 3))
    c[:2, :, 0, 3] = -0.2
    c[..., 2] = 0.1
    nrm = rng.normal(size=(n, cs, 3, 3)).astype(np.float32)
    return c, nrm


@pytest.mark.parametrize("viewport", [None, VIEWPORT],
                         ids=["full", "viewport"])
def test_pack_planes_h_and_cluster_aabbs_viewport_match_jax(viewport):
    import jax.numpy as jnp

    from bevy_tpu.ops import raster3d_visbuf as jvis
    from bevy_tpu_torch.ops import raster3d_visbuf as tvis
    cc, cn = _corners(3)
    valid = np.ones(cc.shape[:2], bool)
    mat = np.random.RandomState(4).uniform(0, 1, cc.shape[:2] + (15,)) \
        .astype(np.float32)
    jz, js, jv = jvis.pack_planes_h(jnp.asarray(cc), jnp.asarray(cn),
                                    jnp.asarray(valid), 192, 96,
                                    viewport=viewport,
                                    materials=jnp.asarray(mat))
    tvp = None if viewport is None else torch.tensor(viewport)
    tz, ts_, tv = tvis.pack_planes_h(torch.from_numpy(cc),
                                     torch.from_numpy(cn),
                                     torch.from_numpy(valid), 192, 96,
                                     viewport=tvp, build_srec=True,
                                     materials=torch.from_numpy(mat))
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert tv.numpy().mean() > 0.2
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    ok = np.random.RandomState(5).uniform(size=cc.shape[0]) < 0.8
    ja, jc, jm = jvis.cluster_screen_aabbs(
        jnp.asarray(cc.reshape(-1, 3, 4)), jnp.asarray(ok), jv.reshape(-1),
        12, 192, 96, viewport=viewport)
    ta, tc, tm = tvis.cluster_screen_aabbs(
        torch.from_numpy(cc), torch.from_numpy(ok), tv.reshape(-1), 12, 192,
        96, viewport=tvp)
    assert np.array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-6)
    if viewport is not None:      # straddlers take the whole rect
        behind = (cc[..., 3] <= 1e-6).reshape(cc.shape[0], -1).any(1)
        assert np.allclose(ta.numpy()[behind], VIEWPORT)


@pytest.mark.parametrize("route", ["group", "general"])
@pytest.mark.parametrize("kind", ["two", "layers", "four"])
def test_split_world_matches_jax(m, kind, route):
    """Each camera one pass in ascending `order`, on its viewport; the
    group route scissors B1 and B2, the general route B7."""
    from bevy_tpu_torch.render import mesh3d
    seen = []
    fused = mesh3d.fused_eval_composite

    def spy(*a, **kw):
        seen.append(a[6])
        return fused(*a, **kw)

    mesh3d.fused_eval_composite = spy
    try:
        img, app = ts.split_world(
            m, CPU, {} if route == "group" else {"backend": "xla"}, kind)
    finally:
        mesh3d.fused_eval_composite = fused
    golden_rule(img, _stored(f"split_{kind}"))
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0 == int(stats["tile_overflow"])
    if route == "group":
        cams = 4 if kind == "four" else 2
        assert len(seen) == 2 * cams * (3 if kind == "four" else 1)
        assert all(s is not None and s.shape == (4,) for s in seen)
    if kind == "layers":
        # the right camera sees nothing: its half stays the clear colour
        # although the left camera's cube reaches past the split
        right = img[:, img.shape[1] // 2:]
        red = (right[..., 0] > 150) & (right[..., 0] > right[..., 2] + 50)
        assert red.sum() == 0
        left = img[:, :img.shape[1] // 2]
        assert ((left[..., 0] > 150) & (left[..., 0] > left[..., 2] + 50)
                ).sum() > 100


def test_two_camera_pass_reads_nothing_back(m, monkeypatch):
    """The mesh pass of a two-camera frame makes no host read: every
    camera row is gathered on the device (camera.camera_row), never
    indexed with a 0-d tensor, and nothing is turned into a Python
    value. (B1's and B2's plain versions, which read the host, stand in
    for the kernels only on the CPU; they are stubbed out here.)"""
    _, app = ts.split_world(m, CPU, {}, "two")
    from bevy_tpu_torch.render import mesh3d
    state = app.world.state
    step = app.frame_fn()
    step(state)
    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def zero_d(idx):
        items = idx if isinstance(idx, tuple) else (idx,)
        return any(isinstance(i, torch.Tensor) and i.dim() == 0
                   for i in items)

    def guarded_get(self, idx):
        if zero_d(idx):
            raise AssertionError("0-d tensor index: a host read")
        return get(self, idx)

    def guarded_put(self, idx, v):
        if zero_d(idx):
            raise AssertionError("0-d tensor index: a host read")
        return put(self, idx, v)

    def refuse(*a, **k):
        raise AssertionError("host read in the mesh pass")

    calls = []
    inner = mesh3d._views

    def views(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(mesh3d, "_views", views)
    # the kernels' plain versions read the host (on the card the kernels
    # run instead): stand-ins that return the buffers unchanged
    monkeypatch.setattr(mesh3d, "fused_eval_composite",
                        lambda d, w, *a, **k: (d, w))
    monkeypatch.setattr(mesh3d, "raster_visbuf",
                        lambda d, w, *a, **k: (d, w))
    sysfn = next(e.system for e in app.schedule(mesh3d.Render).build_order()
                 if e.system.name == "mesh_pass")
    monkeypatch.setattr(torch.Tensor, "__getitem__", guarded_get)
    monkeypatch.setattr(torch.Tensor, "__setitem__", guarded_put)
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    sysfn.run(app.world.state, app.world)
    monkeypatch.undo()
    assert calls == [1]


def test_sharded_route_draws_viewport_groups_unsharded(m, monkeypatch):
    """As the JAX package's, a flat-forward group rasters sharded only
    without a viewport (nor occlusion culling, nor a material_fn)."""
    from bevy_tpu_torch.parallel import make_mesh
    from bevy_tpu_torch.parallel import raster as par_raster
    calls = []
    inner = par_raster.sharded_instance_raster

    def spy(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(par_raster, "sharded_instance_raster", spy)
    shards = {"shards": make_mesh(devices=["cpu"] * 2), "window_budget": 2048}
    img, _ = ts.split_world(m, CPU, shards, "two")
    assert calls == []
    golden_rule(img, _stored("split_two"))
    ts.bias_world(m, CPU, shards, 0.0)
    assert len(calls) == 1


@pytest.mark.parametrize("kind", ["two", "glass"])
def test_load_world_carries_jax_worlds(m, kind):
    """interop.load_world carries a JAX split-screen world (Camera3d's
    vp_min, vp_max, order and layers) and a JAX transmissive world (the
    transmission fields) across: the port renders the loaded state as
    it renders the world it builds itself."""
    import importlib

    import jax

    from bevy_tpu_torch.interop import load_world
    from bevy_tpu_torch.render import frame_image
    jm = {k: importlib.import_module(f"bevy_tpu{v}")
          for k, v in ts.SCENE_MODULES.items()}
    captured = {}

    def run(mods, app_kw, pkw, *args):
        orig = ts._run
        ts._run = lambda m_, app, frames: (captured.setdefault(
            id(mods), app), None)[1] or (None, app)
        try:
            (ts.split_world(mods, app_kw, pkw, "two") if kind == "two"
             else ts.glass_world(mods, app_kw, pkw, "tint"))
        finally:
            ts._run = orig
        return captured[id(mods)]

    japp = run(jm, {}, {"backend": "xla"} if kind == "two" else
               {"backend": "pallas_interpret"})
    tapp = run(m, CPU, {})
    tapp2 = run({**m, "_": 0}, CPU, {})
    load_world(tapp2.world, jax.device_get(japp.world.state))
    cams = tapp2.world.query_rows(m["cam"].Camera3d)
    for f in ("vp_min", "vp_max", "order", "layers"):
        assert np.array_equal(
            tapp2.world.column(m["cam"].Camera3d, f).numpy()[cams],
            tapp.world.column(m["cam"].Camera3d, f).numpy()[cams])
    for f in ("specular_transmission", "ior", "base_color"):
        assert np.array_equal(
            tapp2.world.column(m["m3"].MeshMaterial, f).numpy(),
            tapp.world.column(m["m3"].MeshMaterial, f).numpy())
    tapp.update(dt=1 / 60)
    tapp2.update(dt=1 / 60)
    a, b = frame_image(tapp).astype(int), frame_image(tapp2).astype(int)
    assert np.array_equal(a, b)
    assert (np.abs(a - a[0, 0]).max(-1) > 8).mean() > 0.02
