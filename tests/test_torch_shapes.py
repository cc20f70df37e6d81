"""The mesh pass's general route (B7) and `raster_batched_legacy` (B8) of
bevy_tpu_torch end to end on the CPU, where the kernel wrappers run their
plain PyTorch versions, against the JAX package:

- the many_cubes twin through `backend="xla"` at the configuration of
  tests/test_goldens.py::test_golden_cubes against
  tests/goldens/cubes_f3.png, which the JAX package's XLA route locked in;
- the 3d_shapes twin (examples/torch_3d_shapes.py) against the JAX frame
  of examples/3d_shapes.py (`backend="xla"`, rendered here) and against
  tests/goldens/shapes_f1.png, which the same JAX frame must also meet
  (`REGEN_GOLDENS=1` rewrites it from that frame);
- `make_mesh_pass(plugin=None)` against `Mesh3dPlugin(backend="xla")` on
  the same world;
- `raster_batched_legacy` forward, deferred (a 19-plane G-buffer) and
  with a viewport against the JAX function in interpret mode.

Golden rule of tests/test_goldens.py: under 1% of pixels may drift by
more than 8 in any channel. The raster rule is tests/test_torch_tris.py's
(the winner's alpha, unique to each instance here, stands for the
winner)."""

import importlib
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from bevy_tpu_torch.render import mesh as tmesh  # noqa: E402
from bevy_tpu_torch.render import mesh3d as tm3d  # noqa: E402
from bevy_tpu_torch.render.plugin import frame_image  # noqa: E402

GOLDENS = ROOT / "tests" / "goldens"
SHAPES_KW = dict(width=320, height=180)


def _golden_rule(img, want):
    diff = np.abs(np.asarray(want).astype(int) - img.astype(int)).max(-1)
    assert img.shape == want.shape
    assert (diff > 8).mean() < 0.01, ((diff > 8).mean(), diff.max())
    return diff


def _png(name):
    from PIL import Image
    return np.asarray(Image.open(GOLDENS / name))


def _stats(app):
    return {k: int(v) for k, v in
            app.world.state["res"]["render_stats"].items()}


def _count_b7(monkeypatch):
    """Count the mesh pass's raster_tris calls by layout."""
    calls = []
    real = tm3d.raster_tris

    def spy(*a, **kw):
        calls.append(kw["layout"])
        return real(*a, **kw)

    monkeypatch.setattr(tm3d, "raster_tris", spy)
    return calls


def test_many_cubes_xla_route_matches_golden(monkeypatch):
    import torch_many_cubes

    calls = _count_b7(monkeypatch)
    app = torch_many_cubes.build_app(n_cubes=300, width=320, height=180,
                                     capacity=512, backend="xla",
                                     device="cpu")
    app.run(max_frames=3, dt=1 / 60)
    _golden_rule(frame_image(app), _png("cubes_f3.png"))
    assert calls == ["corners"] * 3
    assert _stats(app) == {"pair_overflow": 0, "tile_overflow": 0,
                           "fallback_clusters": 0}
    depth = app.world.state["res"]["render_target"]["depth"]
    assert (depth > 0).float().mean() > 0.02


@pytest.fixture(scope="module")
def jax_shapes():
    """The JAX package's 3d_shapes frame (XLA route), and its stats."""
    from bevy_tpu.render.plugin import frame_image as jax_frame_image

    app = importlib.import_module("3d_shapes").build_app(backend="xla",
                                                         **SHAPES_KW)
    app.update(dt=1 / 60)
    return jax_frame_image(app), _stats(app)


def test_shapes_twin_matches_jax_and_golden(jax_shapes, monkeypatch):
    import torch_3d_shapes

    jimg, jstats = jax_shapes
    if os.environ.get("REGEN_GOLDENS") == "1":
        from PIL import Image
        Image.fromarray(jimg).save(GOLDENS / "shapes_f1.png")
    golden = _png("shapes_f1.png")
    _golden_rule(jimg, golden)
    calls = _count_b7(monkeypatch)
    app = torch_3d_shapes.build_app(device="cpu", **SHAPES_KW)
    app.update(dt=1 / 60)
    img = frame_image(app)
    _golden_rule(img, jimg)
    _golden_rule(img, golden)
    assert calls == ["corners"]
    # the 256-entry tile lists of the JAX defaults overflow on the floor
    stats = _stats(app)
    assert stats["pair_overflow"] == jstats["pair_overflow"] == 0
    assert stats["tile_overflow"] == jstats["tile_overflow"]


@pytest.mark.parametrize("scene", ["shapes", "cubes"])
def test_plugin_none_pass_equals_xla_plugin(scene):
    """The same world through Mesh3dPlugin(backend="xla") and through a
    make_mesh_pass(plugin=None) put in its place (which reads the pool and
    EXPANSION resources the plugin installed) gives the same image and
    depth: the 3d_shapes world takes the expanded sub-branch both ways,
    the one-mesh cubes world the uniform sub-branch through the plugin
    and the expanded one without it."""
    import torch_3d_shapes
    import torch_many_cubes
    from bevy_tpu_torch.app.main_schedule import Render

    def build():
        if scene == "shapes":
            return torch_3d_shapes.build_app(device="cpu", **SHAPES_KW), \
                dict(tile_h=32, max_per_tile=256)
        kw = dict(tile_h=16, max_per_tile=3072)
        return torch_many_cubes.build_app(
            n_cubes=300, width=320, height=180, capacity=512,
            backend="xla", device="cpu", **kw), kw

    images = []
    for plugin_none in (False, True):
        app, kw = build()
        if plugin_none:
            entry = next(e for e in app.schedule(Render).entries
                         if e.system.name == "mesh_pass")
            entry.system = tm3d.make_mesh_pass(320, 180, plugin=None, **kw)
        app.update(dt=1 / 60)
        target = app.world.state["res"]["render_target"]
        images.append((frame_image(app), target["depth"], _stats(app)))
    (img0, dep0, st0), (img1, dep1, st1) = images
    assert st0 == st1
    assert np.array_equal(img0, img1)
    assert torch.equal(dep0, dep1)


def test_general_route_refusals():
    app_kw = dict(width=64, height=32)
    with pytest.raises(RuntimeError, match="deferred"):
        tm3d.Mesh3dPlugin(backend="xla", deferred=True).build(
            _bare_app(**app_kw))
    with pytest.raises(ValueError, match="backend"):
        tm3d.Mesh3dPlugin(backend="cuda")
    with pytest.raises(ValueError, match="group route"):
        tm3d.Mesh3dPlugin(backend="xla", shards=2)
    # the group route draws smooth meshes (on the shade records),
    # anisotropic ones since A4b and depth-biased ones since A8's rest; a
    # deferred pass refuses several cameras, naming its route and C3
    import torch_3d_shapes
    from bevy_tpu_torch.transform import transform_bundle
    app = torch_3d_shapes.build_app(device="cpu", backend="auto", **app_kw)
    app.update(dt=1 / 60)
    assert (app.world.state["res"]["render_target"]["depth"] > 0).any()
    app.world.spawn(tm3d.Mesh3d(mesh=0),
                    tm3d.MeshMaterial(anisotropy_strength=0.5),
                    *transform_bundle())
    app.update(dt=1 / 60)
    app.world.spawn(tm3d.Mesh3d(mesh=0), tm3d.MeshMaterial(depth_bias=1.0),
                    *transform_bundle())
    app.update(dt=1 / 60)
    assert (app.world.state["res"]["render_target"]["depth"] > 0).any()
    from bevy_tpu_torch.render.camera import Camera3d
    from bevy_tpu_torch.render.deferred import DeferredLightingPlugin
    dapp = _bare_app(**app_kw)
    dapp.add_plugins(tm3d.Mesh3dPlugin(deferred=True),
                     DeferredLightingPlugin())
    for _ in range(2):
        dapp.world.spawn(Camera3d(), *transform_bundle())
    with pytest.raises(NotImplementedError, match="deferred route.*C3"):
        dapp.update(dt=1 / 60)


def _bare_app(width, height):
    from bevy_tpu_torch import App
    from bevy_tpu_torch.render import RenderPlugin
    app = App(capacity=8, device="cpu")
    app.add_plugins(RenderPlugin(width=width, height=height))
    return app


def test_install_expansion_matches_the_pool():
    """install_expansion's tables, for a world of mixed meshes, gather
    each instance's own mesh: pool vertices in mesh order, triangles
    offset into the expanded vertices."""
    from bevy_tpu_torch import App
    from bevy_tpu_torch.render.mesh3d import Mesh3d

    pool = tmesh.MeshPool()
    meshes = [tmesh.uv_sphere(0.5, 8, 4), tmesh.cuboid(), tmesh.torus()]
    for m in meshes:
        pool.add(m)
    app = App(capacity=16, device="cpu")
    app.world.register_component(Mesh3d)
    order = [2, 0, 0, 1]
    for mid in order:
        app.world.spawn(Mesh3d(mesh=mid))
    tm3d.install_expansion(app.world, pool)
    res = app.world.state["res"]
    exp, slab = res[tm3d.EXPANSION], res[tmesh.MeshPool.RESOURCE]
    pos = slab["positions"][exp["vert_pool"].long()]
    tv = exp["tri_verts"].long()
    want_pos = np.concatenate([meshes[i].positions for i in order])
    want_tri = np.concatenate([meshes[i].positions[meshes[i].triangles]
                               for i in order])
    assert np.array_equal(pos.numpy(), want_pos)
    assert np.array_equal(pos[tv].numpy(), want_tri)
    rows = app.world.query_rows(Mesh3d)
    assert np.array_equal(exp["tri_inst"].numpy(), np.repeat(
        rows, [meshes[i].num_triangles for i in order]))
    assert np.array_equal(exp["vert_inst"].numpy(), np.repeat(
        rows, [meshes[i].num_vertices for i in order]))


def _sphere_batch(seed=0, ni=64):
    """64 uv_sphere(0.5, 16, 8) instances seen by a camera at the origin
    looking down -z, some straddling the near plane: clip (Ni, VC, 4),
    world normals (Ni, VC, 3), triangles, per-instance colours (unique
    alpha), emissive, metallic, roughness and inst_ok, as numpy."""
    rng = np.random.default_rng(seed)
    m = tmesh.uv_sphere(0.5, 16, 8)
    xyz = np.stack([rng.uniform(-4, 4, ni), rng.uniform(-2.5, 2.5, ni),
                    rng.uniform(-12.0, 0.4, ni)], 1)
    xyz[:4] = [[0.0, 0.0, -0.3], [0.3, 0.1, 0.1], [-0.2, 0.0, -0.05],
               [0.0, -0.3, 0.25]]          # around the eye: clipped
    f = 1.0 / np.tan(0.785398 / 2)
    aspect, near = 320 / 180, 0.1
    proj = np.array([[f / aspect, 0, 0, 0], [0, f, 0, 0], [0, 0, 0, near],
                     [0, 0, -1, 0]])
    world = m.positions[None] + xyz[:, None]
    ph = np.concatenate([world, np.ones(world.shape[:2] + (1,))], -1)
    clip = np.einsum("ij,nvj->nvi", proj, ph).astype(np.float32)
    nrm = np.broadcast_to(m.normals, clip.shape[:2] + (3,)).copy()
    col = np.concatenate([rng.uniform(0.1, 1.0, (ni, 3)),
                          rng.permutation(np.linspace(0.3, 1.0, ni))[:, None]],
                         1).astype(np.float32)
    f32 = np.float32
    return dict(clip=clip, nrm=nrm.astype(f32), triangles=m.triangles,
                inst_ok=rng.uniform(size=ni) > 0.05, col_i=col,
                emi_i=rng.uniform(0, 0.1, (ni, 3)).astype(f32),
                met_i=rng.uniform(0, 1, ni).astype(f32),
                rgh_i=rng.uniform(0.1, 1, ni).astype(f32))


@pytest.mark.parametrize("mode", ["forward", "deferred", "viewport"])
def test_raster_batched_legacy_matches_jax(mode):
    from bevy_tpu.render.mesh3d import raster_batched_legacy as jax_legacy

    b = _sphere_batch()
    deferred = mode == "deferred"
    viewport = (16.0, 8.0, 300.0, 170.0) if mode == "viewport" else None
    rng = np.random.default_rng(1)
    gbuf = rng.uniform(0, 1, (19, 180, 320)).astype(np.float32)
    color = rng.uniform(0, 1, (4, 180, 320)).astype(np.float32)
    depth = np.where(rng.uniform(size=(180, 320)) < 0.1, 0.05,
                     0.0).astype(np.float32)
    light = np.zeros(16, np.float32)
    light[:9] = [0.3, -0.8, -0.5, 1.0, 0.95, 0.9, 0.1, 0.1, 0.12]
    kw = dict(width=320, height=180, tile_h=16, tile_w=128, pairs_per_tri=2,
              max_per_tile=256, interpret=True, deferred=deferred,
              viewport=viewport)
    out = {}
    for name, to, legacy in (("port", torch.tensor, tm3d.raster_batched_legacy),
                             ("jax", jnp.asarray, jax_legacy)):
        target = SimpleNamespace(color=to(color), gbuffer=to(gbuf),
                                 depth=to(depth))
        stats = SimpleNamespace(pair_overflow=to(np.int32(0)),
                                tile_overflow=to(np.int32(0)))
        args = [to(b[k]) for k in ("clip", "nrm")] + [b["triangles"]] + \
            [to(b[k]) for k in ("inst_ok", "col_i", "emi_i")]
        legacy(*args, to(light), target, stats, met_i=to(b["met_i"]),
               rgh_i=to(b["rgh_i"]), **kw)
        fb = target.gbuffer if deferred else target.color
        out[name] = (np.asarray(fb), np.asarray(target.depth),
                     int(stats.pair_overflow), int(stats.tile_overflow))
    (col, dep, po, to_), (jcol, jdep, jpo, jto) = out["port"], out["jax"]
    assert (po, to_) == (jpo, jto)
    assert to_ > 0         # the spheres at the eye overflow 256-entry lists
    same = col[3].view(np.int32) == jcol[3].view(np.int32)
    assert same.mean() >= 0.995, same.mean()
    nw = 12 if deferred else 4
    for got, want in ((dep[same], jdep[same]),
                      (col[:nw][:, same], jcol[:nw][:, same])):
        err = np.abs(got - want)
        assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 1e-4, \
            ((err > 1e-5).mean(), err.max())
    assert np.array_equal(col[nw:], jcol[nw:])
    drawn = dep != depth
    assert 0.05 < drawn.mean() < 0.95
    if viewport is not None:
        x0, y0, x1, y1 = viewport
        px, py = np.arange(320) + 0.5, np.arange(180)[:, None] + 0.5
        assert not drawn[(px < x0) | (px >= x1) | (py < y0) | (py >= y1)] \
            .any()
