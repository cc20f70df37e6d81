"""bevy_tpu_torch's 3D screen passes against the JAX package's, on the
CPU: skybox (render/skybox.py), distance and volumetric fog (fog.py),
atmosphere (atmosphere.py), image-based light (environment.py),
irradiance volumes (irradiance.py), screen-space reflections (ssr.py),
contact shadows (contact_shadows.py), decals (decal.py) and wireframes
(wireframe.py).

Each pass's system, as each package's plugin builds it, runs on the same
inputs (tests/torch_scenes.py screen_planes: colour, reverse-z depth with
ids in its low bits, a 19- or 22-plane G-buffer; screen_camera and
screen_light rows, a masked row first), the JAX one under jax.jit.
Tolerance: rtol / atol 1e-5. The marches that make threshold decisions
(SSR hits, the contact-shadow march, the volumetric fog's shadow-map
compares) print how many pixels differ past it and hold them, and the
sRGB images, under the golden rule (under 1% of pixels). The wireframe
runs one frame of a world in each package (the JAX mesh pass on its XLA
route: the segments, not the raster, are compared) and compares the
gizmo buffer rows its system wrote.
"""

import sys
from pathlib import Path
from types import SimpleNamespace as ns

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402
from screen_parity import (  # noqa: E402
    T, call_jax, close, flips, modules, systems, targets,
)

H, W = ts.SCREEN_H, ts.SCREEN_W


def run_pass(name, module, make, seed=0, gplanes=19, extra=None,
             flip_label=None, jit=True, **views):
    """Both packages' system `name` on screen_planes(seed) and the
    screen views; returns (port colour, JAX colour)."""
    sj, st = systems(name, make, module=module)
    tj, tt = targets(seed, gplanes, **(extra or {}))
    color = tt.color.numpy().copy()
    cj, lj = ts.screen_views(jnp.asarray)
    ct, lt = ts.screen_views(T)
    pick = {"cam": (cj, ct), "light": (lj, lt)}
    call_jax(sj, jit=jit, target=tj, **{k: pick[k][0] for k in views})
    st.fn(target=tt, **{k: pick[k][1] for k in views})
    if flip_label:
        flips(tt.color, tj.color, flip_label)
    else:
        close(tt.color, tj.color)
    assert not np.array_equal(tt.color.numpy(), color), "nothing drawn"
    return tt, tj


ENV = np.random.RandomState(5).uniform(0, 2, (16, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("make", [
    lambda s: s.SkyboxPlugin(),
    lambda s: s.SkyboxPlugin(environment=ENV, brightness=0.7),
], ids=["procedural", "equirect"])
def test_skybox_matches_jax(make):
    run_pass("skybox_pass", "skybox", make, cam=1, light=1)


def test_distance_fog_matches_jax():
    run_pass("distance_fog_pass", "fog",
             lambda f: f.DistanceFogPlugin(color=(0.35, 0.4, 0.5),
                                           density=0.05))


def _shadow_maps(seed=6, n=2, size=32):
    """Two cascades: orthographic maps over the floor (x, z) with random
    reverse-z depths."""
    rng = np.random.RandomState(seed)
    vp = np.zeros((n, 4, 4), np.float32)
    for k in range(n):
        e = 6.0 * (k + 1)
        vp[k] = [[1 / e, 0, 0, 0], [0, 0, -1 / e, 0.5 / e],
                 [0, 0.05, 0, 0.5], [0, 0, 0, 1]]
    return {"shadow_depth": rng.uniform(0.4, 0.6, (n, size, size)).astype(
        np.float32), "shadow_vp": vp}


@pytest.mark.parametrize("shadows", [False, True],
                         ids=["uniform", "shadow_maps"])
def test_volumetric_fog_matches_jax(shadows):
    run_pass("volumetric_fog_pass", "fog",
             lambda f: f.VolumetricFogPlugin(density=0.04),
             extra=_shadow_maps() if shadows else None,
             flip_label="volumetric fog (shadow maps)" if shadows else None,
             cam=1, light=1)


def test_atmosphere_matches_jax():
    run_pass("atmosphere_pass", "atmo", lambda a: a.AtmospherePlugin(),
             cam=1, light=1)


def test_environment_prefilter_is_the_same():
    mj, mt = modules()
    env_j = mj["env"].EnvironmentLightPlugin.gradient_environment()
    env_t = mt["env"].EnvironmentLightPlugin.gradient_environment()
    np.testing.assert_array_equal(env_t, env_j)
    irr_j, spec_j = mj["env"].prefilter_environment(ENV)
    irr_t, spec_t = mt["env"].prefilter_environment(ENV)
    np.testing.assert_array_equal(irr_t, irr_j)
    for a, b in zip(spec_t, spec_j, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gplanes", [19, 22], ids=["19_planes", "tinted"])
def test_environment_light_matches_jax(gplanes):
    run_pass("environment_light_pass", "env",
             lambda e: e.EnvironmentLightPlugin(ENV, intensity=0.6),
             seed=7, gplanes=gplanes, cam=1)


def test_irradiance_volume_matches_jax():
    vox = np.random.RandomState(8).uniform(0.05, 1.5, (4, 2, 4, 6, 3))
    run_pass(
        "irradiance_volume_pass", "irr",
        lambda i: i.IrradianceVolumePlugin(vox, min_corner=(-4, -1, -9),
                                           max_corner=(4, 2, 3),
                                           intensity=0.8), seed=9, cam=1)


@pytest.mark.parametrize("make,gplanes", [
    (lambda s: s.SsrPlugin(steps=24, stride=0.6, thickness=0.8), 19),
    (lambda s: s.SsrPlugin(stride=0.3, max_roughness=0.6), 22),
], ids=["ssr_demo", "short_stride_tinted"])
def test_ssr_matches_jax(make, gplanes):
    run_pass("ssr_pass", "ssr", make, seed=10, gplanes=gplanes,
             flip_label="ssr", jit=False, cam=1)


def test_contact_shadows_matches_jax():
    run_pass("contact_shadows_pass", "contact",
             lambda c: c.ContactShadowsPlugin(length=1.5, steps=12),
             seed=11, flip_label="contact shadows", cam=1, light=1)


ATLAS = np.random.RandomState(12).uniform(0, 1, (16, 16, 4)).astype(
    np.float32)


def _decal_rows():
    """Four rows, the third masked off: boxes on the floor (one turned,
    one textured through an atlas rect) and one in the air."""
    q = np.array([0.0, 0.38, 0.0, 0.925], np.float32)
    q /= np.linalg.norm(q)
    return dict(
        mask=np.array([True, True, False, True]),
        translation=np.array([[0.0, -0.5, -2.5], [2.0, -1.0, -7.0],
                              [0.0, 0.0, -1.0], [-1.5, -0.5, -1.0]],
                             np.float32),
        rotation=np.array([[0, 0, 0, 1], q, [0, 0, 0, 1], [0, 0, 0, 1]],
                          np.float32),
        scale=np.array([[3.0, 3.0, 4.0], [4.0, 4.0, 6.0], [5.0, 5.0, 5.0],
                        [1.5, 2.0, 2.0]], np.float32),
        color=np.array([[1.0, 0.15, 0.1, 0.9], [0.1, 0.9, 0.2, 0.6],
                        [0.2, 0.3, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]],
                       np.float32),
        uv_min=np.array([[0, 0], [0.25, 0.25], [0, 0], [0, 0]], np.float32),
        uv_max=np.array([[0, 0], [0.75, 0.75], [0, 0], [0, 0]], np.float32))


@pytest.mark.parametrize("atlas", [False, True], ids=["colour", "atlas"])
def test_decals_match_jax(atlas):
    made = {}

    def make(d):
        made[d.__name__] = d.DecalPlugin(atlas=ATLAS if atlas else None)
        return made[d.__name__]

    sj, st = systems("decal_pass", make, module="decal")
    port_plugin = made["bevy_tpu_torch.render.decal"]
    d = _decal_rows()
    port_plugin._rows = [int(i) for i in np.flatnonzero(d["mask"])]
    views = []
    for asarray in (jnp.asarray, T):
        views.append(ns(mask=asarray(d["mask"]), global_transform=ns(
            translation=asarray(d["translation"]),
            rotation=asarray(d["rotation"]), scale=asarray(d["scale"])),
            decal=ns(color=asarray(d["color"]), uv_min=asarray(d["uv_min"]),
                     uv_max=asarray(d["uv_max"]))))
    tj, tt = targets(13)
    g = tt.gbuffer.clone()
    call_jax(sj, target=tj, decals=views[0],
             cam=ts.screen_views(jnp.asarray)[0])
    st.fn(target=tt, decals=views[1], cam=ts.screen_views(T)[0])
    close(tt.gbuffer, tj.gbuffer)
    changed = (tt.gbuffer[:3] != g[:3]).any(0)
    assert changed.float().mean() > 0.05, "the decals stamped nothing"


def _wire_world(m, app_kw):
    """examples/wireframe.py's scene at 96x64: a wireframed cube and a
    plain sphere, plus a wireframed scaled sphere and a second wireframed
    cube (two meshes, two rows of one); no frame run."""
    m3, tb = m["m3"], m["tf"].transform_bundle
    app = m["root"].App(capacity=16, **app_kw)
    plugin = m3.Mesh3dPlugin()
    cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
    sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.7, 16, 12))
    app.add_plugins(m["time"].TimePlugin(), m["tf"].TransformPlugin(),
                    m["render"].RenderPlugin(width=96, height=64), plugin,
                    m["gizmos"].GizmosPlugin(capacity=4096),
                    m["wire"].WireframePlugin(mesh_plugin=plugin))
    app.insert_resource(m3.AmbientLight(brightness=0.3))
    app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 1, 4)))
    app.world.spawn(m3.DirectionalLight(),
                    *tb(rotation=(-0.35, 0.0, 0.0, 0.94)))
    app.world.spawn(m3.Mesh3d(mesh=cube),
                    m3.MeshMaterial(base_color=(0.4, 0.5, 0.8, 1.0)),
                    m["wire"].Wireframe(),
                    *tb(translation=(-1.0, 0.0, 0.0),
                        rotation=(0.0, 0.26, 0.0, 0.966)))
    app.world.spawn(m3.Mesh3d(mesh=sphere),
                    m3.MeshMaterial(base_color=(0.8, 0.5, 0.3, 1.0)),
                    *tb(translation=(1.0, 0.0, 0.0)))
    app.world.spawn(m3.Mesh3d(mesh=sphere), m3.MeshMaterial(),
                    m["wire"].Wireframe(color=(1.0, 0.2, 0.2, 1.0),
                                        width=2.0),
                    *tb(translation=(0.5, 1.0, -1.0), scale=(0.5, 1.5, 0.5)))
    app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(),
                    m["wire"].Wireframe(),
                    *tb(translation=(1.5, -0.5, -0.5),
                        rotation=(0.3, 0.0, 0.1, 0.949)))
    return app


def _wire_query(m, app, asarray):
    """The wireframe system's query view from the world's host rows
    (global transform = transform: no parents)."""
    w = app.world
    rows = np.asarray(w.query_rows(m["m3"].Mesh3d, m["wire"].Wireframe))
    cap = 16
    mask = np.zeros(cap, bool)
    mask[rows] = True

    def col(comp, name):
        return np.asarray(w.column(comp, name)) if asarray is jnp.asarray \
            else w.column(comp, name).numpy()

    tf = m["tf"].Transform
    return ns(mask=asarray(mask), global_transform=ns(
        translation=asarray(col(tf, "translation")),
        rotation=asarray(col(tf, "rotation")),
        scale=asarray(col(tf, "scale"))),
        wireframe=ns(color=asarray(col(m["wire"].Wireframe, "color")),
                     width=asarray(col(m["wire"].Wireframe, "width"))))


def test_wireframe_segments_match_jax():
    """Each package's wireframe system on the same world: the same
    batches (one a mesh, in mesh order), end points, colours, widths and
    masks."""
    mj, mt = modules()
    out = []
    for m, kw, asarray in ((mj, {}, jnp.asarray),
                           (mt, {"device": "cpu"}, T)):
        app = _wire_world(m, kw)
        if m is mt:
            app.frame_fn()                   # the prepare hooks
        sys_ = next(e.system for e in app.schedule(m["root"].Update).entries
                    if e.system.name == "wireframe_pass")
        g = ns(_segments=[])
        sys_.fn(q=_wire_query(m, app, asarray), g=g)
        out.append(g._segments)
    segs_j, segs_t = out
    assert len(segs_t) == len(segs_j) == 2
    for st_, sj_ in zip(segs_t, segs_j):
        for a, b in zip(st_, sj_):
            close(np.asarray(a, np.float32), np.asarray(b, np.float32))
    n_edges = [len(mt["wire"].mesh_edges(mt["mesh"].cuboid(1.0, 1.0, 1.0))),
               len(mt["wire"].mesh_edges(mt["mesh"].uv_sphere(0.7, 16,
                                                               12)))]
    assert [s[0].shape[0] for s in segs_t] == [2 * n_edges[0], n_edges[1]]


def test_wireframe_draws_through_the_gizmo_pass():
    """The port's wireframed world draws its edges: the frame differs from
    the same world's without WireframePlugin at the edge pixels only, in
    the wire colours."""
    _, mt = modules()
    app = _wire_world(mt, {"device": "cpu"})
    app.update(dt=1 / 60)
    img = mt["plug"].frame_image(app).astype(int)
    stats = {k: int(v) for k, v in
             app.world.state["res"]["render_stats"].items()}
    assert stats.get("gizmo_pair_overflow", 0) == 0
    ref = _wire_world(mt, {"device": "cpu"})
    ref._plugins = [p for p in ref._plugins
                    if type(p).__name__ != "WireframePlugin"]
    ref.schedule(mt["root"].Update).entries = [
        e for e in ref.schedule(mt["root"].Update).entries
        if e.system.name != "wireframe_pass"]
    ref.update(dt=1 / 60)
    base = mt["plug"].frame_image(ref).astype(int)
    diff = np.abs(img - base).max(-1) > 0
    assert 0.01 < diff.mean() < 0.3
    # wire pixels are green (0.1, 1, 0.3) or red (1, 0.2, 0.2) over the scene
    g_or_r = (img[..., 1] > img[..., 2]) | (img[..., 0] > img[..., 2])
    assert g_or_r[diff].mean() > 0.9
