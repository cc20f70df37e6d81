"""bevy_tpu_torch's transparent and transmissive phases against the JAX
package: weighted-blended OIT (eval_oit_windows, accumulate_oit,
oit_blend; plain PyTorch, as the JAX package's are XLA) function by
function on seeded inputs, and the OIT, transmission and volume
transmission worlds whole.

Functions: eval_oit_windows within rtol 1e-5 / atol 1e-6 (the same
per-window slot order; XLA contracts multiply-adds); accumulate_oit and
the OIT frames' inputs within rtol 1e-5 / atol 1e-5: the port adds the
windows with one index_add_ and multiplies the revealage with one
scatter product, the JAX package merges them one after another, so the
sums round in another order. Frames: the golden rule (under 1% of pixels
drift by more than 8) against the JAX package's outputs stored by
tests/make_torch_goldens.py (its Pallas kernels in interpret mode;
rendered live they take a minute or more each). The JAX OIT phase reads
an undefined module name `cl_extra` (ROADMAP C3): the stored OIT frames
were rendered with it set to None, what its opaque phase passes without
a BVH or DAG.
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
H, W, CS, WIN_H = 40, 256, 4, 16


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


def _oit_inputs(seed=0, ncl=6, nwin=20):
    """Records of ncl clusters of CS planes (random edges around a few
    pixels' footprints, z in (0, 1)), flat colours with alpha, windows
    over them (some overlapping, the last few invalid) and an opaque
    depth."""
    rng = np.random.RandomState(seed)
    zrec = np.zeros((ncl * CS, 20), np.float32)
    for t in range(ncl * CS):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        for j in range(3):
            a = rng.normal(size=2)
            a /= np.linalg.norm(a)
            r = rng.uniform(4, 30)
            zrec[t, 3 * j:3 * j + 3] = [a[0], a[1], -(a[0] * cx + a[1] * cy)
                                        - r]
        zrec[t, 9:12] = [rng.uniform(-1e-3, 1e-3), rng.uniform(-1e-3, 1e-3),
                         rng.uniform(0.1, 0.9)]
        zrec[t, 12] = t
    frec = np.zeros((ncl * CS, 8), np.float32)
    frec[:, :3] = rng.uniform(0, 1, (ncl * CS, 3))
    frec[:, 3] = rng.uniform(0.2, 0.8, ncl * CS)
    owner = rng.randint(0, ncl, nwin).astype(np.int32)
    col = rng.randint(0, W // 128, nwin)
    y0 = rng.randint(0, H - WIN_H + 1, nwin)
    meta = (col * 2048 + y0).astype(np.int32)
    wvalid = np.arange(nwin) < nwin - 3
    depth = rng.uniform(0.0, 0.6, (H, W)).astype(np.float32)
    return zrec, frec, owner, meta, wvalid, depth


def test_oit_functions_match_jax():
    import jax.numpy as jnp

    from bevy_tpu.ops import raster3d_splat as jsplat
    from bevy_tpu_torch.ops import raster3d_splat as tsplat
    zrec, frec, owner, meta, wvalid, depth = _oit_inputs()
    J = jnp.asarray
    T = torch.from_numpy
    jwin = jsplat.eval_oit_windows(J(zrec), J(frec), CS, J(owner), J(meta),
                                   J(wvalid), J(depth), win_h=WIN_H)
    twin = tsplat.eval_oit_windows(T(zrec), T(frec), CS, T(owner), T(meta),
                                   T(wvalid), T(depth), win_h=WIN_H)
    np.testing.assert_allclose(twin.numpy(), np.asarray(jwin), rtol=1e-5,
                               atol=1e-6)
    assert (twin[:, 3] > 0).float().mean() > 0.05       # fragments landed
    rng = np.random.RandomState(1)
    oit = np.concatenate([rng.uniform(0, 1, (4, H, W)),
                          rng.uniform(0.5, 1, (1, H, W))]).astype(np.float32)
    jo = jsplat.accumulate_oit(J(oit), jwin, J(meta), J(wvalid))
    to = tsplat.accumulate_oit(T(oit), twin, T(meta), T(wvalid))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(to.numpy(), oit)
    color = rng.uniform(0, 1, (4, H, W)).astype(np.float32)
    jb = jsplat.oit_blend(J(color), jo)
    tb = tsplat.oit_blend(T(color), to)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["panes", "blend"])
def test_oit_world_matches_jax(m, kind):
    img, app = ts.oit_world(m, CPU, {}, kind)
    golden_rule(img, _stored(f"oit_{kind}"))
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0 == int(stats["tile_overflow"])
    if kind == "panes":
        # tests/test_oit.py's behaviours: the panes tint the backdrop, the
        # pane behind the backdrop does not show, outside them nothing
        # changes
        base, _ = ts.oit_world(m, CPU, {}, "panes")
        assert np.array_equal(base, img)


def test_oit_is_order_independent(m):
    """Swapping the submission order of two overlapping panes changes the
    image by at most 2 (tests/test_oit.py's bound)."""
    from bevy_tpu_torch.render import frame_image

    def scene(order):
        m3, tb = m["m3"], m["tf"].transform_bundle
        plugin = m3.Mesh3dPlugin()
        cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
        app = ts._a8_app(m, CPU, 16, 160, 96, plugin)
        app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 8.0)))
        app.world.spawn(m3.DirectionalLight(illuminance=1.0),
                        *tb(rotation=(-0.38, 0.0, 0.0, 0.92)))
        app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(
            base_color=(0.9, 0.9, 0.9, 1.0)), *tb(
                translation=(0.0, 0.0, -2.0), scale=(10.0, 8.0, 0.5)))
        panes = [((1.0, 0.1, 0.1, 0.5), 2.0), ((0.1, 0.1, 1.0, 0.5), 3.0)]
        for color, z in panes[::order]:
            app.world.spawn(m3.Mesh3d(mesh=cube),
                            m3.MeshMaterial(base_color=color),
                            *tb(translation=(0.0, 0.0, z),
                                scale=(3.0, 2.0, 0.1)))
        app.update(dt=1 / 60)
        return frame_image(app).astype(int)

    a, b = scene(1), scene(-1)
    assert np.abs(a - b).max() <= 2
    assert np.abs(a[48, 80] - a[5, 5]).max() > 20


@pytest.mark.parametrize("kind", ["tint", "volume", "translucent"])
def test_glass_world_matches_jax(m, kind):
    img, app = ts.glass_world(m, CPU, {}, kind)
    golden_rule(img, _stored(f"glass_{kind}"))
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0 == int(stats["tile_overflow"])
    cy, cx = 48, img.shape[1] // 2
    if kind == "volume":
        # tests/test_volume_transmission.py: Beer-Lambert with a green
        # attenuation colour turns the white wall green
        assert img[cy, cx, 1] > img[cy, cx, 0] + 40


def test_transmissive_rows_leave_the_opaque_phase(m):
    """A transmissive material draws in the transmission pass only: with
    specular_transmission 0 the panel is opaque (test_transmission.py's
    third case), and without TransmissionPlugin a transmissive row draws
    nowhere, as in the JAX package."""
    from bevy_tpu_torch.render import frame_image
    m3, tb = m["m3"], m["tf"].transform_bundle

    def scene(st, plugin_on):
        plugin = m3.Mesh3dPlugin()
        cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
        extra = [m["trans"].TransmissionPlugin(plugin)] if plugin_on else []
        app = ts._a8_app(m, CPU, 16, 160, 96, plugin, *extra)
        app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 5)))
        app.world.spawn(m3.DirectionalLight(), *tb())
        app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(
            base_color=(0.1, 0.9, 0.1, 1.0)), *tb(
                translation=(0.0, 0.0, -2.0), scale=(8.0, 5.0, 0.2)))
        app.world.spawn(m3.Mesh3d(mesh=cube), m3.MeshMaterial(
            base_color=(0.2, 0.2, 0.8, 1.0), specular_transmission=st),
            *tb(translation=(0.0, 0.0, 1.0), scale=(2.0, 2.0, 0.1)))
        app.update(dt=1 / 60)
        return frame_image(app).astype(int)

    solid = scene(0.0, True)
    assert solid[48, 80, 2] > solid[48, 80, 1]
    hidden = scene(1.0, False)
    assert hidden[48, 80, 1] > hidden[48, 80, 2]
