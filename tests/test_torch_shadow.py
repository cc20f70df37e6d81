"""bevy_tpu_torch's shadow maps (render/shadow.py, spot_shadow.py,
point_shadow.py), raster_batched's depth-only mode and the deferred
path's specular tint and anisotropy, against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
and its port:

- shadow_factor (XLA in the JAX package) on identical numpy inputs: equal
  at every pixel whose decisions lie more than 1e-6 from a threshold (the
  reverse-z compare `occluder <= z + bias` and the cascade bound 0.999)
  and more than 1e-4 texels from a texel edge; at the others the two may
  differ, since rsqrt, the matrix products and the bias's norms round an
  ulp apart in XLA and PyTorch.

Rendering the JAX worlds live takes one to three minutes each on a CPU
(interpret-mode Pallas), so the JAX package's output is stored in
tests/goldens/ by tests/make_torch_goldens.py, every JAX plugin with
backend="pallas_interpret" (never "auto": that is the XLA raster). Each
stored image carries torch_scenes.golden_key, a hash of its scene
builder and arguments (goldens/torch_goldens.json), and the test asserts
it, so a changed scene fails instead of meeting a stale image. The
tolerances sit near what the port measured against them:

- one depth-only raster_batched pass of a fixed caster set
  (torch_scenes.caster_pass, some casters across the near plane):
  coverage flips at no more than 4 pixels (0 measured; an exact-edge
  pixel may flip), depth within rtol 1e-5 / atol 1e-6 where both cover
  (XLA fuses multiply-adds in the plane setup);
- the directional (2 cascades), spot and point worlds of tests/
  test_shadow.py, test_spot_shadow.py and test_point_shadow.py
  (torch_scenes.shadow_world): every channel within 2 of the stored
  sRGB image and no more than 12 pixels differing at all (at most 1 and
  2 measured);
- the scenes of test_specular_tint.py and test_anisotropy.py
  (material_world) in linear colour, since the tinted sphere's highlight
  clips in sRGB (white and red tints differ there at 4 pixels by 1):
  within rtol 2e-3 / atol 1e-4. The GGX lobe at roughness 0.15 turns an
  ulp of N.H into about 1e-3 of its peak (measured: at most 1.2e-3
  relative on the tinted sphere, 3.4e-4 on the anisotropic one); a
  dropped tint moves the highlight by up to 88%.

The reference tests' own behaviours then run on the port: an occluder
casts a shadow, several cascades match one, no occluder no shadow, the
spot and point lights light and shadow the floor, an unshadowed point
light matches the binned kernel, the G-buffer stays at 19 planes without
tint, a tint reddens a dielectric's highlight and leaves metals, zero
anisotropy matches the isotropic lobe. And the port's own: the maps are
cleared every frame (a moved caster's map equals a fresh world's), a
tinted world's structure_version holds still, the depth-only mode builds
no shade record, the row-band shade carries the shadow plane, and the
forward route draws tinted and anisotropic materials as the JAX
package's resolve_forward does (it reads neither).
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


def _stored(name):
    """The JAX package's stored output `name`, once its key matches the
    scene that the port renders now."""
    keys = json.loads((GOLDENS / "torch_goldens.json").read_text())
    assert keys.get(name) == ts.golden_key(name), \
        f"the scene changed: python tests/make_torch_goldens.py {name}"
    if (GOLDENS / f"{name}.npz").exists():
        stored = np.load(GOLDENS / f"{name}.npz")
        return stored[stored.files[0]]
    from bevy_tpu_torch.gltf import decode_png
    return np.asarray(decode_png((GOLDENS / f"{name}.png").read_bytes()),
                      np.int64)


RTOL_LINEAR, ATOL_LINEAR = 2e-3, 1e-4


def _near_stored(img, ref):
    assert img.shape == ref.shape
    diff = np.abs(img - ref).max(-1)
    assert diff.max() <= 2 and (diff > 0).sum() <= 12, \
        (int(diff.max()), int((diff > 0).sum()))


# -- against the JAX package ---------------------------------------------------


def _decisions_f64(world, depth, vp, size, bias=2e-3):
    """The reference's shadow_factor decisions in float64: per pixel, the
    distance of each cascade's |x|, |y| to 0.999, of the taps' texel
    coordinates to a texel edge and of each tap's compare to its
    threshold; True where any lies within the test's margins."""
    n = vp.shape[0]
    ph = np.concatenate([world, np.ones(world.shape[:2] + (1,))], -1)
    clip = np.einsum("nij,hwj->nhwi", vp.astype(np.float64), ph)
    x, y, z = clip[..., 0], clip[..., 1], clip[..., 2]
    near = (np.abs(np.abs(x) - 0.999) < 1e-6) | \
        (np.abs(np.abs(y) - 0.999) < 1e-6)
    ambiguous = near.any(0)
    inside = (np.abs(x) < 0.999) & (np.abs(y) < 0.999)
    first = np.argmax(inside, 0)
    hh, ww = np.indices(first.shape)
    xs, ys, zs = x[first, hh, ww], y[first, hh, ww], z[first, hh, ww]
    fx, fy = (xs * 0.5 + 0.5) * size, (0.5 - ys * 0.5) * size
    for f in (fx, fy):
        ambiguous |= np.abs(f - np.round(f)) < 1e-4
    s_xy = np.linalg.norm(vp[:, 0, :3].astype(np.float64), axis=-1)
    s_z = np.linalg.norm(vp[:, 2, :3].astype(np.float64), axis=-1)
    b = bias + (4.0 * s_z / (size * s_xy))[first]
    for dy, dx in ((0, 0), (1, 0), (0, 1), (1, 1)):
        ix = np.clip(np.trunc(fx).astype(np.int64) + dx, 0, size - 1)
        iy = np.clip(np.trunc(fy).astype(np.int64) + dy, 0, size - 1)
        ambiguous |= np.abs(depth[first, iy, ix] - (zs + b)) < 1e-6
    return ambiguous & inside.any(0)


def test_shadow_factor_matches_jax():
    import jax.numpy as jnp
    from bevy_tpu.math.quat import quat_normalize
    from bevy_tpu.render import shadow as jshadow
    from bevy_tpu_torch.render import shadow as tshadow

    rng = np.random.RandomState(3)
    size, h, w = 64, 40, 56
    rot = np.array(quat_normalize(jnp.asarray([-0.35, 0.3, 0.1, 0.88])))
    focus = np.asarray([0.5, 1.0, -0.5], np.float32)
    vp = np.stack([np.asarray(jshadow.light_view_proj(
        jnp.asarray(rot), jnp.asarray(focus), e, 20.0))
        for e in (3.0, 9.0)]).astype(np.float32)
    world = rng.uniform(-12, 12, (h, w, 3)).astype(np.float32)
    world[..., 1] = rng.uniform(-1, 3, (h, w))
    # maps near the pixels' own depths, so about half the taps occlude
    clip = np.einsum("nij,hwj->nhwi", vp, np.concatenate(
        [world, np.ones((h, w, 1), np.float32)], -1))
    depth = rng.uniform(np.percentile(clip[..., 2], 10),
                        np.percentile(clip[..., 2], 90),
                        (2, size, size)).astype(np.float32)
    j = np.asarray(jshadow.shadow_factor(jnp.asarray(world),
                                         jnp.asarray(depth),
                                         jnp.asarray(vp)))
    t = tshadow.shadow_factor(torch.from_numpy(world),
                              torch.from_numpy(depth),
                              torch.from_numpy(vp)).numpy()
    amb = _decisions_f64(world.astype(np.float64), depth, vp, size)
    assert amb.mean() < 0.05
    assert 0.2 < (j < 1.0).mean() < 0.9          # both sides exercised
    bad = (j != t) & ~amb
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:5])
    # and the port's own light_view_proj to the matrix products' ulps
    tvp = tshadow.light_view_proj(torch.from_numpy(rot),
                                  torch.from_numpy(focus), 3.0, 20.0)
    np.testing.assert_allclose(tvp.numpy(), vp[0], rtol=1e-6, atol=1e-6)


def _port_caster_depth():
    from types import SimpleNamespace

    from bevy_tpu_torch.render import mesh as tmesh
    from bevy_tpu_torch.render import mesh3d as tm3d
    clip = torch.from_numpy(ts.caster_pass())
    ni, vc = clip.shape[:2]
    batch = dict(tm3d.uniform_batch(tmesh.cuboid(1.0, 1.0, 1.0), "cpu"),
                 quads=None)
    z = torch.zeros((), dtype=torch.int32)
    st = SimpleNamespace(pair_overflow=z, tile_overflow=z,
                         fallback_clusters=z)
    size = ts.CASTER_MAP
    t = SimpleNamespace(depth=torch.zeros((size, size)))
    tm3d.raster_batched(clip, None, batch, torch.ones(ni, dtype=torch.bool),
                        None, None, t, st, width=size, height=size,
                        tile_h=16, tile_w=128, depth_only=True)
    return t.depth.numpy(), st


def test_depth_only_pass_matches_jax():
    ref = _stored("shadow_caster_depth")
    got, st = _port_caster_depth()
    assert int(st.pair_overflow) == 0 and int(st.tile_overflow) == 0
    assert int(st.fallback_clusters) > 0        # near-plane casters to B2
    cov_r, cov_t = ref > 0, got > 0
    assert cov_r.mean() > 0.1
    assert (cov_r != cov_t).sum() <= 4, int((cov_r != cov_t).sum())
    both = cov_r & cov_t
    np.testing.assert_allclose(got[both], ref[both], rtol=1e-5, atol=1e-6)


def _render_stored_scene(m, name):
    """The port's frame of the stored output `name`."""
    fn, args = ts.GOLDEN_SCENES[name]
    return fn(m, args[0], CPU, {}, *args[1:])


@pytest.mark.parametrize("name", ["shadow_dir_c2", "shadow_spot",
                                  "shadow_point"])
def test_shadow_world_matches_jax(m, name):
    img, app = _render_stored_scene(m, name)
    _near_stored(img, _stored(name))
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0
    assert int(stats["tile_overflow"]) == 0


@pytest.mark.parametrize("name", ["tint_red", "aniso_09"])
def test_material_world_matches_jax(m, name):
    _, color, app = _render_stored_scene(m, name)
    gbuf = app.world.state["res"]["render_target"]["gbuffer"]
    assert gbuf.shape[0] == (22 if name == "tint_red" else 19)
    # the shade records' G-buffer write leaves it contiguous, as B3 takes it
    assert gbuf.is_contiguous()
    np.testing.assert_allclose(color, _stored(name), rtol=RTOL_LINEAR,
                               atol=ATOL_LINEAR)


# -- the reference tests' behaviours, on the port ------------------------------


def test_occluder_casts_shadow(m):
    lit, _ = ts.shadow_world(m, "dir", CPU, {}, shadows=False)
    shadowed, _ = ts.shadow_world(m, "dir", CPU, {})
    diff = lit[..., 1] - shadowed[..., 1]
    assert diff.max() > 40, diff.max()
    assert 10 < (diff > 40).sum() < lit.shape[0] * lit.shape[1] * 0.5


@pytest.mark.parametrize("cascades", [2, 3])
def test_cascaded_shadows_match_single(m, cascades):
    one, _ = ts.shadow_world(m, "dir", CPU, {}, cascades=1)
    many, _ = ts.shadow_world(m, "dir", CPU, {}, cascades=cascades)
    dark1, darkn = one[..., 1] < 110, many[..., 1] < 110
    assert np.mean(dark1 != darkn) < 0.04, np.mean(dark1 != darkn)
    assert darkn.sum() > 20


def test_no_occluder_no_shadow(m):
    a, _ = ts.shadow_world(m, "dir", CPU, {}, occluder=False)
    b, _ = ts.shadow_world(m, "dir", CPU, {}, shadows=False, occluder=False)
    assert (np.abs(a[..., 1] - b[..., 1]) > 25).mean() < 0.02


@pytest.mark.parametrize("kind", ["spot", "point"])
def test_light_pools_on_floor_and_occluder_shadows(m, kind):
    img, _ = ts.shadow_world(m, kind, CPU, {}, occluder=False)
    assert img[48, 80][:3].sum() > img[48, 8][:3].sum() + \
        (60 if kind == "spot" else 40)
    occ, _ = ts.shadow_world(m, kind, CPU, {})
    assert (img[..., :3].sum(-1) - occ[..., :3].sum(-1)).max() > 60


def test_point_occluder_shadows_sideways(m):
    lit, _ = ts.shadow_world(m, "point", CPU, {}, occluder=False)
    occ, _ = ts.shadow_world(m, "point", CPU, {}, occluder_at=(2.5, 2.5, 0))
    diff = lit[..., :3].sum(-1) - occ[..., :3].sum(-1)
    assert diff[:, diff.shape[1] // 2:].max() > 60


def test_unshadowed_point_matches_binned_kernel(m):
    a, _ = ts.shadow_world(m, "point", CPU, {}, shadows=False,
                           occluder=False)
    b, _ = ts.shadow_world(m, "point", CPU, {}, occluder=False)
    assert np.abs(a - b).mean() < 14.0


def test_gbuffer_stays_19_planes_without_tint(m):
    _, _, app = ts.material_world(m, "tint", CPU, {}, (1.0, 1.0, 1.0))
    assert app.world.state["res"]["render_target"]["gbuffer"].shape[0] == 19


def test_tint_reddens_dielectric_highlight_not_metals(m):
    def frame(tint, metallic=0.0):
        return ts.material_world(m, "tint", CPU, {}, tint, metallic)[1]

    white, red = frame((1.0, 1.0, 1.0)), frame((1.0, 0.05, 0.05))
    lum = white[..., :3].sum(-1)
    hot = lum >= np.percentile(lum, 99.5)
    assert hot.sum() > 4
    dg = (white[..., 1] - red[..., 1])[hot].mean()
    dr = np.abs(white[..., 0] - red[..., 0])[hot].mean()
    assert dg > 0.02 and dg > dr * 2.0, (dg, dr)
    mid = (lum > np.percentile(lum, 55)) & (lum < np.percentile(lum, 75))
    assert np.abs(white - red)[..., :3][mid].mean() < dg * 0.5
    metal = np.abs(frame((1.0, 1.0, 1.0), 1.0) -
                   frame((1.0, 0.05, 0.05), 1.0))[..., :3].mean()
    assert metal < 0.01, metal


def test_zero_anisotropy_matches_isotropic(m):
    iso, _, _ = ts.material_world(m, "aniso", CPU, {}, 0.0)
    forced, _, app = ts.material_world(m, "aniso", CPU, {}, 0.0,
                                       hidden_aniso=True)
    from bevy_tpu_torch.render.deferred import DeferredLightingPlugin
    dl = next(p for p in app._plugins
              if isinstance(p, DeferredLightingPlugin))
    assert dl._flags["anisotropy"]          # the anisotropic variant ran
    assert np.abs(forced - iso).max() <= 4.0


@pytest.mark.parametrize("rot", [0.0, np.pi / 2])
def test_anisotropy_changes_lobe(m, rot):
    iso, _, _ = ts.material_world(m, "aniso", CPU, {}, 0.0)
    an0, _, _ = ts.material_world(m, "aniso", CPU, {}, 0.9)
    an, _, _ = ts.material_world(m, "aniso", CPU, {}, 0.9, rot=rot)
    assert np.abs(an - iso).max() > 20
    if rot:
        assert np.abs(an - an0).max() > 20


# -- the port's own --------------------------------------------------------


MAPS = {"dir": "shadow_depth", "spot": "spot_shadow_depth",
        "point": "point_shadow_depth"}


@pytest.mark.parametrize("kind", ["dir", "spot", "point"])
def test_shadow_maps_cleared_every_frame(m, kind):
    """A caster moved between frames (a data change, no structural one):
    the second frame's map equals a fresh world's with the caster there."""
    from bevy_tpu_torch.render.mesh3d import Mesh3d
    from bevy_tpu_torch.transform import transform_bundle

    a, b = (1.5, 1.8, 0.5), (-1.0, 1.2, -1.5)
    _, app = ts.shadow_world(m, kind, CPU, {}, occluder_at=a)
    version = app.world.structure_version
    row = int(app.world.query_rows(Mesh3d)[-1])
    app.world.insert(row, *transform_bundle(translation=b))
    app.update(dt=1 / 60)
    assert app.world.structure_version == version
    _, fresh = ts.shadow_world(m, kind, CPU, {}, occluder_at=b)
    key = MAPS[kind]
    moved = app.world.state["res"]["render_target"][key]
    assert torch.equal(moved, fresh.world.state["res"]["render_target"][key])


def test_tinted_world_keeps_its_structure_version(m):
    _, _, app = ts.material_world(m, "tint", CPU, {}, (1.0, 0.3, 0.3))
    version = app.world.structure_version
    for _ in range(3):
        app.update(dt=1 / 60)
    assert app.world.structure_version == version
    assert app.world.state["res"]["render_target"]["gbuffer"].shape[0] == 22


def test_depth_only_builds_no_shade_records(monkeypatch):
    """A smooth mesh's depth-only pass takes the plane records alone and
    writes the depth a full forward pass writes."""
    from types import SimpleNamespace

    from bevy_tpu_torch.render import mesh as tmesh
    from bevy_tpu_torch.render import mesh3d as tm3d
    sphere = tmesh.uv_sphere(0.8, 12, 8)
    batch = tm3d.uniform_batch(sphere, "cpu")
    assert not batch["flat"]
    rng = np.random.RandomState(5)
    ni = 3
    pos = torch.from_numpy(sphere.positions)
    off = torch.from_numpy(rng.uniform([-1.5, -1, -6], [1.5, 1, -3],
                                       (ni, 3)).astype(np.float32))
    v = pos[None] + off[:, None]
    f = 1.5
    clip = torch.stack([f * v[..., 0], f * v[..., 1],
                        torch.full_like(v[..., 0], 0.1), -v[..., 2]], -1)
    nrm = torch.from_numpy(sphere.normals)[None].expand(ni, -1, -1)
    z = torch.zeros((), dtype=torch.int32)

    def run(depth_only):
        st = SimpleNamespace(pair_overflow=z, tile_overflow=z,
                             fallback_clusters=z)
        t = SimpleNamespace(depth=torch.zeros((64, 96)),
                            color=torch.zeros((4, 64, 96)))
        mat = torch.ones((ni, 15))
        tm3d.raster_batched(clip, None if depth_only else nrm, batch,
                            torch.ones(ni, dtype=torch.bool),
                            None if depth_only else mat,
                            None if depth_only else torch.zeros(16), t, st,
                            width=96, height=64, depth_only=depth_only)
        return t

    calls = []
    pack = tm3d.pack_planes_h

    def spy(*a, **kw):
        calls.append(kw.get("build_srec", False))
        return pack(*a, **kw)

    monkeypatch.setattr(tm3d, "pack_planes_h", spy)
    only = run(True)
    full = run(False)
    assert calls == [False, True]
    assert (only.depth > 0).float().mean() > 0.05
    assert torch.equal(only.depth, full.depth)
    assert not only.color.any()             # the resolve never ran


def test_row_band_shade_carries_the_shadow_plane(m):
    from bevy_tpu_torch.parallel import make_mesh
    one, _ = ts.shadow_world(m, "dir", CPU, {})
    bands, _ = ts.shadow_world(m, "dir", CPU, {},
                               shards=make_mesh(devices=["cpu"] * 2))
    assert np.array_equal(one, bands)


def test_forward_route_draws_tint_and_anisotropy(m):
    """The forward group route reads neither field (the JAX package's
    resolve_forward shades Lambert + ambient): the same image."""
    def frame(**mat):
        m3, tb = m["m3"], m["tf"].transform_bundle
        app = m["root"].App(capacity=8, device="cpu")
        plugin = m3.Mesh3dPlugin()
        sphere = plugin.add_mesh(m["mesh"].uv_sphere(0.6, 16, 8))
        cube = plugin.add_mesh(m["mesh"].cuboid(0.8, 0.8, 0.8))
        app.add_plugins(m["time"].TimePlugin(), m["tf"].TransformPlugin(),
                        m["render"].RenderPlugin(width=96, height=64), plugin)
        app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 3)))
        app.world.spawn(m3.DirectionalLight(),
                        *tb(rotation=(-0.4, 0.2, 0.0, 0.89)))
        for mid, x in ((sphere, -0.6), (cube, 0.6)):
            app.world.spawn(m3.Mesh3d(mesh=mid), m3.MeshMaterial(**mat),
                            *tb(translation=(x, 0.0, 0.0)))
        app.update(dt=1 / 60)
        return m["plug"].frame_image(app)

    plain = frame()
    assert (plain != plain[0, 0]).any(-1).mean() > 0.1
    fancy = frame(specular_tint=(1.0, 0.2, 0.2), anisotropy_strength=0.7,
                  anisotropy_rotation=0.4)
    assert np.array_equal(plain, fancy)

