"""bevy_tpu_torch's per-object motion vectors (render/mesh3d.py
motion_delta, write_motion, Mesh3dPlugin(motion_vectors=True)), SSAA
(RenderPlugin(ssaa=N) and the resolve in frame_image) and whole
screen-pass frames against the JAX package.

Rendering the JAX worlds live takes minutes on a CPU (interpret-mode
Pallas), so their output is stored in tests/goldens/ by
`python tests/make_torch_goldens.py post_f1 taa_f3 ssaa2_f1 fog_f1
ssr_f1`, every JAX plugin with backend="pallas_interpret"; each stored
image carries torch_scenes.golden_key (a hash of its scene builder,
asserted here). The port renders the same worlds (tests/torch_scenes.py
post_world: SSAO, bloom, depth of field, CAS, FXAA, ACES; aa_world "taa":
motion vectors + TAA over 3 frames of a drifting cube and camera, "ssaa":
a 2 x 2 grid resolved in frame_image; fog_world: distance + volumetric
fog; ssr_world: deferred, SSR) and each image must stay within the golden
rule of tests/test_goldens.py (under 1% of pixels drift by more than 8).
The TAA world's motion planes after the third frame are stored too
(taa_f3_motion.npz): the validity planes may differ only at a few edge
pixels (a covered pixel can flip where a triangle's edge meets its
centre), and the vectors agree to 1e-3 px where both are valid.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402
from screen_parity import T, close  # noqa: E402

GOLDENS = ROOT / "tests" / "goldens"
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def m():
    return ts.port_scene_modules()


def _stored(name):
    keys = json.loads((GOLDENS / "torch_goldens.json").read_text())
    assert keys.get(name) == ts.golden_key(name), \
        f"the scene changed: python tests/make_torch_goldens.py {name}"
    from bevy_tpu_torch.gltf import decode_png
    return np.asarray(decode_png((GOLDENS / f"{name}.png").read_bytes()),
                      np.int64)


def _golden_rule(img, ref, label):
    assert img.shape == ref.shape, (img.shape, ref.shape)
    diff = np.abs(img - ref).max(-1)
    frac = float((diff > 8).mean())
    print(f"{label}: {frac:.4%} of pixels drift > 8, max channel diff "
          f"{int(diff.max())}, {int((diff > 0).sum())} pixels differ")
    assert frac < 0.01
    return diff


@pytest.mark.parametrize("name", ["post_f1", "taa_f3", "ssaa2_f1", "fog_f1",
                                  "ssr_f1"])
def test_frame_matches_stored_jax(m, name):
    fn, args = ts.GOLDEN_SCENES[name]
    img, app = fn(m, CPU, {}, *args)
    _golden_rule(img, _stored(name), name)
    # the frame drew more than the clear colour
    assert len(np.unique(img.reshape(-1, 4), axis=0)) > 8
    if name == "taa_f3":
        stored = np.load(GOLDENS / "taa_f3_motion.npz")["motion"]
        motion = app.world.state["res"]["render_target"]["motion"].numpy()
        flip = (motion[2] > 0.5) != (stored[2] > 0.5)
        both = (motion[2] > 0.5) & (stored[2] > 0.5)
        print(f"taa_f3 motion: {int(flip.sum())} validity flips, "
              f"{int(both.sum())} pixels valid in both, max |d| "
              f"{np.abs(motion[:2] - stored[:2])[:, both].max():.3g} px")
        assert flip.sum() <= 12 and both.sum() > 200
        np.testing.assert_allclose(motion[:2][:, both], stored[:2][:, both],
                                   atol=1e-3, rtol=0)
        # the cube drifted: its vectors are not zero
        assert np.abs(stored[:2][:, both]).max() > 0.5


def test_motion_delta_matches_jax():
    from bevy_tpu.math.quat import quat_normalize as qn_j
    from bevy_tpu.render.mesh3d import motion_delta as md_j
    from bevy_tpu_torch.render.mesh3d import motion_delta as md_t
    rng = np.random.RandomState(0)
    n = 40
    args = []
    for _ in range(2):
        q = np.asarray(qn_j(jnp.asarray(rng.normal(size=(n, 4)).astype(
            np.float32))))
        args += [rng.normal(size=(n, 3)).astype(np.float32) * 3, q,
                 rng.uniform(0.3, 2.0, (n, 3)).astype(np.float32)]
    close(md_t(*[T(a) for a in args]),
          md_j(*[jnp.asarray(a) for a in args]))
    # prev_world = A world + b takes this frame's instance points back
    d = md_t(*[T(a) for a in args]).numpy()
    from bevy_tpu_torch.math.quat import quat_rotate_vec3
    p = rng.normal(size=(n, 3)).astype(np.float32)

    def place(t, r, s):
        return (quat_rotate_vec3(T(r), T(p) * T(s)) + T(t)).numpy()

    cur, prev = place(*args[3:]), place(*args[:3])
    back = np.einsum("nij,nj->ni", d[:, :9].reshape(n, 3, 3), cur) + d[:, 9:]
    np.testing.assert_allclose(back, prev, atol=2e-4)


def test_static_world_has_zero_motion_at_won_pixels(m):
    """A cube and camera that stop after the first frame: two frames on,
    the vectors are ~0 where the mesh pass won (under 0.05 px: the f32
    round trip through the inverse of the reverse-z infinite projection)
    and the validity plane is the coverage."""
    img, app = ts.aa_world(m, CPU, {}, "taa", frames=1)
    # stop the drift
    upd = app.schedule(m["root"].Update)
    upd.entries = [e for e in upd.entries
                   if e.system.name not in ("drift_mesh", "drift_camera")]
    upd._order = None
    app.update(dt=1 / 60)
    app.update(dt=1 / 60)
    tgt = app.world.state["res"]["render_target"]
    valid = tgt["motion"][2] > 0.5
    assert torch.equal(valid, tgt["depth"] > 0)
    assert float(tgt["motion"][:2][:, valid].abs().max()) < 0.05


def test_ssaa_resolve_matches_jax(m):
    """frame_image's 2 x 2 box resolve in linear space, then sRGB, on the
    same buffer in both packages."""
    import bevy_tpu
    from bevy_tpu.render import RenderPlugin as RPJ
    from bevy_tpu.render.plugin import frame_image as fi_j
    rng = np.random.RandomState(1)
    fb = rng.uniform(0, 1.2, (4, 48, 64)).astype(np.float32)
    app_j = bevy_tpu.App(capacity=4)
    app_j.add_plugins(RPJ(width=32, height=24, ssaa=2))
    app_j.world.state["res"]["render_target"]["color"] = jnp.asarray(fb)
    app_t = m["root"].App(capacity=4, **CPU)
    rp = m["render"].RenderPlugin(width=32, height=24, ssaa=2)
    app_t.add_plugins(rp)
    assert (rp.width, rp.height, rp.out_width, rp.out_height) == \
        (64, 48, 32, 24)
    st = app_t.world.state["res"]["render_target"]
    assert st["color"].shape == (4, 48, 64) and int(st["ssaa"]) == 2
    st["color"] = T(fb)
    a, b = m["plug"].frame_image(app_t), np.asarray(fi_j(app_j))
    assert a.shape == b.shape == (24, 32, 4)
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_motion_vectors_size_with_ssaa_and_general_route_clears(m):
    """Mesh3dPlugin(motion_vectors=True) builds: the motion planes take
    the SSAA grid's size; the general route (backend="xla") writes no
    vector (every pixel falls back to the camera reprojection)."""
    img, app = ts.aa_world(m, CPU, {}, "ssaa", frames=1)
    assert img.shape == (72, 128, 4)
    for kw, want_valid in (({}, True), ({"backend": "xla"}, False)):
        _, app = ts.aa_world(m, CPU, kw, "taa", frames=1)
        tgt = app.world.state["res"]["render_target"]
        assert tgt["motion"].shape == (3, 72, 128)
        assert bool((tgt["motion"][2] > 0.5).any()) == want_valid
        assert set(app.world.state["res"]["mesh_motion"]) == \
            {"t", "r", "s", "vp"}
