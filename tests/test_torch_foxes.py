"""bevy_tpu_torch's many_foxes slice (animation, skinning, glTF, the
shade-record raster) against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
and its port:

- quaternions, clip sampling (plain and crossfaded), joint composition,
  skin matrices, inverse bindposes, the player clocks over a wrap and a
  negative speed, the animation event system and graph blends: atol 1e-5
  (inverse bindposes and the fox rig's arrays 1e-6);
- the glTF loader on tests/test_gltf_skin.py's synthetic .glb: meshes,
  skins, inverse bindposes, weights and clips equal to 1e-6, the PNG
  decoded bit for bit (the port decodes PNG with zlib; PIL, which the
  JAX loader uses, stands as the reference here);
- group-route worlds on the shade records (tests/torch_scenes.py
  shade_record_world): smooth spheres, textured (the material of
  tests/test_mesh_texture.py), parallax-occluded (tests/test_parallax.py),
  normal-mapped with channel textures, a lightmap and a uv transform,
  against the JAX package run with backend="pallas_interpret" (its
  kernels in interpret mode, never the XLA raster that "auto" picks on a
  CPU); smooth spheres beside flat cubes without an atlas against the
  JAX general route's XLA raster; both under the golden rule of
  tests/test_goldens.py (under 1% of pixels drift by more than 8);
- the slice end to end: examples/torch_many_foxes.py at the golden
  configuration of tests/test_goldens.py::test_golden_foxes against
  tests/goldens/foxes_f8.png (the JAX package's Pallas output, so no JAX
  fox frame runs here), overflows 0, and a bit-exact replay.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tests"))

from bevy_tpu import animation as janim  # noqa: E402
from bevy_tpu.animation import graph as jgraph  # noqa: E402
from bevy_tpu.math import quat as jquat  # noqa: E402

from bevy_tpu_torch import animation as tanim  # noqa: E402
from bevy_tpu_torch.animation import graph as tgraph  # noqa: E402
from bevy_tpu_torch.math import quat as tquat  # noqa: E402

FOX_GOLDEN = ROOT / "tests" / "goldens" / "foxes_f8.png"
ATOL = 1e-5


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(N(a), N(b), rtol=0, atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# -- quaternions -------------------------------------------------------------


@pytest.mark.parametrize("op", ["normalize", "from_axis_angle", "dot",
                                "nlerp", "slerp"])
def test_quat_ops(op):
    rng = np.random.RandomState(1)
    a, b = _quats(rng, 64), _quats(rng, 64)
    b[:8] = a[:8] * 0.9999            # nearly parallel (slerp's nlerp side)
    b[8:16] = -a[8:16]                # opposite hemisphere (the flip)
    t = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    if op == "normalize":
        q = rng.normal(size=(64, 4)).astype(np.float32)
        q[0] = 0.0                    # zero length stays zero
        j, p = jquat.quat_normalize(jnp.asarray(q)), tquat.quat_normalize(T(q))
    elif op == "from_axis_angle":
        ax = a[:, :3] / np.linalg.norm(a[:, :3], axis=-1, keepdims=True)
        ang = rng.uniform(-7, 7, 64).astype(np.float32)
        j = jquat.quat_from_axis_angle(jnp.asarray(ax), jnp.asarray(ang))
        p = tquat.quat_from_axis_angle(T(ax), T(ang))
    elif op == "dot":
        j, p = jquat.quat_dot(jnp.asarray(a), jnp.asarray(b)), \
            tquat.quat_dot(T(a), T(b))
    elif op == "nlerp":
        j = jquat.quat_nlerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
        p = tquat.quat_nlerp(T(a), T(b), T(t))
    else:
        j = jquat.quat_slerp(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(t[:, 0]))
        p = tquat.quat_slerp(T(a), T(b), T(t[:, 0]))
    _close(j, p)


# -- skeletons, clips, poses -------------------------------------------------


def _rig(name):
    """(parents, rest_t, rest_r, rest_s) of a test skeleton."""
    rng = np.random.RandomState(2)
    if name == "chain":
        return [-1, 0], [[0, 0, 0], [1, 0, 0]], None, None
    parents = [-1, 0, 1, 0, 3, 3, 5]
    t = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    return parents, t, _quats(rng, 7), \
        rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32)


@pytest.mark.parametrize("rig", ["chain", "rotated_scaled", "fox"])
def test_skeleton_rest_and_inverse_bind(rig):
    if rig == "fox":
        import many_foxes
        import torch_many_foxes
        js, ts = many_foxes.build_rig()[0], torch_many_foxes.build_rig()[0]
    else:
        spec = _rig(rig)
        js, ts = janim.Skeleton(*spec), tanim.Skeleton(*spec)
    for a, b in zip(js.rest_global(), ts.rest_global()):
        _close(a, b, 1e-6)
    _close(js.inverse_bind(), ts.inverse_bind(), 1e-6)


def test_fox_rig_and_clip_match_jax():
    """The twin's rig, run cycle and baked clip equal the JAX example's."""
    import many_foxes
    import torch_many_foxes
    jsk, jmesh, jw = many_foxes.build_rig()
    tsk, tmesh, tw = torch_many_foxes.build_rig()
    for a, b in ((jmesh.positions, tmesh.positions),
                 (jmesh.normals, tmesh.normals), (jw, tw)):
        _close(a, b, 1e-6)
    assert np.array_equal(jmesh.triangles, tmesh.triangles)
    jc, tc = many_foxes.run_clip(jsk), torch_many_foxes.run_clip(tsk)
    for a, b in ((jc.t, tc.t), (jc.r, tc.r), (jc.s, tc.s)):
        _close(a, b, 1e-6)
    jd = janim.bake_clips([jc, jc])
    td = tanim.bake_clips([tc, tc], "cpu")
    for a, b in zip(jd, td):
        _close(a, b, 1e-6)


def _clips(rng, j, n_clips=3):
    clips = []
    for c in range(n_clips):
        tr = rng.normal(size=(j, 3)).astype(np.float32)
        q0, q1 = _quats(rng, j), _quats(rng, j)
        s0 = rng.uniform(0.5, 1.5, (j, 3)).astype(np.float32)
        dur = 0.5 + 0.3 * c

        def pose(t, tr=tr, q0=q0, q1=q1, s0=s0, dur=dur):
            a = t / dur
            q = q0 * (1 - a) + q1 * a
            return {"translation": tr * (1 + a), "rotation":
                    q / np.linalg.norm(q, axis=-1, keepdims=True),
                    "scale": s0 * (1 + 0.2 * a)}
        clips.append((dur, pose, 24.0 + 6 * c))
    return clips


def _both_clips(rng, j):
    specs = _clips(rng, j)
    jc = [janim.AnimationClip(*s) for s in specs]
    tc = [tanim.AnimationClip(*s) for s in specs]
    return jc, tc, janim.bake_clips(jc), tanim.bake_clips(tc, "cpu")


@pytest.mark.parametrize("stage", ["sample", "blended", "compose", "skin"])
def test_pose_pipeline(stage):
    rng = np.random.RandomState(3)
    spec = _rig("rotated_scaled")
    js, ts = janim.Skeleton(*spec), tanim.Skeleton(*spec)
    _, _, jd, td = _both_clips(rng, 7)
    n = 40
    player = {"clip": rng.randint(-1, 4, n).astype(np.int32),
              "time": rng.uniform(-0.2, 1.5, n).astype(np.float32),
              "prev_clip": rng.randint(0, 3, n).astype(np.int32),
              "prev_time": rng.uniform(0, 1, n).astype(np.float32),
              "blend": rng.uniform(0, 1, n).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in player.items()}
    tp = {k: T(v) for k, v in player.items()}
    if stage == "sample":
        j = janim.sample_pose(*jd, jp["clip"], jp["time"])
        p = tanim.sample_pose(*td, tp["clip"], tp["time"])
    else:
        j = janim.sample_pose_blended(*jd, jp)
        p = tanim.sample_pose_blended(*td, tp)
        if stage in ("compose", "skin"):
            j, p = janim.compose_joints(js, j), tanim.compose_joints(ts, p)
        if stage == "skin":
            j, p = janim.skin_matrices(js, j), tanim.skin_matrices(ts, p)
    if isinstance(p, dict):
        for k in ("translation", "rotation", "scale"):
            _close(j[k], p[k])
    else:
        _close(j, p)


def _graph(pkg):
    g = pkg.AnimationGraph()
    mask = np.asarray([1, 1, 0, 1, 0, 1, 1], np.float32)
    a = g.add_clip(0)
    b = g.add_clip(1, weight=0.7, mask=mask)
    c = g.add_clip(2, weight=0.4)
    blend = g.add_blend([a, b, c], weight=0.9)
    d = g.add_clip(1, weight=0.5)
    g.add_additive(blend, [d], weight=1.0)
    return g


def test_graph_sample_blend_add_mask():
    rng = np.random.RandomState(4)
    _, _, jd, td = _both_clips(rng, 7)
    n = 24
    cols = {"times": rng.uniform(0, 1.2, (n, 16)).astype(np.float32),
            "weights": rng.uniform(0, 1, (n, 16)).astype(np.float32)}
    cols["weights"][:4, :3] = 0.0          # all-zero blend weights
    rows = np.arange(n)[::-1].copy()
    j = _graph(jgraph).sample(*jd, SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in cols.items()}), jnp.asarray(rows))
    p = _graph(tgraph).sample(*td, SimpleNamespace(
        **{k: T(v) for k, v in cols.items()}), T(rows))
    for k in ("translation", "rotation", "scale"):
        _close(j[k], p[k])


# -- the player clocks, events and graph clocks in an App ---------------------


def _clock_app(pkg, device=None):
    """A world of players (wrapping, negative, paused, crossfading) with
    advance_players, the event system and a graph player."""
    mods = _pkg_modules(pkg)
    kw = {} if device is None else {"device": device}
    app = mods["App"](capacity=16, **kw)
    app.add_plugins(mods["TimePlugin"]())
    anim, graph = mods["anim"], mods["graph"]
    durs = [0.5, 0.8, 0.3]
    events = [(0, 0.1, 7), (0, 0.45, 8), (1, 0.0, 9), (1, 0.79, 10),
              (2, 0.2, 11)]
    g = _graph(graph)
    app.add_systems(mods["Update"], anim.advance_players(durs))
    app.add_systems(mods["Update"], anim.make_animation_event_system(
        durs, events, budget=16), after="advance_animations")
    app.add_systems(mods["Update"], graph.advance_graph_players(durs, g))
    app.world.add_message(anim.AnimationEvent)
    clip = np.asarray([0, 1, 2, 0, 1, 2, 0, 1], np.int32)
    speed = np.asarray([1.0, -1.0, 2.5, -3.0, 0.0, 1.0, 7.0, -0.4],
                       np.float32)
    app.world.spawn_batch([
        anim.AnimationPlayer(
            clip=clip, speed=speed,
            time=np.linspace(0.0, 0.7, 8).astype(np.float32),
            prev_clip=clip[::-1].copy(),
            prev_time=np.linspace(0.3, 0.0, 8).astype(np.float32),
            blend=np.linspace(0.0, 1.0, 8).astype(np.float32),
            playing=np.arange(8) != 5),
        g.default_player(speeds=[1.0, -2.0, 0.5, 1.5, 3.0] + [0.0] * 11,
                         times=[0.1, 0.7, 0.2, 0.0, 0.4] + [0.0] * 11)], 8)
    return app


def _pkg_modules(pkg):
    import importlib
    m = {name: importlib.import_module(f"{pkg}{mod}") for name, mod in (
        ("root", ""), ("anim", ".animation"), ("graph", ".animation.graph"),
        ("time", ".time"), ("sched", ".app.main_schedule"))}
    return dict(App=m["root"].App, TimePlugin=m["time"].TimePlugin,
                Update=m["sched"].Update, anim=m["anim"], graph=m["graph"])


def test_player_clocks_events_and_graph_clocks():
    """advance_players wraps by a floor modulo (negative speeds wrap to
    the clip's end), the event system fires on the same crossings, and
    the graph clocks wrap per node."""
    japp, tapp = _clock_app("bevy_tpu"), _clock_app("bevy_tpu_torch", "cpu")
    fired = 0
    for dt in [0.05] * 6 + [0.33, 0.21, 0.5]:
        japp.update(dt=dt)
        tapp.update(dt=dt)
        js, ts = japp.world.state, tapp.world.state
        for comp in ("animation_player", "animation_graph_player"):
            for f, col in js["comp"][comp]["f"].items():
                _close(col, ts["comp"][comp]["f"][f])
        jm, tm = js["msg"]["animation_event"], ts["msg"]["animation_event"]
        assert np.array_equal(N(jm["count"]), N(tm["count"]))
        assert int(jm["cur"]) == int(tm["cur"])
        for f in ("entity", "code"):
            assert np.array_equal(N(jm["f"][f]), N(tm["f"][f]))
        fired += int(N(tm["count"]).sum())
    assert fired > 0
    t = N(ts["comp"]["animation_player"]["f"]["time"])[:8]
    assert np.all((t >= 0) & (t < np.asarray([0.5, 0.8, 0.3] * 3)[:8]))


def test_start_transition_in_port_world():
    from bevy_tpu_torch.animation import AnimationPlayer, start_transition
    app = _clock_app("bevy_tpu_torch", "cpu")
    app.update(dt=0.05)
    start_transition(app.world, 2, clip=1, duration=0.2)
    p = app.world.get(2, AnimationPlayer)
    assert int(p.clip) == 1 and int(p.prev_clip) == 2
    assert float(p.blend) == 0.0 and abs(float(p.blend_rate) - 5.0) < 1e-6
    app.update(dt=0.05)
    p = app.world.get(2, AnimationPlayer)
    assert abs(float(p.blend) - 0.25) < 1e-6


# -- glTF -------------------------------------------------------------------


def test_gltf_loader_matches_jax(tmp_path):
    from test_gltf_skin import _build_skinned_glb

    from bevy_tpu.gltf import load_glb as jload
    from bevy_tpu_torch.gltf import load_glb as tload

    path = tmp_path / "arm.glb"
    _build_skinned_glb(path)
    jd, td = jload(path), tload(path)
    assert len(jd.primitives) == len(td.primitives) == 1
    for jp, tp in zip(jd.primitives, td.primitives):
        for f in ("positions", "normals", "uvs"):
            _close(getattr(jp.mesh, f), getattr(tp.mesh, f), 1e-6)
        assert np.array_equal(jp.mesh.triangles, tp.mesh.triangles)
        assert np.array_equal(jp.base_color_image, tp.base_color_image)
        assert (jp.base_color, jp.metallic, jp.roughness) == \
            (tp.base_color, tp.metallic, tp.roughness)
    jsk, jm, jw, jc = jd.skinned_bundle()
    tsk, tm, tw, tc = td.skinned_bundle()
    assert np.array_equal(jsk.parents, tsk.parents)
    for a, b in ((jsk.rest_t, tsk.rest_t), (jsk.rest_r, tsk.rest_r),
                 (jsk.rest_s, tsk.rest_s),
                 (jsk.inverse_bind(), tsk.inverse_bind()), (jw, tw)):
        _close(a, b, 1e-6)
    assert len(jc) == len(tc) == 1
    for a, b in ((jc[0].t, tc[0].t), (jc[0].r, tc[0].r), (jc[0].s, tc[0].s)):
        _close(a, b, 1e-6)


def _png_chunk(kind, body):
    import struct
    import zlib
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _png_all_filters(img):
    """An RGB PNG whose rows use filters 0-4 in turn (the encoder of the
    PNG spec, section 9)."""
    import struct
    import zlib
    h, w, c = img.shape
    raw, prev = b"", np.zeros(w * c, np.int32)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        f = y % 5
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = 0 * line
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p0 = left + prev - upleft
            pa, pb, pc = (np.abs(p0 - v) for v in (left, prev, upleft))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([f]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = line
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
        _png_chunk(b"IDAT", zlib.compress(raw)) + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P", "1",
                                  "filters"])
def test_decode_png_matches_pil(mode):
    import io

    from PIL import Image

    from bevy_tpu_torch.gltf import decode_png
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (13, 21, 4)).astype(np.uint8)
    img[4:9] = np.linspace(0, 255, 21)[None, :, None].astype(np.uint8)
    if mode == "filters":
        data = _png_all_filters(img[..., :3])
    else:
        pil = Image.fromarray(img, "RGBA")
        if mode == "P":
            pil = pil.convert("RGB").quantize(7)
            pil.info["transparency"] = 2
        elif mode != "RGBA":
            pil = pil.convert(mode)
        buf = io.BytesIO()
        pil.save(buf, format="PNG",
                 **({"transparency": 2} if mode == "P" else {}))
        data = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert np.array_equal(decode_png(data), want)


# -- group-route worlds on the shade records ---------------------------------


# the JAX oracle of each case: "atlas" through its group route's kernels
# in interpret mode, live (a minute of Pallas lowering, so one world, one
# mesh); "smooth" (no atlas; spheres on the shade records beside flat
# cubes) through the same group route, its output stored by
# tests/make_torch_goldens.py (smooth_srec.png, keyed to the scene), and
# through its XLA general route, live, which shades smooth meshes with the
# same per-pixel Lambert + ambient + emissive (and lowers in seconds)
WORLD_ORACLE = {"atlas": "pallas_interpret", "smooth": "stored",
                "smooth-xla": "xla"}


@pytest.mark.parametrize("case", ["atlas", "smooth", "smooth-xla"])
def test_group_route_shade_record_world_matches_jax(case):
    import importlib
    import json

    from torch_scenes import (
        SCENE_MODULES, golden_key, port_scene_modules, shade_record_world)
    kind = case.split("-")[0]
    if WORLD_ORACLE[case] == "stored":
        from PIL import Image
        gold = Path(__file__).resolve().parent / "goldens"
        keys = json.loads((gold / "torch_goldens.json").read_text())
        assert keys["smooth_srec"] == golden_key("smooth_srec")
        jimg = np.asarray(Image.open(gold / "smooth_srec.png")).astype(int)
    else:
        jmods = {k: importlib.import_module(f"bevy_tpu{v}")
                 for k, v in SCENE_MODULES.items()}
        jimg, _ = shade_record_world(jmods, kind, {},
                                     {"backend": WORLD_ORACLE[case]})
    timg, tapp = shade_record_world(port_scene_modules(), kind,
                                    {"device": "cpu"}, {})
    assert jimg.shape == timg.shape
    bg = timg[0, 0]
    assert (np.abs(timg - bg).max(-1) > 8).mean() > 0.05   # drew something
    diff = np.abs(jimg - timg).max(-1)
    assert (diff > 8).mean() < 0.01, ((diff > 8).mean(), diff.max())
    stats = tapp.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0
    assert int(stats["tile_overflow"]) == 0


# -- skinned meshes ----------------------------------------------------------


def test_skinned_graph_and_morph_targets():
    """SkinnedMeshPlugin with an animation graph and morph targets on the
    CPU: the pose follows the graph (the image moves frame to frame) and
    morph weights move vertices."""
    import torch_many_foxes
    from bevy_tpu_torch import App
    from bevy_tpu_torch.render import RenderPlugin
    from bevy_tpu_torch.render.camera import Camera3d
    from bevy_tpu_torch.render.mesh3d import DirectionalLight, MeshMaterial
    from bevy_tpu_torch.render.plugin import frame_image
    from bevy_tpu_torch.render.skinned import (
        MorphWeights, SkinnedMesh3d, SkinnedMeshPlugin)
    from bevy_tpu_torch.time import TimePlugin
    from bevy_tpu_torch.transform import TransformPlugin, transform_bundle

    sk, mesh, w = torch_many_foxes.build_rig()
    clip = torch_many_foxes.run_clip(sk)
    g = tgraph.AnimationGraph()
    g.add_blend([g.add_clip(0), g.add_clip(0, weight=0.5)])
    morph = np.zeros((2, mesh.num_vertices, 3), np.float32)
    morph[0, :, 1] = 0.5 * (mesh.positions[:, 1] > 0.9)   # raise the back
    app = App(capacity=8, device="cpu")
    app.add_plugins(TimePlugin(), TransformPlugin(),
                    RenderPlugin(width=96, height=64),
                    SkinnedMeshPlugin(sk, mesh, w, [clip], graph=g,
                                      morph_targets=morph))
    app.world.spawn(Camera3d(), *transform_bundle(translation=(0, 1, 4)))
    app.world.spawn(DirectionalLight(), *transform_bundle(
        rotation=(-0.38, 0.0, 0.0, 0.92)))
    for wt in (0.0, 1.0):
        app.world.spawn(SkinnedMesh3d(), g.default_player(),
                        MorphWeights(weights=[wt] + [0.0] * 7),
                        MeshMaterial(base_color=(0.8, 0.5, 0.2, 1.0)),
                        *transform_bundle(translation=(2.4 * wt - 1.2, 0, 0)))
    app.update(dt=1 / 30)
    img0 = frame_image(app).astype(int)
    app.update(dt=0.2)
    img1 = frame_image(app).astype(int)
    cov = np.abs(img0 - img0[0, 0]).max(-1) > 8
    assert cov.mean() > 0.02
    assert (np.abs(img0 - img1).max(-1) > 8).mean() > 0.002
    # the morphed fox (right) stands taller than the plain one (left)
    ys_l = np.where(cov[:, :48].any(1))[0]
    ys_r = np.where(cov[:, 48:].any(1))[0]
    assert ys_r.min() < ys_l.min()


def test_torch_many_foxes_matches_golden():
    """The slice end to end: the golden configuration of
    tests/test_goldens.py::test_golden_foxes, 8 frames on the CPU, against
    foxes_f8.png; overflows 0; a second app, its world carried across
    from the JAX example's (interop.load_world), replays the first 3
    frames bit for bit."""
    import jax
    from PIL import Image

    import many_foxes
    import torch_many_foxes
    from bevy_tpu_torch.interop import load_world
    from bevy_tpu_torch.render.plugin import frame_image

    kw = dict(n_foxes=9, width=256, height=144, capacity=32,
              camera=(0.0, 3.0, 10.0), camera_pitch=-0.25, device="cpu")
    app = torch_many_foxes.build_app(**kw)
    app.run(max_frames=3, dt=1 / 60)
    img3 = frame_image(app)
    app.run(max_frames=5, dt=1 / 60)
    img = frame_image(app).astype(int)
    golden = np.asarray(Image.open(FOX_GOLDEN)).astype(int)
    assert img.shape == golden.shape
    diff = np.abs(golden - img).max(-1)
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
    assert (np.abs(img - img[2, 2]).max(-1) > 8).mean() > 0.02
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0
    assert int(stats["tile_overflow"]) == 0
    replay = torch_many_foxes.build_app(**kw)
    jkw = {k: v for k, v in kw.items() if k != "device"}
    load_world(replay.world,
               jax.device_get(many_foxes.build_app(**jkw).world.state))
    replay.run(max_frames=3, dt=1 / 60)
    assert np.array_equal(frame_image(replay), img3)
    assert not np.array_equal(img3, img)               # the foxes run
