"""bevy_tpu_torch's hierarchical culls and LOD against the JAX package:
the BVH build and cull (ops/bvh.py), the QEM simplifier, the LOD chain
and its per-instance pick, and the cluster DAG and its cut
(render/meshlet.py; the host code is the JAX package's numpy, copied)
equal to the JAX package's on the same meshes; the BVH, LOD and DAG
worlds of tests/test_bvh_cull.py, test_meshlet_lod.py and
test_cluster_dag.py against the JAX package's frames stored by
tests/make_torch_goldens.py (its Pallas kernels in interpret mode),
under the golden rule (under 1% of pixels drift by more than 8), and the
reference tests' own bounds on the port (the BVH frame equals the
unculled one; the LOD and DAG frames stay near full detail).
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
    keys = json.loads((GOLDENS / "torch_goldens.json").read_text())
    assert keys[name] == ts.golden_key(name), \
        f"{name}: the scene changed; run tests/make_torch_goldens.py {name}"
    from PIL import Image
    return np.asarray(Image.open(GOLDENS / f"{name}.png")).astype(int)


def golden_rule(img, ref):
    assert img.shape == ref.shape
    d = np.abs(img - ref).max(-1)
    assert (d > 8).mean() < 0.01, ((d > 8).mean(), d.max())


def test_bvh_build_and_cull_match_jax():
    import jax.numpy as jnp

    from bevy_tpu.ops import bvh as jbvh
    from bevy_tpu.render.camera import perspective_infinite_reverse
    from bevy_tpu.render.mesh import uv_sphere
    from bevy_tpu_torch.ops import bvh as tbvh
    mesh = uv_sphere(2.0, 48, 32)
    ja = jbvh.cluster_local_aabbs(mesh.positions, mesh.triangles, 12)
    ta = tbvh.cluster_local_aabbs(mesh.positions, mesh.triangles, 12)
    assert np.array_equal(ja, ta)
    jl, jo = jbvh.build_cluster_bvh(ja)
    tl, to = tbvh.build_cluster_bvh(ta)
    assert np.array_equal(np.asarray(jo), to.numpy())
    assert all(np.array_equal(np.asarray(a), b.numpy())
               for a, b in zip(jl, tl))
    proj = np.asarray(perspective_infinite_reverse(0.785, 16 / 9, 0.1))
    mvps = []
    for z, yaw in ((2.6, 0.0), (1.0, 0.7), (-6.0, 0.2), (40.0, 3.1)):
        view = np.eye(4, dtype=np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        view[:3, :3] = [[c, 0, -s], [0, 1, 0], [s, 0, c]]
        view[2, 3] = -z
        mvps.append(proj @ view)
    mvps = np.stack(mvps).astype(np.float32)
    ncl = ja.shape[0]
    jv = jbvh.bvh_cull(jl, jo, jnp.asarray(mvps), ncl)
    tv = tbvh.bvh_cull(tl, to, torch.from_numpy(mvps), ncl)
    assert np.array_equal(np.asarray(jv), tv.numpy())
    assert 0 < int(tv.sum()) < tv.numel()
    single = tbvh.bvh_cull(tl, to, torch.from_numpy(mvps[1]), ncl)
    assert np.array_equal(single.numpy(), tv[1].numpy())


def test_bvh_world_matches_jax_and_unculled(m):
    img, _ = ts.bvh_world(m, CPU, {}, True)
    golden_rule(img, _stored("bvh_f1"))
    base, _ = ts.bvh_world(m, CPU, {}, False)
    assert np.array_equal(img, base)
    assert base[..., :3].std() > 8.0


def test_lod_chain_and_pick_match_jax():
    import jax.numpy as jnp

    from bevy_tpu.render import meshlet as jml
    from bevy_tpu.render.mesh import uv_sphere
    from bevy_tpu_torch.render import meshlet as tml
    mesh = uv_sphere(1.0, 24, 16)
    js, je = jml.simplify_mesh(mesh, mesh.num_triangles // 4)
    ts_, te = tml.simplify_mesh(mesh, mesh.num_triangles // 4)
    assert je == te
    for f in ("positions", "normals", "uvs", "triangles"):
        assert np.array_equal(getattr(js, f), getattr(ts_, f))
    jm, jerr = jml.build_lod_chain(mesh, levels=3)
    tm, terr = tml.build_lod_chain(mesh, levels=3)
    assert jerr == terr
    assert [x.num_triangles for x in jm] == [x.num_triangles for x in tm]
    assert tm[0].num_triangles > tm[1].num_triangles > tm[2].num_triangles
    dist = np.asarray([1.0, 10.0, 40.0, 200.0], np.float32)
    jl = jml.select_lod(jnp.asarray(dist), [0.0, 0.05, 0.2], fov=1.0,
                        height=480, threshold_px=1.0)
    tl = tml.select_lod(torch.from_numpy(dist), [0.0, 0.05, 0.2],
                        fov=torch.tensor(1.0), height=480, threshold_px=1.0)
    assert np.array_equal(np.asarray(jl), tl.numpy())
    assert tl[0] == 0 and tl[3] == 2


@pytest.mark.parametrize("threshold", [1.5, 10000.0], ids=["15", "coarse"])
def test_lod_world_matches_jax(m, threshold):
    img, _ = ts.lod_world(m, CPU, {}, threshold)
    golden_rule(img, _stored("lod_15" if threshold < 100 else "lod_coarse"))
    full, _ = ts.lod_world(m, CPU, {}, 0.0)
    diff = np.abs(full - img)[..., :3].max(-1)
    if threshold < 100:     # tests/test_meshlet_lod.py's bounds
        assert (diff > 40).mean() < 0.01
    else:
        assert (diff > 40).sum() > 50


def test_cluster_dag_and_cut_match_jax():
    import jax.numpy as jnp

    from bevy_tpu.render import meshlet as jml
    from bevy_tpu.render.mesh import uv_sphere
    from bevy_tpu_torch.render import meshlet as tml
    mesh = uv_sphere(radius=1.0, sectors=24, stacks=12)
    jd, ji = jml.build_cluster_dag(mesh, cs=12)
    td, ti = tml.build_cluster_dag(mesh, cs=12)
    for f in ("positions", "normals", "uvs", "triangles"):
        assert np.array_equal(getattr(jd, f), getattr(td, f))
    for k in ji:
        assert np.array_equal(ji[k], ti[k]), k
    assert (ti["own_err"] > 0).any()
    info = tml.dag_info_tensors(ti, "cpu")
    cams = np.asarray([[0.0, 0.0, 3.0], [0.0, 0.0, 30.0], [2.0, 1.0, 300.0]],
                      np.float32)
    for thr in (0.0001, 1.0):
        tcut = tml.select_dag_cut(torch.from_numpy(cams), info,
                                  torch.tensor(np.pi / 4), 720, thr)
        for i, c in enumerate(cams):
            jcut = jml.select_dag_cut(jnp.asarray(c), ji, fov=np.pi / 4,
                                      height=720, threshold_px=thr)
            assert np.array_equal(np.asarray(jcut), tcut[i].numpy())
    near = tml.select_dag_cut(torch.from_numpy(cams[0]), info,
                              torch.tensor(np.pi / 4), 720, 0.0001)
    assert np.array_equal(near.numpy(), ti["own_err"] == 0)


def test_dag_world_matches_jax_and_full_detail(m):
    img, _ = ts.dag_world(m, CPU, {}, True)
    golden_rule(img, _stored("dag_f1"))
    full, _ = ts.dag_world(m, CPU, {}, False)
    assert (np.abs(img - img[0, 0]).max(-1) > 10).mean() > 0.02
    # tests/test_cluster_dag.py's bound against full detail
    assert (np.abs(full - img).max(-1) > 24).mean() < 0.02


def test_visibility_range(m):
    """tests/test_lod_range.py: Mesh3d.lod_far culls a cube the camera is
    farther from, per camera."""
    from bevy_tpu_torch.render import frame_image
    m3, tb = m["m3"], m["tf"].transform_bundle

    def scene(lod_far):
        plugin = m3.Mesh3dPlugin()
        cube = plugin.add_mesh(m["mesh"].cuboid(1.0, 1.0, 1.0))
        app = ts._a8_app(m, CPU, 16, 96, 64, plugin)
        app.world.spawn(m["cam"].Camera3d(), *tb(translation=(0, 0, 5)))
        app.world.spawn(m3.DirectionalLight(), *tb())
        app.world.spawn(m3.Mesh3d(mesh=cube, lod_far=lod_far),
                        m3.MeshMaterial(), *tb())
        app.update(dt=1 / 60)
        return frame_image(app)[32, 48, 0] > 100

    assert scene(100.0)
    assert not scene(2.0)
