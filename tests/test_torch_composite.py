"""The two-pass window path of bevy_tpu_torch (ops/raster3d_splat.py
`compact_cluster_tris`, `eval_windows`, `composite_windows` with kernel B6)
against the JAX package on the same numpy inputs: the scene of
tests/test_sharded_raster.py, evaluated by the JAX package's
`eval_windows`, then composited by JAX's `_composite_kernel` in interpret
mode and by the port's plain version. Also: the two-pass path against the
port's fused B1 path (as tests/test_splat.py::test_fused_matches_two_pass),
and every kernel wrapper's refusal of a call whose tensors sit on
different devices. (B6 against its plain version on the card:
tests/test_torch_package.py and chip_smoke.py.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bevy_tpu.ops import raster3d_splat as jsplat
from bevy_tpu.ops import raster3d_visbuf as jvis
from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops import raster2d, raster2d_splat, shade
from bevy_tpu_torch.ops import raster3d_splat as splat
from bevy_tpu_torch.ops import raster3d_visbuf as vis
from test_sharded_raster import CS, H, W, _scene

WIN_H = 16


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


@pytest.mark.parametrize("incoming", ["clear", "prefilled"])
def test_composite_plain_bit_equal_to_jax_interpret(jax_windows, incoming):
    """Depth and winner bit for bit. `prefilled` starts from a framebuffer
    whose depth equals some windows' packed values exactly (the incoming
    value must win those ties) and beats others."""
    _, _, _, windows, owner, meta, wvalid = jax_windows
    rng = np.random.RandomState(1)
    depth = np.zeros((H, W), np.float32)
    winner = np.full((H, W), -1.0, np.float32)
    if incoming == "prefilled":
        hit = windows[wvalid].max(0)              # (win_h, 128) best values
        depth[:WIN_H] = np.where(rng.uniform(size=hit.shape) < 0.5, hit,
                                 rng.uniform(0, 1, hit.shape))[:, :W]
        winner[:WIN_H] = 5.0
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

