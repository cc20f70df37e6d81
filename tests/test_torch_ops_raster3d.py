"""bevy_tpu_torch raster ops vs the JAX package, function by function.

The same inputs, made from a seed with numpy, go through the JAX function
and its port. Where the JAX function reaches a Pallas kernel it runs in
interpret mode (`interpret=True`), the kernel path itself — never the XLA
reference raster that `backend="auto"` picks on a CPU. On CPU tensors the
port's kernel wrappers run their plain PyTorch versions, so B1 and B2 are
held here through those.

Tolerances: integer outputs (owners, ranks, tile tables, window meta) must
be equal; planes and depth agree to rtol 1e-5 / atol 1e-6 (XLA may fuse a
multiply-add that eager PyTorch rounds twice); winner ids must agree on at
least 99.5% of covered pixels (an exact-edge pixel may flip between two
triangles, the allowance of tests/test_render3d.py).

The slice end to end (`test_torch_many_cubes_matches_golden`): the
bevy_tpu_torch many_cubes twin, in the golden configuration of
tests/test_goldens.py::test_golden_cubes_splat, against the image the JAX
package's Pallas path locked in tests/goldens/cubes_splat_f2.png
(rendering that scene live through JAX in interpret mode takes about a
minute on a CPU, so the stored golden stands in for it). Golden rule of
tests/test_goldens.py: under 1% of pixels may drift by more than 8 in any
channel.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bevy_tpu.math.affine import TRS as JTRS
from bevy_tpu.math.affine import trs_to_mat4 as j_trs_to_mat4
from bevy_tpu.math.quat import quat_rotate_vec3 as j_quat_rotate_vec3
from bevy_tpu.ops import binning as jbin
from bevy_tpu.ops import raster3d_splat as jsplat
from bevy_tpu.ops import raster3d_visbuf as jvis
from bevy_tpu.render.camera import (
    perspective_infinite_reverse as j_persp, view_matrix as j_view)
from bevy_tpu.render.mesh import cuboid as j_cuboid

from bevy_tpu_torch.ops import binning as tbin
from bevy_tpu_torch.ops import raster3d_splat as tsplat
from bevy_tpu_torch.ops import raster3d_visbuf as tvis

W, H = 256, 128
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GOLDEN = Path(__file__).resolve().parent / "goldens" / "cubes_splat_f2.png"
CS = 12
LIGHT = np.concatenate([[0.0, -0.7071, -0.7071, 1.0, 0.9, 0.8, 0.1, 0.1,
                         0.12], np.zeros(7)]).astype(np.float32)


def T(x):
    return torch.from_numpy(np.array(x))


def N(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _cubes(n, seed, spread, z_range, rot=(0.2474, 0.0, 0.3, 0.9689)):
    """Clip-space corners (n, 12, 3, 4) and corner normals (n, 12, 3, 3)
    of n unit cubes, computed once with the JAX package (the scene setup
    of tests/test_splat.py and tests/test_visbuf.py)."""
    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(-spread, spread, n),
                    rng.uniform(-spread / 2, spread / 2, n),
                    rng.uniform(z_range[0], z_range[1], n)], 1)
    m = j_cuboid(1.0, 1.0, 1.0)
    vc = m.num_vertices
    vp = j_persp(jnp.asarray(0.9), W / H, jnp.asarray(0.1)) @ j_view(
        jnp.zeros(3), jnp.asarray([0.0, 0.0, 0.0, 1.0]), jnp.ones(3))
    q = np.asarray(rot, np.float32) / np.linalg.norm(rot)
    r = jnp.tile(jnp.asarray(q), (n, 1))
    mats = j_trs_to_mat4(JTRS(translation=jnp.asarray(xyz, jnp.float32),
                              rotation=r, scale=jnp.ones((n, 3))))
    mvp = jnp.einsum("ij,njk->nik", vp, mats)
    ph = jnp.concatenate([jnp.asarray(m.positions),
                          jnp.ones((vc, 1), jnp.float32)], 1)
    clip = np.asarray(jnp.einsum("nij,vj->nvi", mvp, ph))
    nrm = np.asarray(j_quat_rotate_vec3(r[:, None, :],
                                        jnp.asarray(m.normals)[None]))
    tris = m.triangles
    return clip[:, tris].astype(np.float32), nrm[:, tris].astype(np.float32)


@pytest.fixture(scope="module")
def far():
    """Cubes in front of the camera, small footprints (both window
    classes), from the JAX pipeline: everything downstream takes these
    numpy arrays."""
    cc, cn = _cubes(40, seed=3, spread=18.0, z_range=(-60.0, -12.0))
    zrec, _, valid = jvis.pack_planes_h(jnp.asarray(cc), jnp.asarray(cn),
                                        jnp.ones((40, CS), bool), W, H,
                                        build_srec=False)
    aabb, cl_valid, zmax = jvis.cluster_screen_aabbs(
        jnp.asarray(cc), jnp.ones(40, bool), valid, CS, W, H)
    return dict(cc=cc, cn=cn, zrec=np.asarray(zrec), valid=np.asarray(valid),
                aabb=np.asarray(aabb), cl_valid=np.asarray(cl_valid),
                zmax=np.asarray(zmax))


@pytest.fixture(scope="module")
def near():
    """Cubes around a camera inside the scene: near-plane straddlers with
    full-viewport AABBs and giant footprints (the fallback set)."""
    cc, cn = _cubes(12, seed=3, spread=3.0, z_range=(-4.0, 0.4))
    zrec, _, valid = jvis.pack_planes_h(jnp.asarray(cc), jnp.asarray(cn),
                                        jnp.ones((12, CS), bool), W, H,
                                        build_srec=False)
    aabb, cl_valid, zmax = jvis.cluster_screen_aabbs(
        jnp.asarray(cc), jnp.ones(12, bool), valid, CS, W, H)
    return dict(cc=cc, cn=cn, zrec=np.asarray(zrec), valid=np.asarray(valid),
                aabb=np.asarray(aabb), cl_valid=np.asarray(cl_valid),
                zmax=np.asarray(zmax))


def _close(a, b):
    np.testing.assert_allclose(N(a), N(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("capacity", [64, 7])
def test_expand_runs(capacity):
    counts = np.random.RandomState(0).randint(0, 5, 20).astype(np.int32)
    ja = jbin.expand_runs(jnp.asarray(counts), capacity)
    ta = tbin.expand_runs(T(counts), capacity)
    for j, t in zip(ja, ta):
        assert np.array_equal(N(j), N(t))


@pytest.mark.parametrize("scene", ["far", "near"])
def test_pack_planes_h(scene, request):
    s = request.getfixturevalue(scene)
    zrec, valid = tvis.pack_planes_h(T(s["cc"]), T(s["cn"]),
                                     torch.ones((len(s["cc"]), CS), dtype=torch.bool),
                                     W, H)
    assert np.array_equal(N(valid), s["valid"])
    _close(zrec, s["zrec"])


@pytest.mark.parametrize("scene", ["far", "near"])
def test_cluster_screen_aabbs(scene, request):
    s = request.getfixturevalue(scene)
    n = len(s["cc"])
    aabb, cl_valid, zmax = tvis.cluster_screen_aabbs(
        T(s["cc"]), torch.ones(n, dtype=torch.bool), T(s["valid"]), CS, W, H)
    assert np.array_equal(N(cl_valid), s["cl_valid"])
    _close(aabb, s["aabb"])
    _close(zmax, s["zmax"])


@pytest.mark.parametrize("win_h", [16, 32])
def test_build_windows(far, near, win_h):
    for s in (far, near):
        jw = jsplat.build_windows(jnp.asarray(s["aabb"]),
                                  jnp.asarray(s["cl_valid"]), win_h=win_h,
                                  width=W, height=H, budget=256, max_blocks=4)
        tw = tsplat.build_windows(T(s["aabb"]), T(s["cl_valid"]), win_h=win_h,
                                  width=W, height=H, budget=256, max_blocks=4)
        for k in ("owner", "meta", "wvalid", "fallback", "overflow"):
            assert np.array_equal(N(jw[k]), N(tw[k])), k
    assert N(tw["fallback"]).any()      # the near scene has a fallback set


def test_build_rec_rows(far):
    _close(tsplat.build_rec_rows(T(far["zrec"]), CS, 8),
           jsplat.build_rec_rows(jnp.asarray(far["zrec"]), CS, 8))


def test_build_quad_rec_rows(far):
    m = j_cuboid()
    entries = jsplat.coplanar_quad_pairs(m.positions, m.triangles)
    assert tsplat.coplanar_quad_pairs(m.positions, m.triangles) == entries
    _close(tsplat.build_quad_rec_rows(T(far["zrec"]), CS, entries, 4),
           jsplat.build_quad_rec_rows(jnp.asarray(far["zrec"]), CS, entries, 4))


@pytest.mark.parametrize("order", [False, True])
def test_bin_clusters(far, near, order):
    for s in (far, near):
        zmax = s["zmax"]
        key = np.clip((1.0 - zmax) * 65535.0, 0, 65535).astype(np.int32) \
            if order else None
        kw = dict(ntx=W // 128, nty=H // 16, tile_w=128, tile_h=16,
                  max_clusters_per_tile=40, pair_budget=1024)
        jt, jc, js = jvis.bin_clusters(
            jnp.asarray(s["aabb"]), jnp.asarray(s["cl_valid"]),
            order_key=None if key is None else jnp.asarray(key), **kw)
        tt, tc, ts = tvis.bin_clusters(
            T(s["aabb"]), T(s["cl_valid"]),
            order_key=None if key is None else T(key), **kw)
        assert np.array_equal(N(jt), N(tt))
        assert np.array_equal(N(jc), N(tc))
        for k in js:
            assert int(js[k]) == int(ts[k]), k


def test_pack_flat_shade_and_resolve_flat(far):
    rng = np.random.RandomState(1)
    mat = rng.uniform(0.0, 1.0, (40, CS, 9)).astype(np.float32)
    jrec = jvis.pack_flat_shade(jnp.asarray(far["cn"]), jnp.asarray(mat),
                                jnp.asarray(LIGHT), jnp.asarray(far["valid"]))
    trec = tvis.pack_flat_shade(T(far["cn"]), T(mat), T(LIGHT),
                                T(far["valid"]))
    _close(trec, jrec)
    winner = rng.randint(-1, 40 * CS, (H, W)).astype(np.int32)
    color = rng.uniform(0.0, 1.0, (4, H, W)).astype(np.float32)
    flat = np.asarray(jrec).reshape(-1, 8)
    assert np.array_equal(
        N(tvis.resolve_flat(T(winner), T(flat), T(color))),
        np.asarray(jvis.resolve_flat(jnp.asarray(winner), jnp.asarray(flat),
                                     jnp.asarray(color))))


def _srec_inputs(far, tint=False):
    """Per-triangle shade-record inputs over the far scene, every optional
    part present (seeded): materials (15 columns, 18 with tint), corner
    UVs past [0, 1] (the REPEAT wrap), base-colour / normal-map / lightmap
    / depth-map / channel rects in a 64 x 64 atlas (a quarter of each kind
    absent: u1 <= u0), unit tangents, parallax scales on half."""
    rng = np.random.RandomState(7)
    lead = (40, CS)
    mat = rng.uniform(0.05, 1.0, lead + (18 if tint else 15,)) \
        .astype(np.float32)
    mat[..., 13] = np.where(rng.uniform(size=lead) < 0.5, 0.0,
                            rng.uniform(0.02, 0.1, lead))
    cuv = rng.uniform(-1.0, 2.0, lead + (3, 2)).astype(np.float32)
    tan = rng.normal(size=lead + (3,)).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)

    def rects():
        lo = rng.uniform(0.0, 0.6, lead + (2,))
        hi = lo + rng.uniform(0.1, 0.4, lead + (2,))
        r = np.concatenate([lo, hi], -1).astype(np.float32)
        r[rng.uniform(size=lead) < 0.25] = 0.0
        return r

    parts = dict(cuv=cuv, tex_rect=rects(), tangents=tan, nm_rect=rects(),
                 lm_rect=rects(), dm_rect=rects(), em_rect=rects(),
                 mr_rect=rects(), oc_rect=rects())
    return mat, parts


@pytest.mark.parametrize("parts", ["all", "tint", "bare"])
def test_pack_planes_h_shade_records(far, parts):
    """pack_planes_h(build_srec=True) against JAX: rtol / atol 1e-5 on the
    valid triangles' records (the JAX records of culled triangles carry
    their material too; both zero their planes)."""
    mat, kw = _srec_inputs(far, tint=parts == "tint")
    if parts == "bare":
        mat, kw = None, {}
    ok = np.ones((40, CS), bool)
    jz, js, jv = jvis.pack_planes_h(
        jnp.asarray(far["cc"]), jnp.asarray(far["cn"]), jnp.asarray(ok), W,
        H, materials=None if mat is None else jnp.asarray(mat),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tz, ts, tv = tvis.pack_planes_h(
        T(far["cc"]), T(far["cn"]), T(ok), W, H, build_srec=True,
        materials=None if mat is None else T(mat),
        **{k: T(v) for k, v in kw.items()})
    v = N(jv)
    assert np.array_equal(N(tv), v) and v.any()
    assert ts.shape[-1] == (67 if parts == "tint" else tvis.SREC)
    np.testing.assert_allclose(N(ts)[v], N(js)[v], rtol=1e-5, atol=1e-5)
    _close(tz, jz)


def _visbuf_winners(zrec):
    """(H, W) int32 winner ids of flat (T, ZREC) records: at each pixel
    centre the triangle inside its three edges with the greatest depth
    (numpy, independent of both rasters; -1 = none)."""
    px = np.arange(W, dtype=np.float32)[None, :, None] + 0.5
    py = np.arange(H, dtype=np.float32)[:, None, None] + 0.5
    z = np.asarray(zrec)
    inside = np.ones((H, W, len(z)), bool)
    for k in range(3):
        inside &= z[:, 3 * k] * px + z[:, 3 * k + 1] * py + \
            z[:, 3 * k + 2] <= 0
    inside &= z[:, 12] >= 0
    depth = np.where(inside, z[:, 9] * px + z[:, 10] * py + z[:, 11], -1.0)
    win = np.argmax(depth, -1).astype(np.int32)
    return np.where(depth.max(-1) > 0, win, -1)


@pytest.fixture(scope="module")
def shaded(far):
    """The far scene's shade records (all parts, JAX-packed), its winners,
    a seeded 64 x 64 atlas with a smooth depth channel, and a camera's
    pixel-ray planes."""
    mat, kw = _srec_inputs(far)
    zrec, srec, _ = jvis.pack_planes_h(
        jnp.asarray(far["cc"]), jnp.asarray(far["cn"]),
        jnp.ones((40, CS), bool), W, H, materials=jnp.asarray(mat),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    rng = np.random.RandomState(8)
    atlas = rng.uniform(0.0, 1.0, (64, 64, 4)).astype(np.float32)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    atlas[..., 0] = 0.5 + 0.4 * np.sin(6.0 * xx) * np.cos(4.0 * yy)
    tf = np.tan(0.45)
    ta = tf * W / H
    ray = np.asarray([[-ta, tf, -1.0], [2 * ta / W, 0, 0],
                      [0, -2 * tf / H, 0]], np.float32)
    srec = np.asarray(srec).reshape(-1, tvis.SREC)
    winner = _visbuf_winners(np.asarray(zrec).reshape(-1, tvis.ZREC))
    assert (winner >= 0).mean() > 0.02          # the scene drew something
    return dict(srec=srec, winner=winner, atlas=atlas, ray=ray)


def test_sample_atlas(shaded):
    uv = np.random.RandomState(9).uniform(-0.2, 1.2, (500, 2)) \
        .astype(np.float32)
    _close(tvis.sample_atlas(T(shaded["atlas"]), T(uv)),
           jvis.sample_atlas(jnp.asarray(shaded["atlas"]), jnp.asarray(uv)))


@pytest.mark.parametrize("layers", [0, 8])
@pytest.mark.parametrize("fn", ["shade", "forward", "gbuf"])
def test_shade_record_resolves(shaded, fn, layers):
    """resolve_shade / resolve_forward / resolve_gbuf with the atlas
    (base colour, normal map, channel textures, lightmap) and, with
    layers > 0, the parallax march, against JAX: atol 1e-4."""
    win, srec, atlas, ray = (shaded[k] for k in ("winner", "srec", "atlas",
                                                 "ray"))
    jargs = (jnp.asarray(win), jnp.asarray(srec))
    targs = (T(win), T(srec))
    jkw = dict(atlas=jnp.asarray(atlas), ray=jnp.asarray(ray),
               parallax_layers=layers)
    tkw = dict(atlas=T(atlas), ray=T(ray), parallax_layers=layers)
    rng = np.random.RandomState(10)
    if fn == "shade":
        j = jvis.resolve_shade(*jargs, **jkw)
        t = tvis.resolve_shade(*targs, **tkw)
        assert np.array_equal(N(j[2]), N(t[2]))
        pairs = list(zip(j[:2], t[:2]))
    elif fn == "forward":
        color = rng.uniform(0, 1, (4, H, W)).astype(np.float32)
        pairs = [(jvis.resolve_forward(*jargs, jnp.asarray(LIGHT),
                                       jnp.asarray(color), **jkw),
                  tvis.resolve_forward(*targs, T(LIGHT), T(color), **tkw))]
    else:
        gbuf = rng.uniform(0, 1, (19, H, W)).astype(np.float32)
        pairs = [(jvis.resolve_gbuf(*jargs, jnp.asarray(gbuf), **jkw),
                  tvis.resolve_gbuf(*targs, T(gbuf), **tkw))]
    for a, b in pairs:
        np.testing.assert_allclose(N(b), N(a), rtol=0, atol=1e-4)


def _compare_visbuf(jd, jw, td, tw):
    jd, jw, td, tw = N(jd), N(jw), N(td), N(tw)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    cov = (jd > 0) | (td > 0)
    assert cov.mean() > 0.02                      # the scene drew something
    assert np.mean(jw[cov] == tw[cov]) >= 0.995


# a rect that cuts the far scene's windows and their 8 x 4 tiles on all
# four sides, at unaligned coordinates (B1's scissor instantiation)
FAR_SCISSOR = (41.5, 7.25, 203.75, 101.0)


@pytest.mark.parametrize("scissor", [None, FAR_SCISSOR],
                         ids=["full", "scissor"])
@pytest.mark.parametrize("quads", [False, True])
def test_fused_eval_composite_plain_matches_pallas(far, quads, scissor):
    """Kernel B1's plain version vs the Pallas `_fused_kernel` (interpret
    mode) on the same windows and record rows, over a framebuffer that
    already holds depth (so the incoming value's tie rule is exercised);
    with a scissor, the reference's `use_scissor` instantiation (a static
    viewport of Python floats) against the port's rect as a tensor."""
    zrec = jnp.asarray(far["zrec"])
    if quads:
        m = j_cuboid()
        entries = jsplat.coplanar_quad_pairs(m.positions, m.triangles)
        rows, nedge, nslots = jsplat.build_quad_rec_rows(zrec, CS, entries, 4), 4, 4
    else:
        rows, nedge, nslots = jsplat.build_rec_rows(zrec, CS, 8), 3, 8
    wins = jsplat.build_windows(jnp.asarray(far["aabb"]),
                                jnp.asarray(far["cl_valid"]), win_h=16,
                                width=W, height=H, budget=256)
    assert 8 < int(jnp.sum(wins["wvalid"])) < 256
    rng = np.random.RandomState(2)
    dep0 = np.where(rng.uniform(size=(H, W)) < 0.3,
                    rng.uniform(0.0, 0.01, (H, W)), 0.0).astype(np.float32)
    win0 = np.full((H, W), -1.0, np.float32)
    jd, jw = jsplat.fused_eval_composite(
        jnp.asarray(dep0), jnp.asarray(win0), zrec, wins["owner"],
        wins["meta"], wins["wvalid"], win_h=16, cs=CS, eval_tris=8,
        interpret=True, rec_rows=rows, nedge=nedge,
        rec_slots=nslots if quads else None, viewport=scissor)
    td, tw = tsplat.fused_eval_composite(
        T(dep0), T(win0), T(rows), T(wins["owner"]), T(wins["meta"]),
        T(wins["wvalid"]), None if scissor is None else T(
            np.float32(scissor)), win_h=16, ntri=nslots, nedge=nedge)
    _compare_visbuf(jd, jw, td, tw)
    if scissor is not None:
        # the same winners; inside the rect the port's unscissored bits,
        # outside it the incoming values, in both packages (depth bits
        # across the packages differ by an ulp where XLA's CPU backend
        # contracts the plane's multiply-add: 105 of 32,768 pixels here,
        # 130 without the scissor)
        assert np.array_equal(N(tw), N(jw))
        fd, fw = tsplat.fused_eval_composite(
            T(dep0), T(win0), T(rows), T(wins["owner"]), T(wins["meta"]),
            T(wins["wvalid"]), win_h=16, ntri=nslots, nedge=nedge)
        x0, y0, x1, y1 = scissor
        px = np.arange(W)[None, :] + 0.5
        py = np.arange(H)[:, None] + 0.5
        rect = (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
        assert np.array_equal(
            N(td).view(np.int32),
            np.where(rect, N(fd), dep0).view(np.int32))
        assert np.array_equal(N(tw), np.where(rect, N(fw), win0))
        assert np.array_equal(N(jd)[~rect], dep0[~rect])
        assert (N(jw)[~rect] == -1).all() and (N(jw)[rect] >= 0).any()
        assert not np.array_equal(N(tw), N(fw))


def _b1_case(name, far, near):
    """(rec_rows, depth, owner, meta, wvalid, kw) of one B1 cull scene."""
    if name in ("random_planes", "slivers", "many_slots", "tall_quads"):
        from torch_scenes import b1_cull_scenes
        rows, depth, _, owner, meta, wvalid, kw, _ = \
            b1_cull_scenes("cpu")[name]
        return rows, depth, owner, meta, wvalid, kw
    sc = far if name.startswith("far") else near
    zrec = T(sc["zrec"]).reshape(-1, tvis.ZREC)
    if "quads" in name:
        m = j_cuboid()
        entries = tsplat.coplanar_quad_pairs(m.positions, m.triangles)
        rows = tsplat.build_quad_rec_rows(zrec, CS, entries, 4)
        kw = dict(win_h=32, ntri=4, nedge=4)
    else:
        rows = tsplat.build_rec_rows(zrec, CS, 8)
        kw = dict(win_h=16 if name.startswith("far") else 32, ntri=8,
                  nedge=3)
    wins = tsplat.build_windows(T(sc["aabb"]), T(sc["cl_valid"]),
                                win_h=kw["win_h"], width=W, height=H,
                                budget=512)
    assert int(wins["overflow"]) == 0
    rng = np.random.RandomState(2)
    depth = np.where(rng.uniform(size=(H, W)) < 0.3,
                     rng.uniform(0.0, 0.01, (H, W)), 0.0).astype(np.float32)
    return rows, T(depth), wins["owner"], wins["meta"], wins["wvalid"], kw


def _b1_writes_dropped(rows, depth, owner, meta, wvalid, scissor=None, *,
                       win_h, ntri, nedge):
    """(pairs that can write, of them dropped by window_px_kept, the kept
    (tile, slot) mask) of the valid windows: a (pixel, slot) pair can
    write iff the pixel is in the frame, every edge reads <= 0 and z beats
    the incoming depth, in _fused_plain's arithmetic `(a*px + c) + b*py`.
    One slot at a time, each over all windows: few, large ops."""
    height, width = depth.shape
    nv = int(wvalid.sum())
    m = meta[:nv]
    rec = rows.reshape(rows.shape[0], -1)[owner[:nv].long()]
    kept = tsplat.window_px_kept(rec, m, depth, scissor, win_h=win_h,
                                 ntri=ntri, nedge=nedge)
    x = ((m // 2048) * 128)[:, None, None] + torch.arange(128)[None, None, :]
    y = (m % 2048)[:, None, None] + torch.arange(win_h)[None, :, None]
    px, py = x.to(torch.float32) + 0.5, y.to(torch.float32) + 0.5
    dep = depth[y.clamp(max=height - 1), x.clamp(max=width - 1)]
    frame = (x < width) & (y < height)
    if scissor is not None:          # outside the rect nothing writes
        x0, y0, x1, y1 = scissor
        frame = frame & (px >= x0) & (px < x1) & (py >= y0) & (py < y1)
    tile = (torch.arange(win_h)[:, None] // 4) * 16 + \
        torch.arange(128)[None, :] // 8
    stride = 3 * nedge + 4
    writes = dropped = 0
    for s in range(ntri):
        def d(j, _b=s * stride):
            return rec[:, _b + j][:, None, None]
        ok = frame
        for j in range(nedge):
            ok = ok & ((d(3 * j) * px + d(3 * j + 2)) + d(3 * j + 1) * py
                       <= 0)
        zb = 3 * nedge
        ok = ok & ((d(zb) * px + d(zb + 2)) + d(zb + 1) * py > dep)
        writes += int(ok.sum())
        dropped += int((ok & ~kept[:, tile, s]).sum())
    return writes, dropped, kept


@pytest.mark.parametrize("name", ["far_tris", "far_quads", "near_tris",
                                  "slivers", "random_planes", "many_slots",
                                  "tall_quads"])
def test_window_px_kept_drops_only_outside_pairs(name, far, near):
    """B1's cull (window_px_kept, the kernel's decisions in plain PyTorch)
    drops no (pixel, slot) pair that could write — inside the slot's edges
    with z above the incoming depth, in the walk's arithmetic: scenes with
    both window classes, 3-edge triangles and 4-edge quads, near-plane
    straddlers (full-viewport AABBs), slivers 1e-3 px thick across tile
    and frame edges, zero padding slots over depths >= 0 and below 0,
    random planes with zeros, huge and tiny coefficients, infinities and
    NaNs, and 40 slots over windows of 256 and 1200 rows; windows run past
    the frame's right and bottom edges."""
    rows, depth, owner, meta, wvalid, kw = _b1_case(name, far, near)
    nv = int(wvalid.sum())
    assert nv >= 8 and bool(wvalid[:nv].all())
    writes, dropped, kept = _b1_writes_dropped(rows, depth, owner, meta,
                                               wvalid, **kw)
    assert dropped == 0
    assert writes > 0
    assert int(kept.sum()) < kept.numel()


@pytest.mark.parametrize("name", ["far_tris", "far_quads", "slivers",
                                  "many_slots"])
def test_window_px_kept_scissor_drops_only_outside_pairs(name, far, near):
    """B1's cull under a scissor rect (the scissor instantiation also drops
    the 32 x 16 blocks and 8 x 4 tiles no pixel centre of which can pass
    the rect) drops no pair that could write inside the rect, and drops
    more than the cull without the rect."""
    rows, depth, owner, meta, wvalid, kw = _b1_case(name, far, near)
    H, W = depth.shape
    sc = (W * 0.15 + 0.5, H * 0.1 + 0.25, W * 0.8 + 0.25, H * 0.85)
    writes, dropped, kept = _b1_writes_dropped(rows, depth, owner, meta,
                                               wvalid, sc, **kw)
    assert dropped == 0
    assert writes > 0
    _, _, kept_full = _b1_writes_dropped(rows, depth, owner, meta, wvalid,
                                         **kw)
    assert int(kept.sum()) < int(kept_full.sum())
    assert not (kept & ~kept_full).any()


# a rect that cuts the near scene's 16 x 128 tiles (and one 16 x 64 block
# of B2) on all four sides, at unaligned coordinates
NEAR_SCISSOR = (37.5, 9.0, 201.25, 100.0)


def _near_bins(near, tile_h=16, tile_w=128):
    """The near scene's tile lists (bin_clusters, front-to-back keys) and
    cluster records, as the mesh pass hands them to B2."""
    ntx, nty = W // tile_w, H // tile_h
    key = np.clip((1.0 - near["zmax"]) * 65535.0, 0, 65535).astype(np.int32)
    cl_table, cl_counts, _ = jvis.bin_clusters(
        jnp.asarray(near["aabb"]), jnp.asarray(near["cl_valid"]), ntx=ntx,
        nty=nty, tile_w=tile_w, tile_h=tile_h, max_clusters_per_tile=12,
        pair_budget=512, order_key=jnp.asarray(key))
    assert int(jnp.max(cl_counts)) >= 2
    zrec = jnp.asarray(near["zrec"]).reshape(-1, jvis.ZREC)
    return cl_table, cl_counts, zrec


@pytest.mark.parametrize("scissor", [None, NEAR_SCISSOR],
                         ids=["full", "scissor"])
def test_raster_visbuf_plain_matches_pallas(near, scissor):
    """Kernel B2's plain version vs the Pallas `_stream_kernel` (interpret
    mode) on the near-plane scene's tile lists, without and with a scissor
    rect that cuts tiles."""
    tile_h, tile_w = 16, 128
    cl_table, cl_counts, zrec = _near_bins(near, tile_h, tile_w)
    recs = jvis.cluster_records(zrec, CS)
    dep0 = jnp.zeros((H, W), jnp.float32)
    win0 = jnp.full((H, W), -1.0, jnp.float32)
    jd, jw = jvis.raster_visbuf(
        dep0, win0, jvis.tile_chunk_records(recs, cl_table),
        jvis.build_cluster_meta(cl_table, jnp.asarray(near["zmax"])),
        cl_counts, scissor, tile_h=tile_h, tile_w=tile_w, cs=CS,
        interpret=True)
    td, tw = tvis.raster_visbuf(T(dep0), T(win0),
                                tvis.cluster_records(T(zrec), CS),
                                T(cl_table), T(cl_counts), scissor,
                                tile_h=tile_h, tile_w=tile_w, cs=CS)
    _compare_visbuf(jd, jw, td, tw)
    if scissor is not None:
        x0, y0, x1, y1 = scissor
        px = np.arange(W) + 0.5
        py = np.arange(H)[:, None] + 0.5
        outside = (px < x0) | (px >= x1) | (py < y0) | (py >= y1)
        assert (N(tw)[outside] == -1).all() and (N(td)[outside] == 0).all()
        assert (N(tw)[~outside] >= 0).mean() > 0.5


def test_stream_block_cull_drops_only_outside_pairs(near):
    """B2's block cull (tri_in_stream_block, the kernel's decisions in plain
    PyTorch) drops no (pixel, triangle) pair the reference would evaluate
    (the triangle passes the tile test) and find inside the edges, in the
    walk's arithmetic (d0*px + d1*py) + d2, on the near-plane scene
    (straddlers with full-viewport AABBs in every tile); and it drops
    some. 16 x 128 and 32 x 128 tiles, each over 16 x 64 blocks."""
    for tile_h in (16, 32):
        cl_table, cl_counts, zrec = _near_bins(near, tile_h)
        recs = tvis.cluster_records(T(zrec), CS)
        table, counts = T(cl_table), T(cl_counts)
        keep = tvis.tri_in_stream_block(recs, table, counts, H, W,
                                        tile_h=tile_h, tile_w=128, cs=CS)
        nt, nby, nbx, ns, cs = keep.shape
        bh, bw = tvis.STREAM_BLOCK_H, tvis.STREAM_BLOCK_W
        assert (nby, nbx, cs) == (-(-tile_h // bh), 128 // bw, CS)
        ntx = W // 128
        ti = torch.arange(nt)
        px = (torch.arange(128)[None, None, :] + (ti % ntx * 128)[:, None,
                                                                 None]) + 0.5
        py = (torch.arange(tile_h)[None, :, None] +
              (ti // ntx * tile_h)[:, None, None]) + 0.5
        frame = (px < W) & (py < H)
        px, py = px.to(torch.float32), py.to(torch.float32)
        ids = table[:, :ns]
        listed = (torch.arange(ns)[None, :] < counts[:, None]) & (ids >= 0)
        rec = recs[ids.clamp(min=0).long()]
        tx0, ty0 = (ti % ntx * 128).float(), (ti // ntx * tile_h).float()
        dropped = inside_dropped = 0
        for sl in range(ns):
            for s in range(CS):
                def d(k, _b=s * tvis.ZREC):
                    return rec[:, sl, _b + k][:, None, None]
                hit = listed[:, sl] & (rec[:, sl, s * 20 + 12] >= 0) & \
                    (rec[:, sl, s * 20 + 15] > tx0) & \
                    (rec[:, sl, s * 20 + 13] < tx0 + 128) & \
                    (rec[:, sl, s * 20 + 16] > ty0) & \
                    (rec[:, sl, s * 20 + 14] < ty0 + tile_h)
                inside = (d(0) * px + d(1) * py + d(2) <= 0) & \
                    (d(3) * px + d(4) * py + d(5) <= 0) & \
                    (d(6) * px + d(7) * py + d(8) <= 0) & frame
                inside = inside & hit[:, None, None]
                blocks = torch.nn.functional.pad(
                    inside, (0, 0, 0, nby * bh - tile_h)).reshape(
                    nt, nby, bh, nbx, bw).any(4).any(2)
                drop = hit[:, None, None] & ~keep[..., sl, s]
                dropped += int(drop.sum())
                inside_dropped += int((drop & blocks).sum())
        assert inside_dropped == 0
        assert 0 < dropped < int(listed.sum()) * CS * nby * nbx


# -- the slice end to end ---------------------------------------------------


def test_torch_many_cubes_matches_golden():
    from PIL import Image

    import torch_many_cubes
    from bevy_tpu_torch.render.plugin import frame_image

    app = torch_many_cubes.build_app(n_cubes=300, width=320, height=180,
                                     capacity=512, window_budget=4096,
                                     device="cpu")
    app.run(max_frames=2, dt=1 / 60)
    img = frame_image(app).astype(int)
    golden = np.asarray(Image.open(GOLDEN)).astype(int)
    assert img.shape == golden.shape
    diff = np.abs(golden - img).max(-1)
    assert (diff > 8).mean() < 0.01, (diff > 8).mean()
    stats = app.world.state["res"]["render_stats"]
    assert int(stats["pair_overflow"]) == 0
    assert int(stats["tile_overflow"]) == 0
    depth = app.world.state["res"]["render_target"]["depth"]
    assert torch.isfinite(depth).all() and (depth > 0).float().mean() > 0.02
    assert app.frame == 2
