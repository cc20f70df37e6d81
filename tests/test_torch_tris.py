"""Kernels B7 and B8 and their preparation (bevy_tpu_torch/ops/raster3d.py,
ops/raster3d_tris.py) on the CPU, where `raster_tris` runs its plain
PyTorch version, against the JAX package: `triangle_setup_corners`,
`clip_near_corners`, `pack_tri_table` and `pack_tri_planes` on the same
inputs (rtol/atol 1e-6, integer and bool outputs equal); `bin_tris`
against a sequential numpy binning; and the raster of every layout, with
the scissor off and on, against `raster_tris_pallas(interpret=True)` on
the same records (chip_smoke.tri_scene: overlapping triangles, equal-depth
ties, a tile over max_per_tile and off-screen triangles at 320x180).

The raster rule: the same winning triangle on >= 99.5% of pixels (ROADMAP
C1), and there depth, colour and G-buffer within atol 1e-5 on >= 99.9% of
the values and within 1e-4 on all of them; G-buffer planes 12 and up untouched; stats equal. The winner is read
from plane 3, the record's alpha copied through (unique to each triangle
in this scene). Depth is not compared bit for bit: XLA's CPU backend
contracts the kernel body's multiply-adds into fused multiply-adds
(always on there), so the interpolated z of about a tenth of the pixels
lands an ulp or more away from the unfused order that the port's plain
version and its CUDA kernel share; on the few-pixel triangles of the
crowded tile the plane form's large coefficients cancel, and that
difference grows to 8e-5 in a handful of normals."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bevy_tpu.ops import raster3d as jr3  # noqa: E402
from bevy_tpu.ops import raster3d_pallas as jrp  # noqa: E402
from bevy_tpu_torch.ops import raster3d as r3  # noqa: E402
from bevy_tpu_torch.ops import raster3d_tris as rt  # noqa: E402
from chip_smoke import TRI_KW, TRI_SCISSOR, tri_scene  # noqa: E402
from torch_scenes import SLIVER_INSIDE, with_slivers  # noqa: E402

H, W = 180, 320
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module")
def scene():
    s = tri_scene("cpu")
    active = torch.ones(s["clip"].shape[0], dtype=torch.bool)
    setup = r3.triangle_setup_corners(s["clip"], active, W, H)
    return s, setup


@pytest.mark.parametrize("viewport", [None, (16.0, 8.5, 300.0, 172.0)],
                         ids=["full", "viewport"])
def test_triangle_setup_matches_jax(scene, viewport):
    s, _ = scene
    clip = s["clip"].clone()
    clip[:5, 1, 3] = -0.5             # corners behind the eye: invalid
    active = torch.ones(clip.shape[0], dtype=torch.bool)
    active[7] = False
    got = r3.triangle_setup_corners(clip, active, W, H, viewport=viewport)
    want = jr3.triangle_setup_corners(jnp.asarray(_np(clip)),
                                      jnp.asarray(_np(active)), W, H,
                                      viewport=viewport)
    for k in ("corners", "depth", "inv_w", "area2", "aabb"):
        _close(got[k], want[k])
    assert np.array_equal(_np(got["valid"]), np.asarray(want["valid"]))
    assert 0.5 < got["valid"].float().mean() < 0.95


def test_clip_near_corners_matches_jax():
    """All four inside-counts, varyings carried along, and a second-
    triangle budget smaller than the crossings (the rest are dropped)."""
    rng = np.random.default_rng(4)
    t = 96
    clip = rng.uniform(-2.0, 2.0, (t, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.choice([-0.5, 0.5, 2.0], (t, 3))
    var = rng.uniform(-1.0, 1.0, (t, 3, 5)).astype(np.float32)
    active = rng.uniform(size=t) > 0.1
    for budget in (None, 8):
        got = r3.clip_near_corners(torch.tensor(clip), torch.tensor(var),
                                   torch.tensor(active), extra_budget=budget)
        want = jr3.clip_near_corners(jnp.asarray(clip), jnp.asarray(var),
                                     jnp.asarray(active),
                                     extra_budget=budget)
        _close(got[0], want[0])
        _close(got[1], want[1])
        assert np.array_equal(_np(got[2]), np.asarray(want[2]))
        assert np.array_equal(_np(got[3]), np.asarray(want[3]))
    inside = (clip[..., 3] > 1e-4).sum(1)
    assert {0, 1, 2, 3} <= set(inside.tolist())


def test_packers_match_jax(scene):
    s, setup = scene
    jsetup = {k: jnp.asarray(_np(v)) for k, v in setup.items()}
    jnrm, jcol, jemi = (jnp.asarray(_np(s[k]))
                        for k in ("normals", "colors", "emissive"))
    _close(rt.pack_tri_table(setup, s["normals"], s["colors"],
                             s["emissive"]),
           jrp.pack_tri_table(jsetup, jnrm, jcol, jemi))
    args = (setup["corners"], setup["depth"], setup["inv_w"],
            setup["area2"], setup["valid"])
    jargs = [jsetup[k] for k in ("corners", "depth", "inv_w", "area2",
                                 "valid")]
    _close(rt.pack_tri_planes(*args, s["normals"], s["colors"],
                              s["emissive"], s["metallic"], s["roughness"]),
           jrp.pack_tri_planes(*jargs, jnrm, jcol, jemi,
                               jnp.asarray(_np(s["metallic"])),
                               jnp.asarray(_np(s["roughness"]))))
    # the default metallic / roughness columns
    _close(rt.pack_tri_planes(*args, s["normals"], s["colors"],
                              s["emissive"]),
           jrp.pack_tri_planes(*jargs, jnrm, jcol, jemi))


def _sequential_bins(valid, aabb, ntx, nty, pair_cap, mpt):
    """Triangle by triangle, every tile its AABB touches, the first
    pair_cap pairs kept; each tile's list in triangle order, cut to mpt."""
    lists = [[] for _ in range(nty * ntx)]
    total = 0
    for i in np.flatnonzero(valid):
        x0, y0, x1, y1 = np.floor(aabb[i] / [128, 32, 128, 32]).astype(int)
        if x1 < 0 or x0 >= ntx or y1 < 0 or y0 >= nty:
            continue
        for ty in range(max(y0, 0), min(y1, nty - 1) + 1):
            for tx in range(max(x0, 0), min(x1, ntx - 1) + 1):
                if total < pair_cap:
                    lists[ty * ntx + tx].append(i)
                total += 1
    return [lst[:mpt] for lst in lists], total


@pytest.mark.parametrize("pairs_per_tri", [2, 1], ids=["cap", "tight"])
def test_bin_tris_matches_sequential_binning(scene, pairs_per_tri):
    _, setup = scene
    valid, aabb = setup["valid"], setup["aabb"]
    pair_tri, starts, counts, st = rt.bin_tris(
        valid, aabb, H, W, pairs_per_tri=pairs_per_tri, **TRI_KW)
    nty, ntx = 6, 3
    pair_cap = valid.shape[0] * pairs_per_tri + nty * ntx
    want, total = _sequential_bins(_np(valid), _np(aabb), ntx, nty,
                                   pair_cap, TRI_KW["max_per_tile"])
    got = [_np(pair_tri[s:s + c]).tolist()
           for s, c in zip(_np(starts), _np(counts))]
    assert got == [[int(i) for i in lst] for lst in want]
    assert int(st["pair_overflow"]) == max(total - pair_cap, 0)
    longest = max(len(lst) for lst in _sequential_bins(
        _np(valid), _np(aabb), ntx, nty, pair_cap, 10 ** 9)[0])
    assert int(st["tile_overflow"]) == max(longest - 128, 0)
    # the roomy cap keeps every pair and overflows the crowded tile; the
    # tight one drops the pairs past it
    assert (int(st["pair_overflow"]) > 0) == (pairs_per_tri == 1)
    assert (int(st["tile_overflow"]) > 0) == (pairs_per_tri == 2)


@pytest.mark.parametrize("scissor", [False, True], ids=["full", "scissor"])
@pytest.mark.parametrize("layout", ["corners", "planes", "planes_gbuf"])
def test_raster_tris_matches_jax_interpret(scene, layout, scissor):
    s, setup = scene
    if layout == "corners":
        table = rt.pack_tri_table(setup, s["normals"], s["colors"],
                                  s["emissive"])
    else:
        table = rt.pack_tri_planes(
            setup["corners"], setup["depth"], setup["inv_w"],
            setup["area2"], setup["valid"], s["normals"], s["colors"],
            s["emissive"], s["metallic"], s["roughness"])
    fb = s["fb"] if layout == "planes_gbuf" else s["fb"][:4].contiguous()
    sc = TRI_SCISSOR if scissor else None
    rt.raster_tris.kernel_launches.update(B7=0, B8=0)
    pair_tri, starts, counts, st = rt.bin_tris(setup["valid"],
                                               setup["aabb"], H, W, **TRI_KW)
    col, dep = rt.raster_tris(fb, s["depth"], table, pair_tri, starts,
                              counts, s["light"], sc, layout=layout,
                              tile_h=TRI_KW["tile_h"],
                              tile_w=TRI_KW["tile_w"])
    jcol, jdep, jst = jrp.raster_tris_pallas(
        jnp.asarray(_np(fb)), jnp.asarray(_np(s["depth"])),
        jnp.asarray(_np(table)), jnp.asarray(_np(setup["valid"])),
        jnp.asarray(_np(setup["aabb"])), jnp.asarray(_np(s["light"])),
        scissor=sc, interpret=True, layout=layout, **TRI_KW)
    jcol, jdep = np.asarray(jcol), np.asarray(jdep)
    col, dep = _np(col), _np(dep)
    # plane 3 is the winning record's alpha, copied through unchanged and
    # unique to each triangle here: equal bits = the same winner
    assert len(np.unique(_np(s["colors"][:, 3]))) == s["colors"].shape[0]
    same = col[3].view(np.int32) == jcol[3].view(np.int32)
    assert same.mean() >= 0.995, same.mean()
    nw = 12 if layout == "planes_gbuf" else 4
    for got, want in ((dep[same], jdep[same]),
                      (col[:nw][:, same], jcol[:nw][:, same])):
        err = np.abs(got - want)
        assert (err <= 1e-5).mean() >= 0.999 and err.max() <= 1e-4, \
            ((err > 1e-5).mean(), err.max())
    assert np.array_equal(col[nw:], _np(fb)[nw:])
    assert np.array_equal(col[nw:], jcol[nw:])
    for k in ("pair_overflow", "tile_overflow"):
        assert int(st[k]) == int(jst[k]), k
    drawn = dep != _np(s["depth"])
    assert 0.2 < drawn.mean() < 0.9
    if scissor:
        x0, y0, x1, y1 = TRI_SCISSOR
        px = np.arange(W) + 0.5
        py = np.arange(H)[:, None] + 0.5
        outside = (px < x0) | (px >= x1) | (py < y0) | (py >= y1)
        assert not drawn[outside].any()
    assert rt.raster_tris.kernel_launches == {"B7": 0, "B8": 0}


def _tiles_px(nt, th, tw):
    """(T, th, tw) pixel centres of each tile of the W-wide frame."""
    ntx = -(-W // tw)
    ti = torch.arange(nt)
    px = (torch.arange(tw)[None, None, :] + ((ti % ntx) * tw)[:, None, None]
          ).to(torch.float32) + 0.5
    py = (torch.arange(th)[None, :, None] + ((ti // ntx) * th)[:, None, None]
          ).to(torch.float32) + 0.5
    return ti, px, py


def _edge_inside(table, pair_tri, starts, s_, px, py, layout):
    """(T, th, tw) bool: whether each pixel centre is inside the edges of
    its tile's s_-th listed record, in the kernel's arithmetic."""
    slot = torch.clamp(starts + s_, max=pair_tri.shape[0] - 1).long()
    d = table[pair_tri[slot].long()][:, :13, None, None].unbind(1)
    return rt._coverage(d, px, py, layout)[0]


def _check_block_cull(replay, layout, table, setup, s, scissor):
    """A block cull's replay (tri_in_block for B7, plane_in_block for B8)
    drops no entry for a 16x16 block, or a warp's two rows, that is inside
    the edges at a pixel of it, and drops some; and the plain version with
    each 16x16 block's lists cut to the kept entries (order kept) rasters
    that block bit for bit as with the whole lists. Returns the whole
    lists' raster."""
    pair_tri, starts, counts, _ = rt.bin_tris(setup["valid"],
                                              setup["aabb"], H, W, **TRI_KW)
    th, tw = TRI_KW["tile_h"], TRI_KW["tile_w"]
    B = rt.BLOCK
    nt = counts.shape[0]
    ti, px, py = _tiles_px(nt, th, tw)
    ns = int(counts.max())
    for bh in (B, rt.WARP_ROWS):
        keep = replay(table, pair_tri, starts, counts, W, tile_h=th,
                      tile_w=tw, block_h=bh)
        assert keep.shape == (nt, th // bh, tw // B, ns)
        dropped = 0
        for s_ in range(ns):
            inside = _edge_inside(table, pair_tri, starts, s_, px, py,
                                  layout).reshape(nt, th // bh, bh, tw // B,
                                                  B)
            drop = ~keep[..., s_] & (s_ < counts)[:, None, None]
            assert not (drop & inside.any(4).any(2)).any(), (bh, s_)
            dropped += int(drop.sum())
        assert 0 < dropped < int(counts.sum()) * keep[0, ..., 0].numel()

    keep = replay(table, pair_tri, starts, counts, W, tile_h=th, tile_w=tw)
    fb = s["fb"][:4].contiguous()
    sc = TRI_SCISSOR if scissor else None
    kw = dict(tile_h=th, tile_w=tw, layout=layout)
    full = rt._raster_tris_plain(fb, s["depth"], table, pair_tri, starts,
                                 counts, s["light"], sc, **kw)
    yy = (torch.arange(H) % th) // B
    xx = (torch.arange(W) % tw) // B
    rows = pair_tri[torch.clamp(starts[:, None] + torch.arange(ns)[None, :],
                                max=pair_tri.shape[0] - 1).long()]
    for by in range(th // B):
        for bx in range(tw // B):
            k = keep[:, by, bx]                            # (T, S)
            order = torch.argsort((~k).to(torch.int8), dim=1, stable=True)
            cut = torch.gather(rows, 1, order).reshape(-1).contiguous()
            out = rt._raster_tris_plain(
                fb, s["depth"], table, cut, (ti * ns).to(torch.int32),
                k.sum(1).to(torch.int32), s["light"], sc, **kw)
            m = (yy[:, None] == by) & (xx[None, :] == bx)
            assert torch.equal(out[0][:, m].view(torch.int32),
                               full[0][:, m].view(torch.int32)), (by, bx)
            assert torch.equal(out[1][m].view(torch.int32),
                               full[1][m].view(torch.int32)), (by, bx)
    return full


@pytest.mark.parametrize("scissor", [False, True], ids=["full", "scissor"])
def test_tri_in_block_drops_only_outside_pairs(scene, scissor):
    """B7's cull (tri_in_block) is exact: no pixel of a 16x16 block, or of
    a warp's two rows, is inside the edges of an entry dropped for it; and
    the plain version with each 16x16 block's lists cut to the kept
    entries (order kept) rasters that block bit for bit as with the whole
    lists, the scissor off and on. The scene carries torch_scenes' two
    slivers, which the plain version draws at a pixel past their AABB
    (another block, other rows): only the sliver rule keeps them there."""
    s, setup = scene
    setup, s = with_slivers(setup, s)
    table = rt.pack_tri_table(setup, s["normals"], s["colors"],
                              s["emissive"])
    full = _check_block_cull(rt.tri_in_block, "corners", table, setup, s,
                             scissor)
    for (x, y), alpha in zip(SLIVER_INSIDE, s["colors"][-2:, 3]):
        assert full[0][3, int(y), int(x)] == alpha, (x, y)


@pytest.mark.parametrize("scissor", [False, True], ids=["full", "scissor"])
def test_plane_in_block_drops_only_outside_pairs(scene, scissor):
    """B8's cull (plane_in_block) is exact: no pixel of a 16x16 block, or of
    a warp's two rows, is inside the edge planes of an entry dropped for
    it, in the walk's arithmetic (the slivers of torch_scenes included,
    which read inside past their AABB: the cull tests their own planes);
    and the plain version with each 16x16 block's lists cut to the kept
    entries (order kept) rasters that block bit for bit as with the whole
    lists, forward, the scissor off and on."""
    s, setup = scene
    setup, s = with_slivers(setup, s)
    table = rt.pack_tri_planes(
        setup["corners"], setup["depth"], setup["inv_w"], setup["area2"],
        setup["valid"], s["normals"], s["colors"], s["emissive"],
        s["metallic"], s["roughness"])
    _check_block_cull(rt.plane_in_block, "planes", table, setup, s, scissor)
