"""The sprite kernels' plain PyTorch versions against the JAX package's
Pallas kernels in interpret mode, on the same packed arrays (made from a
seed with numpy).

- B4 (ops/raster2d.py, the tile raster) against `raster_sprites_pallas(
  interpret=True)`: f32 with sprite_batch 1 and 8, bilinear and nearest;
  bf16 with sprite_batch 8; rotated solid sprites; a max_visible
  overflow; a tile past max_per_tile, where the front-most sprites stay.
- B5 (ops/raster2d_splat.py, the window splat) against
  `raster_sprites_splat(interpret=True)`: four of the eight (rotated,
  alpha_only, f32/bf16) variants, chosen so every pair of flag values
  meets once (the variant code paths are independent per flag); tall
  multi-band sprites, equal-z ties and the opaque early skip on the
  bevymark variant.
- B4's per-block cull (`sprite_in_block`) and B5's per-warp cull
  (`sprite_in_warp`) drop no covered pair.

Tolerance 1e-5 (abs) where the rounding points are mirrored; the port
measures ~1e-6 (XLA's CPU backend contracts some multiply-adds into
FMAs, the port never does). One stated exception: B4 bf16, see
test_b4_bf16_matches_pallas.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_tpu.ops.raster2d_splat as jsplat
from bevy_tpu.ops.raster2d_pallas import raster_sprites_pallas
from bevy_tpu_torch.ops import raster2d, raster2d_splat

TOL = 1e-5
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs
    six workers on one machine's cores (measured on 8 cores: the three 2D
    port files take 83 s with 1 thread and 78 s with 8, at 41% of the CPU
    time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed, n=60, H=80, W=200, rot=False, big=False, ties=False,
           textured=0.7, atlas_hw=16):
    """Packed (n, 17) sprites over an (H, W) frame: random centres (some
    off-screen), sizes, tints and alphas (30% exactly opaque), uv rects
    (30% flipped), z in 6 levels (or all equal), 10% inactive; a framebuffer
    and a smooth (4, atlas_hw, atlas_hw) atlas."""
    rng = np.random.RandomState(seed)
    p = np.zeros((n, 17), np.float32)
    p[:, 0] = rng.uniform(-10, W + 10, n)
    p[:, 1] = rng.uniform(-10, H + 10, n)
    p[:, 2:4] = rng.uniform(2, 40 if big else 14, (n, 2))
    ang = rng.uniform(-3, 3, n) if rot else np.zeros(n)
    p[:, 4], p[:, 5] = np.cos(ang), np.sin(ang)
    p[:, 6:9] = rng.uniform(0.1, 1, (n, 3))
    p[:, 9] = np.where(rng.uniform(size=n) < 0.3, 1.0,
                       rng.uniform(0.3, 1, n))
    p[:, 12:14] = 1.0
    flip = rng.uniform(size=n) < 0.3
    p[flip, 10], p[flip, 12] = 1.0, 0.0
    tex = (rng.uniform(size=n) < textured) & (not rot)
    p[:, 14] = np.where(tex, 0.0, -1.0)
    p[:, 15] = 0.0 if ties else rng.randint(0, 6, n)
    p[:, 16] = (rng.uniform(size=n) < 0.9).astype(np.float32)
    fb = rng.uniform(0, 1, (4, H, W)).astype(np.float32)
    k = np.arange(atlas_hw, dtype=np.float32)
    yy, xx = np.meshgrid(k, k, indexing="ij")
    c = (atlas_hw - 1) / 2
    atlas = np.stack([xx / (atlas_hw - 1), yy / (atlas_hw - 1),
                      (xx + yy) % 2,
                      np.clip(np.hypot(xx - c, yy - c) / (c + 0.5), 0, 1)])
    return fb, p, atlas.astype(np.float32)


def _jax(fn, fb, p, atlas, **kw):
    out, st = fn(jnp.asarray(fb), jnp.asarray(p), jnp.asarray(atlas),
                 interpret=True, **kw)
    return np.asarray(out), {k: int(v) for k, v in st.items()}


def _b4(scene, sprite_batch=1, max_per_tile=256, max_visible=None,
        bilinear=True, sample_dtype="f32"):
    """JAX's tile raster and the port's (bin_sprites, then B4's plain
    version through its wrapper) on one scene."""
    want, jst = _jax(raster_sprites_pallas, *scene,
                     sprite_batch=sprite_batch, max_per_tile=max_per_tile,
                     max_visible=max_visible, bilinear=bilinear,
                     sample_dtype=sample_dtype)
    fb, p, atlas = (torch.from_numpy(x) for x in scene)
    *lists, st = raster2d.bin_sprites(p, fb.shape[1], fb.shape[2],
                                      max_per_tile=max_per_tile,
                                      max_visible=max_visible)
    got = raster2d.sprite_tiles(fb, *lists, atlas, bilinear=bilinear,
                                bf16=sample_dtype == "bf16")
    tst = {k: int(v) for k, v in st.items()}
    return np.abs(want - got.numpy()), jst, tst


# -- B4 -------------------------------------------------------------------


@pytest.mark.parametrize("sprite_batch", [1, 8])
@pytest.mark.parametrize("bilinear", [True, False],
                         ids=["bilinear", "nearest"])
def test_b4_f32_matches_pallas(sprite_batch, bilinear):
    err, jst, tst = _b4(_scene(0), sprite_batch, bilinear=bilinear)
    assert err.max() < TOL, err.max()
    assert jst == tst == {"pair_overflow": 0, "tile_overflow": 0,
                          "visible_overflow": 0}


def test_b4_bf16_matches_pallas():
    """bf16 sampling in _kernel_batched's order. Stated tolerance: XLA's
    CPU backend computes the reference's uu = (px - cx) * inv2hx + 0.5 as
    one FMA, so its fx may differ from the port's by one f32 ulp; where the
    column weight 1 - |k - fx| then sits exactly on a bf16 rounding tie
    (weights carry 7 bits below bf16's, so about 1 in 128) it rounds the
    other way, a 2^-13 weight step. Measured on this scene: max 9.9e-5 on
    a few pixels; 99.9% of values within 1e-5."""
    err, jst, tst = _b4(_scene(0), 8, sample_dtype="bf16")
    assert err.max() < 2e-4, err.max()
    assert (err > TOL).mean() < 0.002, (err > TOL).mean()
    assert jst == tst


def test_b4_rotated_solid_matches_pallas():
    err, _, _ = _b4(_scene(1, rot=True))
    assert err.max() < TOL, err.max()


def test_b4_max_visible_overflow_matches_pallas():
    """120 sprites, a budget of 40: compaction keeps the first 40 visible
    rows in spawn order before the z-sort."""
    err, jst, tst = _b4(_scene(2, n=120), max_visible=40)
    assert err.max() < TOL, err.max()
    assert jst["visible_overflow"] == tst["visible_overflow"] > 0


def test_b4_tile_overflow_keeps_front_most():
    """300 large sprites; max_per_tile 100 (padded to 128, as the
    reference pads it) overflows crowded tiles, which keep their
    front-most 128 sprites. The port's tile_overflow counts the overflow
    before the clamp (the reference's reads 0 after it: ROADMAP C3, not
    pinned here)."""
    scene = _scene(3, n=300, big=True)
    err, _, tst = _b4(scene, max_per_tile=100)
    assert err.max() < TOL, err.max()
    assert tst["tile_overflow"] > 0


def _b4_cull_pairs(fb, pk, pair, starts, counts, tile_h=32, tile_w=128):
    """(covered, kept) (pair, tile_h, tile_w) bools over every listed
    (tile, sprite) pair: the in-frame pixels of the tile the sprite covers,
    in the walk's arithmetic, and those of the 16 x 16 blocks
    sprite_in_block keeps it for."""
    _, H, W = fb.shape
    ntx = (W + tile_w - 1) // tile_w
    c = counts.long()
    tile = torch.repeat_interleave(torch.arange(c.shape[0]), c)
    rank = torch.arange(tile.shape[0]) - (torch.cumsum(c, 0) - c)[tile]
    row = pair[(starts.long()[tile] + rank)].long()
    d = [pk[row, k][:, None, None] for k in range(17)]
    x = ((tile % ntx) * tile_w)[:, None, None] + torch.arange(tile_w)
    y = ((tile // ntx) * tile_h)[:, None, None] + \
        torch.arange(tile_h)[:, None]
    dx, dy = (x.float() + 0.5) - d[0], (y.float() + 0.5) - d[1]
    covered = (torch.abs(d[4] * dx + d[5] * dy) <= d[2]) & \
        (torch.abs(-d[5] * dx + d[4] * dy) <= d[3]) & (x < W) & (y < H)
    b = raster2d.BLOCK
    kept = raster2d.sprite_in_block(d, x // b * b, y // b * b)
    return covered, kept


@pytest.mark.parametrize("scene", ["axis", "rot", "overflow",
                                   "straddle_axis", "straddle_rot"])
def test_sprite_in_block_drops_only_uncovered_pairs(scene):
    """B4's per-block cull (sprite_in_block, the kernel's decisions in
    plain PyTorch) drops no listed (pixel, sprite) pair the walk finds
    covered, and keeps fewer (block, sprite) pairs than the tiles list:
    axis-aligned and rotated scenes, an overflowing tile (front-most 128
    kept), and sprites centred within 2 px of 32-column boundaries (block
    edges too) with half-sizes down to 0.2 px."""
    from torch_scenes import b5_straddle_scene, sprite_scene
    bin_kw = {}
    if scene == "axis":
        fb, p, _ = sprite_scene(0, "cpu")
    elif scene == "rot":
        fb, p, _ = sprite_scene(1, "cpu", rot=True)
    elif scene == "overflow":
        fb, p, _ = sprite_scene(3, "cpu", n=300, big=True)
        bin_kw = dict(max_per_tile=100)
    else:
        fb, p, _ = b5_straddle_scene(10, "cpu", scene == "straddle_rot")
    pk, pair, starts, counts, st = raster2d.bin_sprites(
        p, fb.shape[1], fb.shape[2], **bin_kw)
    assert int(st["tile_overflow"] > 0) == (scene == "overflow")
    covered, kept = _b4_cull_pairs(fb, pk, pair, starts, counts)
    assert int(covered.sum()) > 0
    assert int((covered & ~kept).sum()) == 0
    blocks = kept[:, ::raster2d.BLOCK, ::raster2d.BLOCK]
    assert int(blocks.sum()) < blocks.numel()


# -- B5 -------------------------------------------------------------------


@pytest.fixture
def splat_chunk(monkeypatch):
    """The reference streams window records 32 to a DMA (CHUNK, a TPU
    transfer granularity); interpret mode unrolls one window body per
    chunk slot, which costs ~58 s of compile per variant at 32 and ~7 s at
    4 on this CPU. Traced with 4: the windows, their order and the
    arithmetic do not depend on it (only the window budget's rounding does,
    and every scene here asserts it stays inside the budget). The jit cache
    is cleared on both sides so no other test sees this trace."""
    jsplat.raster_sprites_splat.clear_cache()
    monkeypatch.setattr(jsplat, "CHUNK", 4)
    yield
    jsplat.raster_sprites_splat.clear_cache()


def _b5(scene, rotated, alpha_only, sample_dtype):
    """JAX's window splat and the port's (build_sprite_windows, then B5's
    plain version through its wrapper) on one scene; a window budget of 8
    a sprite for every scene (one compile a variant)."""
    want, jst = _jax(jsplat.raster_sprites_splat, *scene,
                     windows_per_sprite=8, rotated=rotated,
                     alpha_only=alpha_only, sample_dtype=sample_dtype)
    fb, p, atlas = (torch.from_numpy(x) for x in scene)
    *lists, st = raster2d_splat.build_sprite_windows(
        p, fb.shape[1], fb.shape[2], windows_per_sprite=8)
    got = raster2d_splat.sprite_splat(fb, *lists, atlas, rotated=rotated,
                                      alpha_only=alpha_only,
                                      bf16=sample_dtype == "bf16")
    assert jst["pair_overflow"] == int(st["pair_overflow"]) == 0
    return np.abs(want - got.numpy())


def _b5_scene(seed, rotated, alpha_only, **kw):
    """24 sprites on a 72 x 160 frame (two 128-column strips, two 40-row
    bands) with an 8 x 8 atlas; axis-aligned unless `rotated`; atlas RGB
    set to 1 for alpha_only."""
    fb, p, atlas = _scene(seed, n=24, H=72, W=160, atlas_hw=8, rot=rotated,
                          **kw)
    if alpha_only:
        atlas[:3] = 1.0
    return fb, p, atlas


@pytest.mark.parametrize("rotated,alpha_only,dtype", [
    (False, True, "bf16"),       # bevymark's variant
    (False, False, "f32"),
    (True, False, "bf16"),
    (True, True, "f32"),
], ids=["axis_alpha_bf16", "axis_rgb_f32", "rot_rgb_bf16", "rot_alpha_f32"])
def test_b5_variants_match_pallas(splat_chunk, rotated, alpha_only, dtype):
    kw = dict(rotated=rotated, alpha_only=alpha_only, sample_dtype=dtype)
    err = _b5(_b5_scene(4, rotated, alpha_only), **kw)
    assert err.max() < TOL, err.max()
    if not rotated:
        # the same compiled variant, with tall sprites (aligned bands),
        # all-equal z (later spawn in front) and an opaque front wall
        tall = _b5_scene(5, rotated, alpha_only, big=True)
        tall[1][:, 3] *= 2.0
        err = _b5(tall, **kw)
        assert err.max() < TOL, err.max()
        ties = _b5_scene(6, rotated, alpha_only, ties=True)
        ties[1][:, 0:2] = 60 + np.random.RandomState(6).uniform(
            -10, 10, (24, 2))
        ties[1][:, 16] = 1.0
        assert _b5(ties, **kw).max() < TOL
        wall = _b5_scene(7, rotated, alpha_only)
        wall[1][:, 0:2] = (80.0, 36.0)
        wall[1][:, 2:4] = 30.0
        wall[1][:, 15] = np.linspace(1, 0, 24)       # row 23 in front
        wall[1][:, 16] = 1.0
        wall[1][23, 9], wall[1][23, 14] = 1.0, -1.0  # opaque solid wall
        assert _b5(wall, **kw).max() < TOL


def _b5_cull_pairs(fb, pk, win, blk_win, blk_start, blk_count, *, win_h,
                   rotated):
    """(covered, kept) (pair, 8, 128) bools over every (block, listed
    window) pair: the pixels of the block the window covers, in the walk's
    arithmetic, and those of the warps sprite_in_warp keeps it for."""
    _, H, W = fb.shape
    nb = blk_start.shape[0]
    nrb = nb // ((W + 127) // 128)
    blk = torch.repeat_interleave(torch.arange(nb), blk_count.long())
    wrec = win[blk_win[:blk.shape[0]].long()]
    d = [pk[wrec[:, 0].long(), k][:, None, None] for k in range(17)]
    wy0 = wrec[:, 2][:, None, None]
    y = ((blk % nrb) * 8)[:, None, None] + torch.arange(8)[None, :, None]
    x = ((blk // nrb) * 128)[:, None, None] + torch.arange(128)[None, None, :]
    px, py = x.float() + 0.5, y.float() + 0.5
    cx, cy, hx, hy = d[0], d[1], d[2], d[3]
    if rotated:
        cs, sn = d[4], d[5]
        lx = (cs * px - (cs * cx + sn * cy)) + sn * py
        ly = (-sn * px + (sn * cx - cs * cy)) + cs * py
    else:
        lx, ly = px - cx, py - cy
    covered = (torch.abs(lx) <= hx) & (torch.abs(ly) <= hy) & \
        (y >= wy0) & (y < wy0 + win_h) & (x < W) & (y < H)
    kept = raster2d_splat.sprite_in_warp(d, wy0, x // 32 * 32, y,
                                         win_h=win_h, rotated=rotated)
    return covered, kept.expand(covered.shape)


@pytest.mark.parametrize("rotated", [False, True], ids=["axis", "rot"])
@pytest.mark.parametrize("scene", ["random", "straddle"])
def test_sprite_in_warp_drops_only_uncovered_pairs(scene, rotated):
    """B5's per-warp cull (sprite_in_warp, the kernel's decisions in plain
    PyTorch) drops no (pixel, window) pair the walk finds covered: random
    scenes, and sprites straddling 32-column boundaries with half-widths
    down to 0.2 px, rotated and axis-aligned."""
    if scene == "random":
        fb, p, _ = (torch.from_numpy(x) for x in _scene(
            9, n=60, H=72, W=200, rot=rotated, atlas_hw=8))
    else:
        from torch_scenes import b5_straddle_scene
        fb, p, _ = b5_straddle_scene(10, "cpu", rotated)
    *lists, st = raster2d_splat.build_sprite_windows(p, 72, 200,
                                                     windows_per_sprite=8)
    assert int(st["pair_overflow"]) == 0
    covered, kept = _b5_cull_pairs(fb, *lists, win_h=40, rotated=rotated)
    assert int(covered.sum()) > 0
    assert int((covered & ~kept).sum()) == 0
    assert int(kept.sum()) < kept.numel()


def test_b5_windows_keep_block_order():
    """Every window is listed in each 8-row block it covers, and each
    block's list keeps the global front-to-back window order."""
    _, p, _ = _scene(8, n=40, H=96, W=256, big=True)
    pk, win, blk_win, start, count, st = \
        raster2d_splat.build_sprite_windows(torch.from_numpy(p), 96, 256,
                                            windows_per_sprite=8)
    assert int(st["pair_overflow"]) == 0
    nrb = 120 // 8
    seen = {}
    for b in range(start.shape[0]):
        ws = blk_win[start[b]:start[b] + count[b]].tolist()
        assert ws == sorted(ws)
        for w in ws:
            assert win[w, 1] == b // nrb
            assert win[w, 2] // 8 <= b % nrb < (win[w, 2] + 40 + 7) // 8
            seen[w] = seen.get(w, 0) + 1
    valid = (win[:, 0] >= 0).nonzero().flatten().tolist()
    assert sorted(seen) == valid
    assert all(seen[w] == 5 for w in valid)     # 40 rows, 8-aligned
