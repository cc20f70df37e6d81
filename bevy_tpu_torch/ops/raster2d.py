"""Tile-binned 2D sprite raster (port of bevy_tpu/ops/raster2d.py and
bevy_tpu/ops/raster2d_pallas.py; ref: the instanced sprite draw of
`bevy_sprite_render/src/render/mod.rs:360,442,499` into the
back-to-front `Transparent2d` phase).

- `pack_sprite_instances`: one (N, 17) f32 row per sprite.
- `bin_sprites`: kernel B4's preparation, in PyTorch at static shapes
  (no host read): the cull, the compaction to a `max_visible` budget, the
  stable z-sort (back to front, ties in spawn order), the (sprite, tile)
  pair expansion, the stable tile sort and each tile's run.
- `sprite_tiles`: kernel B4 (`csrc/sprite_tiles.cu`, replacing
  `_kernel` / `_kernel_batched` of raster2d_pallas.py) on CUDA tensors;
  its plain PyTorch version `_sprite_tiles_plain` on CPU tensors;
  `sprite_in_block` replays the kernel's per-block cull.
The two together are the port of the JAX package's
`raster_sprites_pallas` (render/sprite.py calls them; one kernel covers
its `sprite_batch` bodies).

Per pixel, B4 walks its tile's run front to back and under-composites
(`acc += T * src * a`, `T = 1 - a_acc`); it stops once the pixel's alpha
is exactly 1.0 (every later term is scaled by T == 0). Coverage is exact
for rotated quads. Texture sampling uses separable bilinear (or nearest)
tent weights, renormalised at the atlas edge; rotated *textured* sprites
are sampled as if axis-aligned, as both Pallas kernels do (the uv comes
from the unrotated offset; ROADMAP C3). Two sampling orders, as in the
reference's two kernels:
- f32 (`_kernel`): both weight axes normalised; the row pass, then the
  column pass.
- bf16 (`_kernel_batched` with bf16 operands): the row weights are
  normalised and rounded to bf16, the row pass takes bf16 texels with f32
  sums and is rounded to bf16; the column weights are rounded to bf16
  unnormalised, and the column pass is multiplied by 1/sum afterwards.
Each weight axis has two non-zero taps at most, so a two-tap sum is the
reference's matmul (adding zeros is exact).
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops.binning import expand_runs
from bevy_tpu_torch.ops.shade import _pad_to, _to_int

ROW = 17      # packed sprite row width


def pack_sprite_instances(center, half, rot, color, uv_min, uv_max, tex, z,
                          active):
    """One (N, 17) f32 row per sprite (ref: the SpriteInstance vertex
    layout, render/mod.rs:442): [0:2] centre px, [2:4] half size px, [4]
    cos, [5] sin, [6:10] linear rgba, [10:12] uv_min, [12:14] uv_max,
    [14] tex (< 0: solid colour), [15] z, [16] active."""
    return torch.cat([
        center, half, torch.cos(rot)[:, None], torch.sin(rot)[:, None],
        color, uv_min, uv_max, tex.to(torch.float32)[:, None], z[:, None],
        active.to(torch.float32)[:, None]], 1)


def sprite_bounds(packed):
    """Screen AABB half extents (rx, ry) of each (rotated) sprite."""
    cs, sn = torch.abs(packed[:, 4]), torch.abs(packed[:, 5])
    return (cs * packed[:, 2] + sn * packed[:, 3],
            sn * packed[:, 2] + cs * packed[:, 3])


def cull_and_sort(packed, wp, hp, max_visible):
    """Visible sprites in back-to-front order (stable in the row index for
    equal z), within a budget of v = min(max_visible, N) rows. Returns
    (order (v,) int64, vis (v,) bool, n_visible () int32). With v < N the
    visible rows are compacted first (a cumsum rank and a scatter), so the
    sort shrinks to the budget (raster2d_pallas.py:373-397)."""
    n = packed.shape[0]
    dev = packed.device
    v = min(max_visible or n, n)
    rx, ry = sprite_bounds(packed)
    cx, cy = packed[:, 0], packed[:, 1]
    onscreen = (cx + rx > 0) & (cx - rx < wp) & (cy + ry > 0) & \
        (cy - ry < hp) & (packed[:, 2] > 0) & (packed[:, 3] > 0) & \
        (packed[:, 16] > 0.5)
    n_visible = onscreen.to(torch.int32).sum()
    z = packed[:, 15]
    if v < n:
        pos = torch.cumsum(onscreen.to(torch.int32), 0) - 1
        tgt = torch.where(onscreen & (pos < v), pos, v).long()
        cand = torch.zeros(v + 1, dtype=torch.int64, device=dev)
        cand.scatter_(0, tgt, torch.arange(n, device=dev))
        cand = cand[:v]
        cvalid = torch.arange(v, device=dev) < n_visible
        zc = torch.where(cvalid, z[cand], torch.inf)
        perm = torch.sort(zc, stable=True).indices
        return cand[perm], cvalid[perm], n_visible
    zkey = torch.where(onscreen, z, torch.inf)
    order = torch.sort(zkey, stable=True).indices
    return order, onscreen[order], n_visible


def bin_sprites(packed, height, width, *, tile_h=32, tile_w=128,
                pairs_per_sprite=4, max_per_tile=256, max_visible=None):
    """B4's preparation. Returns (pk, pair_sprite, starts, counts, stats):
    - pk (v, 17) f32: the visible sprites back to front;
    - pair_sprite (pair_cap,) int32: rows of pk, sorted by tile (stable,
      so back to front inside a tile);
    - starts, counts (tiles,) int32: each tile's run in pair_sprite,
      keeping the front-most max_per_tile (padded to a multiple of 128,
      as the reference pads it) of a longer run;
    - stats: pair_overflow (pairs past pair_cap = v * pairs_per_sprite +
      tiles), tile_overflow (the most sprites past max_per_tile in any
      tile, counted before the clamp; the reference clamps first and so
      always reports 0 — ROADMAP C3) and visible_overflow (visible
      sprites past the budget), int32 scalars."""
    dev = packed.device
    mpt = _pad_to(max_per_tile, 128)
    hp, wp = _pad_to(height, tile_h), _pad_to(width, tile_w)
    nty, ntx = hp // tile_h, wp // tile_w
    num_tiles = nty * ntx
    order, vis, n_visible = cull_and_sort(packed, wp, hp, max_visible)
    v = order.shape[0]
    pk = packed[order].contiguous()

    rx, ry = sprite_bounds(pk)
    x0 = torch.clamp(_to_int(torch.floor((pk[:, 0] - rx) / tile_w)), 0,
                     ntx - 1)
    x1 = torch.clamp(_to_int(torch.floor((pk[:, 0] + rx) / tile_w)), 0,
                     ntx - 1)
    y0 = torch.clamp(_to_int(torch.floor((pk[:, 1] - ry) / tile_h)), 0,
                     nty - 1)
    y1 = torch.clamp(_to_int(torch.floor((pk[:, 1] + ry) / tile_h)), 0,
                     nty - 1)
    kx, ky = x1 - x0 + 1, y1 - y0 + 1
    counts = torch.where(vis, kx * ky, 0)
    pair_cap = v * pairs_per_sprite + num_tiles
    owner, rank, valid, total = expand_runs(counts, pair_cap)
    ol = owner.long()
    kxo = torch.clamp(kx, min=1)[ol]
    tile_id = (y0[ol] + rank // kxo) * ntx + (x0[ol] + rank % kxo)
    tile_id = torch.where(valid, tile_id, num_tiles).to(torch.int32)
    sorted_tile, perm = torch.sort(tile_id, stable=True)
    pair_sprite = owner[perm].contiguous()
    tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_tile, tids).to(torch.int32)
    ends = torch.searchsorted(sorted_tile, tids + 1).to(torch.int32)
    stats = {
        "pair_overflow": torch.clamp(total - pair_cap, min=0),
        "tile_overflow": torch.clamp(torch.amax(ends - starts) - mpt, min=0)
        .to(torch.int32),
        "visible_overflow": torch.clamp(n_visible - v, min=0),
    }
    starts = torch.maximum(starts, ends - mpt)   # keep the front-most
    return pk, pair_sprite, starts, ends - starts, stats


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _taps(f, size, bilinear, strict):
    """The two candidate taps k0 = floor(f), k1 = k0 + 1 of a tent (or
    nearest: |k - f| <= 0.5, or < 0.5 when `strict`) weight row, with
    weights 0 outside [0, size). Returns (k0, k1) clamped into range as
    int64 and (w0, w1) f32."""
    k0f = torch.floor(f)
    out_k, out_w = [], []
    for kf in (k0f, k0f + 1.0):
        d = torch.abs(kf - f)
        if bilinear:
            w = torch.clamp(1.0 - d, min=0.0)
        else:
            w = ((d < 0.5) if strict else (d <= 0.5)).to(torch.float32)
        inr = (kf >= 0.0) & (kf <= size - 1.0)
        out_w.append(torch.where(inr, w, 0.0))
        out_k.append(torch.clamp(kf, 0.0, size - 1.0).long())
    return out_k, out_w


def sample_tiles(atlas, d, px, py, bilinear, bf16):
    """B4's texture sample of sprites `d` (a list of 17 tensors
    broadcasting against px/py) at pixel centres px, py: the (r, g, b, a)
    texel tents (1.0 for solid sprites), in the reference's order for f32
    (`_kernel`) or bf16 (`_kernel_batched`)."""
    _, ah, aw = atlas.shape
    cx, cy, hx, hy = d[0], d[1], d[2], d[3]
    u0, v0, u1, v1 = d[10], d[11], d[12], d[13]
    inv2hx = 1.0 / torch.clamp(2.0 * hx, min=1e-6)
    inv2hy = 1.0 / torch.clamp(2.0 * hy, min=1e-6)
    uu = (px - cx) * inv2hx + 0.5
    vv = (py - cy) * inv2hy + 0.5
    fx = torch.minimum(torch.maximum(u0 + uu * (u1 - u0),
                                     torch.minimum(u0, u1)),
                       torch.maximum(u0, u1)) * aw - 0.5
    fy = torch.minimum(torch.maximum(v0 + vv * (v1 - v0),
                                     torch.minimum(v0, v1)),
                       torch.maximum(v0, v1)) * ah - 0.5
    (ky0, ky1), (wy0, wy1) = _taps(fy, ah, bilinear, strict=False)
    (kx0, kx1), (wx0, wx1) = _taps(fx, aw, bilinear, strict=True)
    ny = torch.clamp(wy0 + wy1, min=1e-6)
    wy0, wy1 = wy0 / ny, wy1 / ny
    nx = torch.clamp(wx0 + wx1, min=1e-6)
    if bf16:
        wy0, wy1 = _bf16(wy0), _bf16(wy1)
        bx0, bx1 = _bf16(wx0), _bf16(wx1)
        inv_nx = 1.0 / nx
    else:
        wx0, wx1 = wx0 / nx, wx1 / nx
    flat = _bf16(atlas).reshape(4, -1) if bf16 else atlas.reshape(4, -1)
    out = []
    for c in range(4):
        a = flat[c]

        def tx(ky, kx):
            return a[ky * aw + kx]

        r0 = wy0 * tx(ky0, kx0) + wy1 * tx(ky1, kx0)
        r1 = wy0 * tx(ky0, kx1) + wy1 * tx(ky1, kx1)
        if bf16:
            t = (_bf16(r0) * bx0 + _bf16(r1) * bx1) * inv_nx
        else:
            t = r0 * wx0 + r1 * wx1
        out.append(torch.where(d[14] >= 0.0, t, 1.0))
    return out


BLOCK = 16    # kernel B4's CTA: a 16 x 16 pixel block inside a bin tile


def sprite_in_block(d, x0, y0):
    """Which (block, sprite) pairs kernel B4 walks, in plain PyTorch (for
    tests and measurement; the plain version walks every listed sprite at
    every pixel of its tile). d: the sprites' rows as 17 broadcasting
    tensors; x0, y0 the block's first column and row (it covers BLOCK x
    BLOCK pixels), int tensors broadcasting against them.

    A sprite is kept unless, in the walk's arithmetic (lx = cos*(px - cx)
    + sin*(py - cy), ly = -sin*(px - cx) + cos*(py - cy)), lx lies wholly
    past one side of [-hx, hx] or ly of [-hy, hy] at the block's pixel
    centres where it is least and greatest: the corners the signs of its
    coefficients pick. Each is monotone in px and in py (rounding is
    monotone), so a dropped sprite covers no pixel of the block; a NaN
    keeps it (csrc/sprite_tiles.cu)."""
    xa = x0.to(torch.float32) + 0.5
    xb = (x0 + (BLOCK - 1)).to(torch.float32) + 0.5
    ya = y0.to(torch.float32) + 0.5
    yb = (y0 + (BLOCK - 1)).to(torch.float32) + 0.5
    cx, cy, hx, hy, cs, sn = d[:6]

    def span(a, b):        # a*(px - cx) + b*(py - cy) at its least and most
        lo = a * (torch.where(a >= 0, xa, xb) - cx) + \
            b * (torch.where(b >= 0, ya, yb) - cy)
        hi = a * (torch.where(a >= 0, xb, xa) - cx) + \
            b * (torch.where(b >= 0, yb, ya) - cy)
        return lo, hi

    lx_lo, lx_hi = span(cs, sn)
    ly_lo, ly_hi = span(-sn, cs)
    return ~((lx_lo > hx) | (lx_hi < -hx) | (ly_lo > hy) | (ly_hi < -hy))


def _sprite_tiles_plain(fb, pk, pair_sprite, starts, counts, atlas, *,
                        tile_h=32, tile_w=128, bilinear=True, bf16=False):
    """Plain PyTorch version of B4: every pixel of every tile at once, one
    Python step per list slot (slot < max(counts); one host read), front
    to back, with the kernel's arithmetic in the kernel's order."""
    _, H, W = fb.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    nt = nty * ntx
    dev = fb.device
    ti = torch.arange(nt, device=dev)
    px = (torch.arange(tile_w, device=dev)[None, None, :]
          + ((ti % ntx) * tile_w)[:, None, None]).to(torch.float32) + 0.5
    py = (torch.arange(tile_h, device=dev)[None, :, None]
          + ((ti // ntx) * tile_h)[:, None, None]).to(torch.float32) + 0.5
    zero = torch.zeros((nt, tile_h, tile_w), dtype=torch.float32,
                       device=dev)
    pr, pg, pb, pa = zero, zero, zero, zero
    nslots = int(counts.max()) if nt else 0
    for s in range(nslots):
        on = s < counts
        idx = torch.clamp(starts + counts - 1 - s, 0,
                          max(pair_sprite.shape[0] - 1, 0))
        row = pk[pair_sprite[idx.long()].long()]            # (T, 17)
        d = [row[:, k][:, None, None] for k in range(ROW)]
        dx, dy = px - d[0], py - d[1]
        lx = d[4] * dx + d[5] * dy
        ly = -d[5] * dx + d[4] * dy
        inside = (torch.abs(lx) <= d[2]) & (torch.abs(ly) <= d[3]) & \
            on[:, None, None]
        tr, tg, tb, ta = sample_tiles(atlas, d, px, py, bilinear, bf16)
        a = torch.where(inside, ta * d[9], 0.0)
        t_ = 1.0 - pa
        pr = pr + t_ * tr * d[6] * a
        pg = pg + t_ * tg * d[7] * a
        pb = pb + t_ * tb * d[8] * a
        pa = pa + t_ * a

    def untile(x):
        return x.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3) \
            .reshape(nty * tile_h, ntx * tile_w)[:H, :W]

    ia = 1.0 - untile(pa)
    return torch.stack([fb[0] * ia + untile(pr), fb[1] * ia + untile(pg),
                        fb[2] * ia + untile(pb), fb[3] * ia + untile(pa)])


def sprite_tiles(fb, pk, pair_sprite, starts, counts, atlas, *, tile_h=32,
                 tile_w=128, bilinear=True, bf16=False):
    """Tile sprite raster (kernel B4; replaces the JAX package's
    `raster_sprites_pallas` -> `_kernel` / `_kernel_batched`).

    fb (4, H, W) f32 planar linear RGBA; pk (v, 17) f32 sprites back to
    front; pair_sprite (P,) int32 rows of pk by tile; starts, counts (T,)
    int32 each tile's run (from bin_sprites); atlas (4, AH, AW) f32
    planar. Returns the new framebuffer (4, H, W): each pixel's
    front-to-back under-composite of its tile's run, merged over fb as
    fb * (1 - a) + acc.

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    `csrc/sprite_tiles.cu` (one thread per pixel, 16x16 CTAs inside the
    tile_h x tile_w bin tiles, each walking only the sprites
    `sprite_in_block` keeps for it: the same bits)."""
    kw = dict(tile_h=tile_h, tile_w=tile_w, bilinear=bilinear, bf16=bf16)
    dev = _cuda.call_device(fb, pk, pair_sprite, starts, counts, atlas)
    if dev.type == "cpu":
        return _sprite_tiles_plain(fb, pk, pair_sprite, starts, counts,
                                   atlas, **kw)
    _, H, W = fb.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    if tile_h % 16 or tile_w % 16:
        raise ValueError("sprite_tiles: tile_h and tile_w must be "
                         "multiples of 16")
    _cuda.require(fb, "fb", torch.float32, (4, H, W))
    _cuda.require(pk, "pk", torch.float32, (pk.shape[0], ROW))
    _cuda.require(pair_sprite, "pair_sprite", torch.int32)
    _cuda.require(starts, "starts", torch.int32, (nty * ntx,))
    _cuda.require(counts, "counts", torch.int32, (nty * ntx,))
    _cuda.require(atlas, "atlas", torch.float32)
    if atlas.dim() != 3 or atlas.shape[0] != 4:
        raise ValueError("sprite_tiles: atlas (4, AH, AW) expected")
    out = torch.empty_like(fb)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.bt_sprite_tiles(
            fb.data_ptr(), pk.data_ptr(), pair_sprite.data_ptr(),
            starts.data_ptr(), counts.data_ptr(), atlas.data_ptr(),
            atlas.shape[1], atlas.shape[2], H, W, tile_h, tile_w, ntx,
            int(bilinear), int(bf16), out.data_ptr(), _cuda.stream_ptr(fb))
    _cuda.check(err, "bt_sprite_tiles")
    sprite_tiles.launches += 1
    return out


sprite_tiles.launches = 0
