"""Window-splat sprite raster (port of bevy_tpu/ops/raster2d_splat.py; ref:
the instanced alpha-blended sprite draw of
`bevy_sprite_render/src/render/mod.rs:442-499`).

- `build_sprite_windows`: kernel B5's preparation, in PyTorch at static
  shapes (no host read): the cull and z-sort of ops/raster2d.py, reversed
  to front to back (equal z: the later-spawned sprite in front), then one
  window per (sprite, 128-column x win_h-row block) it overlaps — a short
  sprite gets one tight window starting at its 8-aligned top row, a tall
  one the aligned band grid — and, for the kernel, each window listed in
  every 8-row block it covers, stably sorted by block, so each block's
  list keeps the global front-to-back window order.
- `sprite_splat`: kernel B5 (`csrc/sprite_splat.cu`, replacing
  `_splat_kernel`) on CUDA tensors; its plain PyTorch version
  `_sprite_splat_plain` on CPU tensors. The kernel walks, per warp (one
  row of 32 columns), only the windows that can cover a pixel of it;
  `sprite_in_warp` makes the same decisions in plain PyTorch.
The two together are the port of the JAX package's
`raster_sprites_splat` (render/sprite.py calls them).

Per pixel, B5 walks its block's windows front to back, under-compositing
into a premultiplied accumulator (`acc += T * src * a`, `T = 1 - a_acc`),
skipping a window where the pixel is already exactly opaque (the
reference skips a window whose covered pixels all are: the same test per
pixel), and merges the accumulator over the framebuffer as
`fb * (1 - a) + acc`. Static variants, as in the reference: `rotated`
(coverage by rotated local coordinates, whose uv terms the reference
takes from the window's first row and first column), `alpha_only` (the
atlas RGB planes are all ones: only the alpha plane is sampled) and bf16
sampling (both weight axes normalised, then rounded; the column pass
first, rounded to bf16, then the row pass).
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops.binning import expand_runs
from bevy_tpu_torch.ops.raster2d import (
    ROW, _bf16, _taps, cull_and_sort, sprite_bounds,
)
from bevy_tpu_torch.ops.shade import _to_int

WIN_W = 128
BLOCK_ROWS = 8     # kernel block height: tight windows start 8-aligned


def build_sprite_windows(packed, height, width, *, win_h=40,
                         windows_per_sprite=3, max_visible=None):
    """B5's preparation. Returns (pk, win, blk_win, blk_start, blk_count,
    stats):
    - pk (v, 17) f32: the visible sprites front to back;
    - win (wcap, 3) int32: each window's pk row, column and top row
      (rows past the window count hold -1);
    - blk_win (wcap * mb,) int32: window ids sorted by 8-row block
      (stable, so front to back inside a block);
    - blk_start, blk_count (ncols * nrb,) int32: each block's run;
    - stats: pair_overflow (windows past wcap = v * windows_per_sprite +
      8, rounded up to 32), tile_overflow (0, as in the reference) and
      visible_overflow, int32 scalars."""
    dev = packed.device
    ncols = (width + WIN_W - 1) // WIN_W
    W = ncols * WIN_W
    hp = (height + win_h - 1) // win_h * win_h
    nbands = hp // win_h
    order, vis, n_visible = cull_and_sort(packed, W, hp, max_visible)
    order, vis = order.flip(0), vis.flip(0)
    v = order.shape[0]
    pk = packed[order].contiguous()

    rx, ry = sprite_bounds(pk)
    x0, x1 = pk[:, 0] - rx, pk[:, 0] + rx
    y0, y1 = pk[:, 1] - ry, pk[:, 1] + ry
    c0 = torch.clamp(_to_int(torch.floor(x0 / WIN_W)), 0, ncols - 1)
    c1 = torch.clamp(_to_int(torch.floor((x1 - 1e-3) / WIN_W)), 0,
                     ncols - 1)
    b0 = torch.clamp(_to_int(torch.floor(y0 / win_h)), 0, nbands - 1)
    b1 = torch.clamp(_to_int(torch.floor((y1 - 1e-3) / win_h)), 0,
                     nbands - 1)
    nbx = c1 - c0 + 1
    single_band = (y1 - y0) <= (win_h - 8.0)
    nby = torch.where(single_band, 1, b1 - b0 + 1)
    counts = torch.where(vis, nbx * nby, 0)
    wcap = (v * windows_per_sprite + 8 + 31) // 32 * 32
    owner, rank, wvalid, total = expand_runs(counts, wcap)
    ymax = max(hp - win_h, 0)
    tight_y = torch.clamp(_to_int(torch.floor(y0)) & ~7, 0, ymax)
    ybase = torch.where(single_band, tight_y, b0 * win_h)
    ol = owner.long()
    nbxo = torch.clamp(nbx, min=1)[ol]
    col = torch.clamp(c0[ol] + rank % nbxo, 0, ncols - 1)
    wy = torch.clamp(ybase[ol] + (rank // nbxo) * win_h, 0, ymax)
    win = torch.where(wvalid[:, None], torch.stack([owner, col, wy], 1),
                      -1).to(torch.int32).contiguous()

    # every 8-row block each window covers, listed window-major; a stable
    # sort by block keeps the window order inside each block
    nrb = (hp + BLOCK_ROWS - 1) // BLOCK_ROWS
    mb = (win_h + BLOCK_ROWS - 1) // BLOCK_ROWS + 1
    rb0 = wy // BLOCK_ROWS
    rb1 = torch.clamp((wy + win_h - 1) // BLOCK_ROWS, max=nrb - 1)
    k = torch.arange(mb, dtype=torch.int32, device=dev)
    inb = wvalid[:, None] & (k[None, :] <= (rb1 - rb0)[:, None])
    nblocks = ncols * nrb
    blk = torch.where(inb, col[:, None] * nrb + rb0[:, None] + k[None, :],
                      nblocks).reshape(-1).to(torch.int32)
    sorted_blk, perm = torch.sort(blk, stable=True)
    blk_win = (perm // mb).to(torch.int32)
    bids = torch.arange(nblocks, dtype=torch.int32, device=dev)
    blk_start = torch.searchsorted(sorted_blk, bids).to(torch.int32)
    blk_count = torch.searchsorted(sorted_blk, bids + 1).to(torch.int32) \
        - blk_start
    stats = {
        "pair_overflow": torch.clamp(total - wcap, min=0),
        "tile_overflow": torch.zeros((), dtype=torch.int32, device=dev),
        "visible_overflow": torch.clamp(n_visible - v, min=0),
    }
    return pk, win, blk_win, blk_start, blk_count, stats


def sample_splat(atlas, d, lx, ly, bilinear, bf16, alpha_only):
    """B5's texture sample of sprites `d` (17 broadcasting tensors) at
    local offsets lx (column term) and ly (row term): the (r, g, b, a)
    tents, 1.0 for solid sprites (r, g, b None when alpha_only)."""
    _, ah, aw = atlas.shape
    hx, hy = d[2], d[3]
    u0, v0, u1, v1 = d[10], d[11], d[12], d[13]
    sx = (u1 - u0) / torch.clamp(2.0 * hx, min=1e-6)
    sy = (v1 - v0) / torch.clamp(2.0 * hy, min=1e-6)
    fx = u0 + (u1 - u0) * 0.5 + sx * lx
    fx = torch.minimum(torch.maximum(fx, torch.minimum(u0, u1)),
                       torch.maximum(u0, u1)) * aw - 0.5
    fy = v0 + (v1 - v0) * 0.5 + sy * ly
    fy = torch.minimum(torch.maximum(fy, torch.minimum(v0, v1)),
                       torch.maximum(v0, v1)) * ah - 0.5
    (ky0, ky1), (wy0, wy1) = _taps(fy, ah, bilinear, strict=False)
    (kx0, kx1), (wx0, wx1) = _taps(fx, aw, bilinear, strict=True)
    ny = torch.clamp(wy0 + wy1, min=1e-6)
    nx = torch.clamp(wx0 + wx1, min=1e-6)
    wy0, wy1, wx0, wx1 = wy0 / ny, wy1 / ny, wx0 / nx, wx1 / nx
    flat = atlas.reshape(4, -1)
    if bf16:
        wy0, wy1, wx0, wx1 = _bf16(wy0), _bf16(wy1), _bf16(wx0), _bf16(wx1)
        flat = _bf16(flat)
    textured = d[14] >= 0.0
    out = []
    for c in ((3,) if alpha_only else range(4)):
        a = flat[c]
        m0 = a[ky0 * aw + kx0] * wx0 + a[ky0 * aw + kx1] * wx1
        m1 = a[ky1 * aw + kx0] * wx0 + a[ky1 * aw + kx1] * wx1
        if bf16:
            m0, m1 = _bf16(m0), _bf16(m1)
        out.append(torch.where(textured, wy0 * m0 + wy1 * m1, 1.0))
    return [None, None, None, out[0]] if alpha_only else out


WARP_W = 32       # kernel B5's warp: one row of 32 columns


def sprite_in_warp(d, wy0, x0, y, *, win_h, rotated):
    """Which (window, warp) pairs kernel B5 walks, in plain PyTorch (for
    tests and measurement; the plain version walks every listed window at
    every pixel of its block). d: the windows' sprite rows as 17
    broadcasting tensors, wy0 their top rows; x0 the warp's first column
    (it covers x0 .. x0 + 31) and y its row, int tensors broadcasting
    against them.

    A window is kept iff its rows hold y and, in the walk's arithmetic at
    the segment's end centres pxa, pxb: unrotated, |py - cy| <= hy and
    neither pxa - cx > hx nor pxb - cx < -hx; rotated, neither local
    coordinate lies past the same side of [-h, h] at both ends. Each is
    monotone in px along the row (rounding is monotone), so a dropped
    window covers no pixel of the warp (csrc/sprite_splat.cu)."""
    pxa = x0.to(torch.float32) + 0.5
    pxb = (x0 + (WARP_W - 1)).to(torch.float32) + 0.5
    py = y.to(torch.float32) + 0.5
    cx, cy, hx, hy = d[0], d[1], d[2], d[3]
    rows = (y >= wy0) & (y < wy0 + win_h)
    if rotated:
        cs, sn = d[4], d[5]
        kx, ky = cs * cx + sn * cy, sn * cx - cs * cy
        lxa, lxb = (cs * pxa - kx) + sn * py, (cs * pxb - kx) + sn * py
        lya, lyb = (-sn * pxa + ky) + cs * py, (-sn * pxb + ky) + cs * py
        miss = ((lxa > hx) & (lxb > hx)) | ((lxa < -hx) & (lxb < -hx)) | \
            ((lya > hy) & (lyb > hy)) | ((lya < -hy) & (lyb < -hy))
        return rows & ~miss
    return rows & (torch.abs(py - cy) <= hy) & ~(pxa - cx > hx) & \
        ~(pxb - cx < -hx)


def _sprite_splat_plain(fb, pk, win, blk_win, blk_start, blk_count, atlas,
                        *, win_h=40, bilinear=True, bf16=False,
                        rotated=True, alpha_only=False):
    """Plain PyTorch version of B5: every pixel of every 8-row block at
    once, one Python step per list slot (slot < max(blk_count); one host
    read), with the kernel's arithmetic in the kernel's order."""
    _, H, W0 = fb.shape
    ncols = (W0 + WIN_W - 1) // WIN_W
    nb = blk_start.shape[0]
    nrb = nb // ncols
    dev = fb.device
    bi = torch.arange(nb, device=dev)
    xi = (torch.arange(WIN_W, device=dev)[None, None, :]
          + ((bi // nrb) * WIN_W)[:, None, None])
    yi = (torch.arange(BLOCK_ROWS, device=dev)[None, :, None]
          + ((bi % nrb) * BLOCK_ROWS)[:, None, None])
    px = xi.to(torch.float32) + 0.5
    py = yi.to(torch.float32) + 0.5
    zero = torch.zeros((nb, BLOCK_ROWS, WIN_W), dtype=torch.float32,
                       device=dev)
    acc_r, acc_g, acc_b, acc_a = zero, zero, zero, zero
    nslots = int(blk_count.max()) if nb else 0
    for s in range(nslots):
        on = (s < blk_count)[:, None, None]
        w = blk_win[torch.clamp(blk_start + s, 0,
                                max(blk_win.shape[0] - 1, 0)).long()].long()
        wrec = win[w]                                    # (nb, 3)
        row = pk[torch.clamp(wrec[:, 0], min=0).long()]
        d = [row[:, k][:, None, None] for k in range(ROW)]
        wy0 = wrec[:, 2][:, None, None]
        on = on & (yi >= wy0) & (yi < wy0 + win_h)
        cx, cy, hx, hy = d[0], d[1], d[2], d[3]
        if rotated:
            cs, sn = d[4], d[5]
            lxr = cs * px - (cs * cx + sn * cy)
            lyr = -sn * px + (sn * cx - cs * cy)
            lx, ly = lxr + sn * py, lyr + cs * py
            inside = (torch.abs(lx) <= hx) & (torch.abs(ly) <= hy)
            # the reference's uv terms: lx on the window's first row,
            # ly on its first column
            px0 = (wrec[:, 1] * WIN_W).to(torch.float32)[:, None, None] \
                + 0.5
            py0 = wy0.to(torch.float32) + 0.5
            lx_row = lxr + sn * py0
            ly_col = (-sn * px0 + (sn * cx - cs * cy)) + cs * py
        else:
            lx_row, ly_col = px - cx, py - cy
            inside = (torch.abs(lx_row) <= hx) & (torch.abs(ly_col) <= hy)
        tr, tg, tb, ta = sample_splat(atlas, d, lx_row, ly_col, bilinear,
                                      bf16, alpha_only)
        av = torch.where(inside & on, ta * d[9], 0.0)
        tav = (1.0 - acc_a) * av
        if alpha_only:
            acc_r = acc_r + d[6] * tav
            acc_g = acc_g + d[7] * tav
            acc_b = acc_b + d[8] * tav
        else:
            acc_r = acc_r + tr * d[6] * tav
            acc_g = acc_g + tg * d[7] * tav
            acc_b = acc_b + tb * d[8] * tav
        acc_a = acc_a + tav

    def unblock(x):
        return x.reshape(ncols, nrb, BLOCK_ROWS, WIN_W).permute(1, 2, 0, 3) \
            .reshape(nrb * BLOCK_ROWS, ncols * WIN_W)[:H, :W0]

    ia = 1.0 - unblock(acc_a)
    return torch.stack([fb[0] * ia + unblock(acc_r),
                        fb[1] * ia + unblock(acc_g),
                        fb[2] * ia + unblock(acc_b),
                        fb[3] * ia + unblock(acc_a)])


def sprite_splat(fb, pk, win, blk_win, blk_start, blk_count, atlas, *,
                 win_h=40, bilinear=True, bf16=False, rotated=True,
                 alpha_only=False):
    """Window-splat sprite raster (kernel B5; replaces the JAX package's
    `raster_sprites_splat` -> `_splat_kernel`).

    fb (4, H, W) f32 planar; pk (v, 17) f32 sprites front to back; win
    (wcap, 3) int32 windows; blk_win, blk_start, blk_count the 8-row
    blocks' window lists (from build_sprite_windows); atlas (4, AH, AW)
    f32 planar. Returns the new framebuffer (4, H, W).

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    `csrc/sprite_splat.cu` (four CTAs of 32 x 8 threads share each 8-row
    block of a 128-column strip; each warp walks the block's windows in
    order, culled to those `sprite_in_warp` keeps: the same bits)."""
    kw = dict(win_h=win_h, bilinear=bilinear, bf16=bf16, rotated=rotated,
              alpha_only=alpha_only)
    dev = _cuda.call_device(fb, pk, win, blk_win, blk_start, blk_count,
                            atlas)
    if dev.type == "cpu":
        return _sprite_splat_plain(fb, pk, win, blk_win, blk_start,
                                   blk_count, atlas, **kw)
    _, H, W = fb.shape
    ncols = (W + WIN_W - 1) // WIN_W
    nb = blk_start.shape[0]
    if nb % ncols or (nb // ncols) * BLOCK_ROWS < H:
        raise ValueError(f"sprite_splat: {nb} blocks do not tile a "
                         f"{H}x{W} frame")
    _cuda.require(fb, "fb", torch.float32, (4, H, W))
    _cuda.require(pk, "pk", torch.float32, (pk.shape[0], ROW))
    _cuda.require(win, "win", torch.int32, (win.shape[0], 3))
    _cuda.require(blk_win, "blk_win", torch.int32)
    _cuda.require(blk_start, "blk_start", torch.int32, (nb,))
    _cuda.require(blk_count, "blk_count", torch.int32, (nb,))
    _cuda.require(atlas, "atlas", torch.float32)
    if atlas.dim() != 3 or atlas.shape[0] != 4:
        raise ValueError("sprite_splat: atlas (4, AH, AW) expected")
    bits = int(bilinear) | int(bf16) << 1 | int(rotated) << 2 | \
        int(alpha_only) << 3
    out = torch.empty_like(fb)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.bt_sprite_splat(
            fb.data_ptr(), pk.data_ptr(), win.data_ptr(), blk_win.data_ptr(),
            blk_start.data_ptr(), blk_count.data_ptr(), atlas.data_ptr(),
            atlas.shape[1], atlas.shape[2], H, W, nb // ncols, win_h, bits,
            out.data_ptr(), _cuda.stream_ptr(fb))
    _cuda.check(err, "bt_sprite_splat")
    sprite_splat.launches += 1
    return out


sprite_splat.launches = 0
