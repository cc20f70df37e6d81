"""Per-tile z-buffered triangle raster (port of
bevy_tpu/ops/raster3d_pallas.py; ref: the binned Opaque3d main pass of
bevy_core_pipeline, hardware-rasterised there). Conventions as in
ops/raster3d.py: reverse-z GREATER, CCW front faces ⇒ negative screen
area, y-down pixels.

- `pack_tri_table`: the (T, 40) corner records of kernel B7 (cols 0:29:
  corner screen xy, NDC depths, 1/w, 1/area2, corner normals premultiplied
  by their 1/w, base colour rgba, emissive rgb).
- `pack_tri_planes`: the (T, 40) plane-equation records of kernel B8
  (cols 0:33: three edge planes, the z, 1/w and premultiplied-normal
  planes, colour, emissive, metallic, perceptual roughness).
- `bin_tris`: the binning of `raster_tris_pallas` in PyTorch at static
  shapes (no host read): each valid on-screen triangle listed in every
  bin tile its screen AABB touches, a stable sort by tile, each tile's
  run in triangle order, capped at max_per_tile.
- `raster_tris`: kernels B7 (`layout="corners"`, replacing `_kernel`) and
  B8 (`"planes"` and `"planes_gbuf"`, replacing `_plane_kernel` and
  `_plane_kernel_gbuf`), all in `csrc/tri_raster.cu`, on CUDA tensors;
  the plain PyTorch version `_raster_tris_plain` on CPU tensors.
`bin_tris` + `raster_tris` are the port of `raster_tris_pallas`
(render/mesh3d.py calls them).

Each pixel walks its tile's run in order and takes a triangle where the
pixel centre is inside all three edges (inclusive, `<= 0`), the scissor
rect holds it (when one is given) and the interpolated depth beats the
pixel's strictly (`z > depth`): the sequential result, so an equal-depth
tie keeps the earlier triangle. The forward layouts write Lambert +
ambient + emissive over rgba; `"planes_gbuf"` writes G-buffer planes
0:12 (albedo rgba, world normal, emissive, metallic, roughness) and
passes planes 12 and up through.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops.binning import expand_runs
from bevy_tpu_torch.ops.shade import _pad_to, _to_int

F_PAD = 40
LAYOUTS = {"corners": 0, "planes": 1, "planes_gbuf": 2}
KERNEL_OF = {"corners": "B7", "planes": "B8", "planes_gbuf": "B8"}
_FIELDS = {"corners": 29, "planes": 33, "planes_gbuf": 33}
_WRITTEN = {"corners": 4, "planes": 4, "planes_gbuf": 12}
_PLAIN_CHUNK = 32       # list slots the plain version reduces at a time


def pack_tri_table(setup, normals, colors, emissive):
    """Setup dict (ops/raster3d.triangle_setup_corners) + per-corner world
    normals (T,3,3) + colours (T,4) + emissive (T,3) → (T, 40) corner
    records: 0:6 corner screen xy (ax ay bx by cx cy), 6:9 NDC depths,
    9:12 1/w, 12 1/area2 (0 for invalid rows), 13:22 corner normals
    premultiplied by their 1/w, 22:26 rgba, 26:29 emissive."""
    valid = setup["valid"]
    t = valid.shape[0]
    inv_a = torch.where(valid, 1.0 / torch.where(valid, setup["area2"], 1.0),
                        0.0)
    n_pre = normals * setup["inv_w"][:, :, None]
    return torch.cat([
        setup["corners"].reshape(t, 6), setup["depth"], setup["inv_w"],
        inv_a[:, None], n_pre.reshape(t, 9), colors, emissive,
        colors.new_zeros((t, F_PAD - 29))], 1)


def pack_tri_planes(corner_xy, depth, inv_w, area2, valid, normals, colors,
                    emissive, metallic=None, roughness=None):
    """Plane-equation records (T, 40): barycentrics are affine in screen
    space, so every interpolated quantity is a plane (A, B, C) and the
    kernel needs only multiply-adds. Inputs are per-triangle corner arrays
    (T, 3, …). Layout: 0:9 edge planes (A, B, C × 3; inside = all <= 0),
    9:12 z plane, 12:15 1/w plane, 15:24 normal planes (premultiplied by
    the corner 1/w), 24:28 rgba, 28:31 emissive, 31 metallic (default 0),
    32 perceptual roughness (default 0.5)."""
    t = valid.shape[0]
    ax, ay = corner_xy[:, 0, 0], corner_xy[:, 0, 1]
    bx, by = corner_xy[:, 1, 0], corner_xy[:, 1, 1]
    cx, cy = corner_xy[:, 2, 0], corner_xy[:, 2, 1]

    def edge(px0, py0, px1, py1):
        # e(p) = (x1-x0)(py-y0) - (y1-y0)(px-x0)
        return (-(py1 - py0), px1 - px0,
                (py1 - py0) * px0 - (px1 - px0) * py0)

    a0, b0, c0 = edge(bx, by, cx, cy)
    a1, b1, c1 = edge(cx, cy, ax, ay)
    a2, b2, c2 = edge(ax, ay, bx, by)
    inv_area = torch.where(valid, 1.0 / torch.where(valid, area2, 1.0), 0.0)

    def plane(q):       # q: (T, 3) corner values → affine (A, B, C)
        return [(q[:, 0] * e0 + q[:, 1] * e1 + q[:, 2] * e2) * inv_area
                for e0, e1, e2 in ((a0, a1, a2), (b0, b1, b2), (c0, c1, c2))]

    n_pre = normals * inv_w[:, :, None]
    cols = [a0, b0, c0, a1, b1, c1, a2, b2, c2]
    for q in (depth, inv_w, n_pre[:, :, 0], n_pre[:, :, 1], n_pre[:, :, 2]):
        cols += plane(q)
    if metallic is None:
        metallic = colors.new_zeros(t)
    if roughness is None:
        roughness = colors.new_full((t,), 0.5)
    return torch.cat([torch.stack(cols, 1), colors, emissive,
                      metallic[:, None], roughness[:, None],
                      colors.new_zeros((t, F_PAD - 33))], 1)


def bin_tris(valid, aabb, height, width, *, tile_h=32, tile_w=128,
             pairs_per_tri=2, max_per_tile=256, pair_budget=None):
    """Bin triangles into tile_h x tile_w tiles by screen AABB (T, 4).
    Returns (pair_tri, starts, counts, stats):
    - pair_tri (pair_cap,) int32: triangle ids sorted by tile, stable, so
      each tile's run is in triangle order;
    - starts, counts (tiles,) int32: each tile's run, cut to the first
      max_per_tile (padded to a multiple of 128, as the reference pads);
    - stats: pair_overflow (pairs past pair_cap = pair_budget or
      T * pairs_per_tri + tiles) and tile_overflow (the most entries past
      the padded max_per_tile in any tile), int32 scalars.
    The tile id rides a packed code (y0 * 1024 + x0) * 32 + kx, as in the
    reference: it assumes a triangle spans fewer than 32 tile columns and
    x0 < 1024 (true at 1280 px with 128-px tiles)."""
    dev = aabb.device
    t = valid.shape[0]
    mpt = _pad_to(max_per_tile, 128)
    nty = _pad_to(height, tile_h) // tile_h
    ntx = _pad_to(width, tile_w) // tile_w
    num_tiles = nty * ntx
    x0 = _to_int(torch.floor(aabb[:, 0] / tile_w))
    y0 = _to_int(torch.floor(aabb[:, 1] / tile_h))
    x1 = _to_int(torch.floor(aabb[:, 2] / tile_w))
    y1 = _to_int(torch.floor(aabb[:, 3] / tile_h))
    onscreen = (x1 >= 0) & (x0 < ntx) & (y1 >= 0) & (y0 < nty)
    x0, x1 = torch.clamp(x0, 0, ntx - 1), torch.clamp(x1, 0, ntx - 1)
    y0, y1 = torch.clamp(y0, 0, nty - 1), torch.clamp(y1, 0, nty - 1)
    kx, ky = x1 - x0 + 1, y1 - y0 + 1
    counts = torch.where(valid & onscreen, kx * ky, 0)
    pair_cap = pair_budget or (t * pairs_per_tri + num_tiles)
    owner, rank, pvalid, total = expand_runs(counts, pair_cap)
    # one packed gather instead of three
    c = ((y0 * 1024 + x0) * 32 + kx)[owner.long()]
    kxo = c % 32
    x0o = (c // 32) % 1024
    y0o = c // 32768
    tile_id = (y0o + rank // kxo) * ntx + (x0o + rank % kxo)
    tile_id = torch.where(pvalid, tile_id, num_tiles).to(torch.int32)
    sorted_tile, perm = torch.sort(tile_id, stable=True)
    pair_tri = owner[perm].contiguous()
    tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_tile, tids).to(torch.int32)
    ends = torch.searchsorted(sorted_tile, tids + 1).to(torch.int32)
    stats = {
        "pair_overflow": torch.clamp(total - pair_cap, min=0),
        "tile_overflow": torch.clamp(torch.amax(ends - starts) - mpt, min=0)
        .to(torch.int32),
    }
    return pair_tri, starts, torch.clamp(ends - starts, max=mpt), stats


BLOCK = 16          # kernel B7's CTA block: BLOCK x BLOCK pixels
WARP_ROWS = 2       # the rows of the block each of B7's warps walks
SLIVER = 2.0 ** -19  # B7's sliver bound, relative (see tri_in_block)


def tri_in_block(table, pair_tri, starts, counts, width, *, tile_h=32,
                 tile_w=128, block_h=BLOCK):
    """(T, tile_h // block_h, tile_w // BLOCK, S) bool, S = the longest
    list: which listed entries of each tile kernel B7 keeps for each
    block_h x BLOCK block of it, in plain PyTorch (for tests and
    measurement; the plain version walks the whole list). B7 culls each
    CTA's BLOCK x BLOCK block so (the default), and each warp's rows with
    block_h=WARP_ROWS.

    An entry is kept iff the screen AABB of its record's corners (table
    cols 0:6, the AABB bin_tris binned) overlaps the block by bin_tris'
    floor rule, the blocks numbered across the frame of `width` pixels
    (floor(min / block) <= block index <= floor(max / block)), or it is a
    sliver: |area2| <= SLIVER * M * M * (2M + tile_h + tile_w), M the
    AABB's longer side, area2 from the corners in triangle_setup_corners'
    order. A pixel centre outside a non-sliver's AABB (by >= 1/2 px, as
    every centre of a block the AABB misses is) reads outside its edges
    in float arithmetic; a sliver's can read inside (csrc/tri_raster.cu
    derives the bound), so B7 walks a sliver in every block of its
    tiles, as the reference does."""
    nt = counts.shape[0]
    ns = int(counts.max()) if nt else 0
    dev = table.device
    ntx = _pad_to(width, tile_w) // tile_w
    pmax = max(pair_tri.shape[0] - 1, 0)
    slot = torch.clamp(starts[:, None] + torch.arange(
        ns, dtype=torch.int32, device=dev)[None, :], max=pmax).long()
    c = table[pair_tri[slot].long(), :6]                   # (T, S, 6)
    ax, ay, bx_, by_, cx, cy = c.unbind(-1)
    x0 = torch.minimum(torch.minimum(ax, bx_), cx)
    x1 = torch.maximum(torch.maximum(ax, bx_), cx)
    y0 = torch.minimum(torch.minimum(ay, by_), cy)
    y1 = torch.maximum(torch.maximum(ay, by_), cy)
    m = torch.maximum(x1 - x0, y1 - y0)
    area2 = (bx_ - ax) * (cy - ay) - (by_ - ay) * (cx - ax)
    sliver = ~(torch.abs(area2) >
               m * m * (2.0 * m + float(tile_h + tile_w)) * SLIVER)
    t = torch.arange(nt, device=dev)
    bx = ((t % ntx) * (tile_w // BLOCK))[:, None] + \
        torch.arange(tile_w // BLOCK, device=dev)[None, :]
    by = ((t // ntx) * (tile_h // block_h))[:, None] + \
        torch.arange(tile_h // block_h, device=dev)[None, :]
    bx = bx.to(torch.float32)[:, None, :, None]
    by = by.to(torch.float32)[:, :, None, None]
    fx0, fx1 = (torch.floor(v / BLOCK)[:, None, None, :] for v in (x0, x1))
    fy0, fy1 = (torch.floor(v / block_h)[:, None, None, :] for v in (y0, y1))
    listed = torch.arange(ns, device=dev)[None, :] < counts[:, None]
    hit = (fx0 <= bx) & (fx1 >= bx) & (fy0 <= by) & (fy1 >= by)
    return (hit | sliver[:, None, None, :]) & listed[:, None, None, :]


def plane_in_block(table, pair_tri, starts, counts, width, *, tile_h=32,
                   tile_w=128, block_h=BLOCK):
    """(T, tile_h // block_h, tile_w // BLOCK, S) bool, S = the longest
    list: which listed entries of each tile kernel B8 walks for each
    block_h x BLOCK block of it, in plain PyTorch (for tests and
    measurement; the plain version walks the whole list). B8 culls each
    CTA's BLOCK x BLOCK block so (the default), and each warp's rows with
    block_h=WARP_ROWS: those are the entries a warp walks.

    An entry is kept iff none of its record's three edge planes (table
    cols 0:9, inside = all <= 0) reads > 0 at the block's least corner:
    the pixel centre picked by the signs of the plane's a and b, in the
    walk's arithmetic (a*px + b*py) + c. Each product and sum is rounded,
    and rounding is monotone, so that corner is where the edge reads least
    over the block's centres: a dropped entry reads outside at every
    centre of the block, slivers included. A NaN keeps the entry."""
    nt = counts.shape[0]
    ns = int(counts.max()) if nt else 0
    dev = table.device
    ntx = _pad_to(width, tile_w) // tile_w
    pmax = max(pair_tri.shape[0] - 1, 0)
    slot = torch.clamp(starts[:, None] + torch.arange(
        ns, dtype=torch.int32, device=dev)[None, :], max=pmax).long()
    e = table[pair_tri[slot].long(), :9][:, None, None]     # (T, 1, 1, S, 9)
    t = torch.arange(nt, device=dev)
    bx = ((t % ntx) * tile_w)[:, None] + \
        torch.arange(0, tile_w, BLOCK, device=dev)[None, :]
    by = ((t // ntx) * tile_h)[:, None] + \
        torch.arange(0, tile_h, block_h, device=dev)[None, :]
    x0 = (bx.to(torch.float32) + 0.5)[:, None, :, None]
    y0 = (by.to(torch.float32) + 0.5)[:, :, None, None]
    x1, y1 = x0 + float(BLOCK - 1), y0 + float(block_h - 1)
    keep = (torch.arange(ns, device=dev)[None, :] < counts[:, None]) \
        [:, None, None, :]
    for k in range(3):
        a, b, c = e[..., 3 * k], e[..., 3 * k + 1], e[..., 3 * k + 2]
        least = a * torch.where(a >= 0, x0, x1) + \
            b * torch.where(b >= 0, y0, y1) + c
        keep = keep & ~(least > 0)
    return keep


def _light_with_scissor(light, scissor, height, width):
    """The (16,) light vector with the scissor rect [x0, y0, x1, y1) in
    slots 9:13 (the whole target when scissor is None). Each slot is set
    in place on the light's device (a fill, or a device copy of a 0-d
    tensor): no blocking host-to-card copy a call."""
    sc = (0.0, 0.0, float(width), float(height)) if scissor is None \
        else scissor
    lv = light[:16].to(torch.float32, copy=True)
    for k, v in enumerate(sc):
        lv[9 + k].fill_(v)
    return lv


def _coverage(d, px, py, layout):
    """Inside-all-edges mask and interpolated depth of records `d` (a list
    of field tensors broadcasting against px / py), in the kernels'
    order."""
    if layout == "corners":
        ax, ay, bx, by, cx, cy = d[0:6]
        e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
        e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        z = e0 * d[12] * d[6] + e1 * d[12] * d[7] + e2 * d[12] * d[8]
        return (e0 <= 0) & (e1 <= 0) & (e2 <= 0), z
    inside = (d[0] * px + d[1] * py + d[2] <= 0) & \
        (d[3] * px + d[4] * py + d[5] <= 0) & \
        (d[6] * px + d[7] * py + d[8] <= 0)
    return inside, d[9] * px + d[10] * py + d[11]


def _shade(d, px, py, layout, lv):
    """The planes a pixel takes from record `d` (4 forward, 12 G-buffer),
    in the kernels' order."""
    if layout == "corners":
        ax, ay, bx, by, cx, cy = d[0:6]
        b0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * d[12]
        b1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * d[12]
        b2 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * d[12]
        iw = torch.clamp(b0 * d[9] + b1 * d[10] + b2 * d[11], min=1e-12)
        nx = (b0 * d[13] + b1 * d[16] + b2 * d[19]) / iw
        ny = (b0 * d[14] + b1 * d[17] + b2 * d[20]) / iw
        nz = (b0 * d[15] + b1 * d[18] + b2 * d[21]) / iw
        rgba, emi = d[22:26], d[26:29]
    else:
        iw = torch.clamp(d[12] * px + d[13] * py + d[14], min=1e-12)
        nx = (d[15] * px + d[16] * py + d[17]) / iw
        ny = (d[18] * px + d[19] * py + d[20]) / iw
        nz = (d[21] * px + d[22] * py + d[23]) / iw
        rgba, emi = d[24:28], d[28:31]
    inv_len = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                      min=1e-12))
    if layout == "planes_gbuf":
        return [*rgba, nx * inv_len, ny * inv_len, nz * inv_len, *emi,
                d[31], d[32]]
    lam = torch.clamp(-(nx * lv[0] + ny * lv[1] + nz * lv[2]) * inv_len,
                      min=0.0)
    return [rgba[k] * (lv[6 + k] + lv[3 + k] * lam) + emi[k]
            for k in range(3)] + [rgba[3]]


def _raster_tris_plain(fb, depth, table, pair_tri, starts, counts, light,
                       scissor=None, *, tile_h=32, tile_w=128,
                       layout="corners"):
    """Plain PyTorch version of B7/B8, every pixel of every tile at once.

    The kernels' walk keeps, per pixel, the first listed triangle whose
    depth is the largest of those covering the pixel, if it beats the
    incoming depth: each `z > depth` step only keeps a running maximum.
    So the list is reduced _PLAIN_CHUNK slots at a time (the chunk's
    largest covering z, its first slot on ties; a later chunk takes over
    only when strictly larger) and the winner alone is shaded afterwards,
    with the kernels' arithmetic in the kernels' order: the same bits as
    the slot-by-slot walk, in a few hundred tensor operations for a list
    of thousands. One host read (the longest list)."""
    nplanes, H, W = fb.shape
    dev = fb.device
    hp, wp = _pad_to(H, tile_h), _pad_to(W, tile_w)
    nty, ntx = hp // tile_h, wp // tile_w
    nt = nty * ntx
    nw = _WRITTEN[layout]
    lv = _light_with_scissor(light, scissor, H, W)
    ti = torch.arange(nt, device=dev)
    px = (torch.arange(tile_w, device=dev)[None, None, :]
          + ((ti % ntx) * tile_w)[:, None, None]).to(torch.float32) + 0.5
    py = (torch.arange(tile_h, device=dev)[None, :, None]
          + ((ti // ntx) * tile_h)[:, None, None]).to(torch.float32) + 0.5
    live = torch.ones((nt, tile_h, tile_w), dtype=torch.bool, device=dev)
    if scissor is not None:
        live = (px >= lv[9]) & (py >= lv[10]) & (px < lv[11]) & \
            (py < lv[12])

    def tiled(x):                        # (H, W) → (nt, tile_h, tile_w)
        x = torch.nn.functional.pad(x, (0, wp - W, 0, hp - H))
        return x.reshape(nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3) \
            .reshape(nt, tile_h, tile_w)

    def untiled(x):
        return x.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3) \
            .reshape(hp, wp)[:H, :W]

    fields = _FIELDS[layout]
    pmax = max(pair_tri.shape[0] - 1, 0)
    dep = tiled(depth)
    best = torch.full_like(dep, -1, dtype=torch.int64)   # winning slot
    for c0 in range(0, int(counts.max()) if nt else 0, _PLAIN_CHUNK):
        s = c0 + torch.arange(_PLAIN_CHUNK, device=dev)
        slot = torch.clamp(starts[:, None] + s[None, :], max=pmax).long()
        rows = table[pair_tri[slot].long()]        # (nt, _PLAIN_CHUNK, 40)
        d = [rows[..., k][:, :, None, None] for k in range(fields)]
        inside, z = _coverage(d, px[:, None], py[:, None], layout)
        take = inside & ~torch.isnan(z) & live[:, None] & \
            (s[None, :] < counts[:, None])[:, :, None, None]
        cand = torch.where(take, z, -torch.inf)
        cmax = cand.amax(1)
        first = torch.argmax((cand == cmax[:, None]).to(torch.int32), 1)
        win = cmax > dep
        dep = torch.where(win, cmax, dep)
        best = torch.where(win, c0 + first, best)
    slot = torch.clamp(starts[:, None, None] + best.clamp(min=0), max=pmax)
    rows = table[pair_tri[slot].long()]                   # (nt, th, tw, 40)
    new = _shade([rows[..., k] for k in range(fields)], px, py, layout, lv)
    hit = best >= 0
    out = torch.stack([untiled(torch.where(hit, v, tiled(fb[k])))
                       for k, v in enumerate(new)] +
                      [fb[k] for k in range(nw, nplanes)])
    return out, untiled(dep)


def raster_tris(fb, depth, table, pair_tri, starts, counts, light,
                scissor=None, *, tile_h=32, tile_w=128, layout="corners"):
    """Per-tile triangle raster (kernel B7 for layout="corners", B8 for
    "planes" / "planes_gbuf"; replaces the JAX package's
    `raster_tris_pallas` → `_kernel` / `_plane_kernel` /
    `_plane_kernel_gbuf`).

    fb (4, H, W) f32 planar linear rgba, or the (>= 12, H, W) G-buffer for
    "planes_gbuf"; depth (H, W) f32 reverse-z; table (T, 40) f32 from
    pack_tri_table ("corners") or pack_tri_planes; pair_tri, starts,
    counts from bin_tris; light (16,) f32 [dir xyz, light rgb, ambient
    rgb, …]; scissor None or the pixel rect (x0, y0, x1, y1) (floats or
    0-d tensors). Returns new (fb, depth) tensors (the inputs are never
    written).

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    `csrc/tri_raster.cu` (one thread per pixel, 16x16 CTAs inside the
    tile_h x tile_w bin tiles)."""
    if layout not in LAYOUTS:
        raise ValueError(f"raster_tris: unknown layout {layout!r}")
    kw = dict(tile_h=tile_h, tile_w=tile_w, layout=layout)
    dev = _cuda.call_device(fb, depth, table, pair_tri, starts, counts,
                            light)
    if dev.type == "cpu":
        return _raster_tris_plain(fb, depth, table, pair_tri, starts,
                                  counts, light, scissor, **kw)
    nplanes, H, W = fb.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    if tile_h % 16 or tile_w % 16:
        raise ValueError("raster_tris: tile_h and tile_w must be multiples "
                         "of 16")
    if nplanes < _WRITTEN[layout] or (layout != "planes_gbuf" and
                                      nplanes != 4):
        raise ValueError(f"raster_tris: {nplanes} planes for layout "
                         f"{layout!r}")
    # the cleared framebuffer may be an expanded view: read a dense copy
    fb, depth = fb.contiguous(), depth.contiguous()
    lv = _light_with_scissor(light, scissor, H, W)
    _cuda.require(depth, "depth", torch.float32, (H, W))
    _cuda.require(fb, "fb", torch.float32)
    _cuda.require(table, "table", torch.float32, (table.shape[0], F_PAD))
    _cuda.require(pair_tri, "pair_tri", torch.int32)
    _cuda.require(starts, "starts", torch.int32, (nty * ntx,))
    _cuda.require(counts, "counts", torch.int32, (nty * ntx,))
    _cuda.require(lv, "light", torch.float32, (16,))
    if layout != "corners" and table.data_ptr() % 16:
        raise ValueError("raster_tris: plane records must be 16-byte "
                         "aligned (B8 reads them as float4s)")
    out = torch.empty_like(fb)
    dep_out = torch.empty_like(depth)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.bt_tri_raster(
            fb.data_ptr(), depth.data_ptr(), table.data_ptr(),
            pair_tri.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            lv.data_ptr(), nplanes, H, W, tile_h, tile_w, ntx,
            LAYOUTS[layout], int(scissor is not None), out.data_ptr(),
            dep_out.data_ptr(), _cuda.stream_ptr(fb))
    _cuda.check(err, "bt_tri_raster")
    raster_tris.kernel_launches[KERNEL_OF[layout]] += 1
    return out, dep_out


raster_tris.kernel_launches = {"B7": 0, "B8": 0}
