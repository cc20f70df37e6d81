"""Visibility-buffer raster pieces (port of bevy_tpu/ops/raster3d_visbuf.py;
ref: bevy's meshlet software raster, `bevy_pbr/src/meshlet/`).

- `pack_planes_h`: clipless homogeneous triangle setup (Olano-Greer): edge
  and depth planes from the adjugate of the clip-space corner matrix, so
  near-plane straddlers need no clipping.
- `cluster_screen_aabbs` / `bin_clusters` / `cluster_records`: cluster
  culling, tile binning and the per-cluster record rows.
- `raster_visbuf`: the streaming-tile depth+id raster (kernel B2,
  `csrc/stream_raster.cu`, replacing `_stream_kernel` of the JAX package).
- `pack_flat_shade` / `resolve_flat`: shade-once flat forward resolve.
- `pack_flat_gbuf` / `resolve_gbuf_flat`: the flat deferred branch, one
  16-wide (24 with specular tint) record per triangle and one gather
  into the G-buffer planes.

Conventions: reverse-z GREATER (clear 0), CCW front faces, y-down pixels,
pixel centers at +0.5. Only the zrec (depth+id) half of the setup is
ported; the 64-wide shading records come with textured meshes.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops.binning import expand_runs

ZREC = 20   # per-tri z-record: 3 edge planes (9), z plane (3), id, aabb (4), pad


def _pad_to(x, m):
    return (x + m - 1) // m * m


def pack_planes_h(cc, cn, valid, width, height, id_base=0):
    """Homogeneous (clipless) triangle setup, full-frame viewport.

    cc: (..., 3, 4) clip-space corners; cn: (..., 3, 3) corner normals
    (unused by the zrec half; kept for the JAX signature); valid: (...,)
    bool. Returns (zrec (..., ZREC), valid_out (...,)). Leading dims are
    batch dims; triangle ids are global row-major over them + id_base.
    Every expression keeps the JAX package's evaluation order: the
    degenerate guards compare exact f32 values."""
    lead = cc.shape[:-2]
    t = 1
    for d in lead:
        t *= int(d)
    x, y, w = cc[..., 0], cc[..., 1], cc[..., 3]
    z = cc[..., 2]
    vx0, vy0, vx1, vy1 = 0.0, 0.0, float(width), float(height)
    vw, vh = vx1 - vx0, vy1 - vy0
    X = 0.5 * vw * x + (0.5 * vw + vx0) * w
    Y = -0.5 * vh * y + (0.5 * vh + vy0) * w
    W = w
    X0, X1, X2 = X[..., 0], X[..., 1], X[..., 2]
    Y0, Y1, Y2 = Y[..., 0], Y[..., 1], Y[..., 2]
    W0, W1, W2 = W[..., 0], W[..., 1], W[..., 2]
    # adjugate rows (adj @ M = det * I)
    a00 = Y1 * W2 - Y2 * W1
    a01 = X2 * W1 - X1 * W2
    a02 = X1 * Y2 - X2 * Y1
    a10 = Y2 * W0 - Y0 * W2
    a11 = X0 * W2 - X2 * W0
    a12 = X2 * Y0 - X0 * Y2
    a20 = Y0 * W1 - Y1 * W0
    a21 = X1 * W0 - X0 * W1
    a22 = X0 * Y1 - X1 * Y0
    det = X0 * a00 + Y0 * a01 + W0 * a02
    valid = valid & (det < 0.0)             # CCW front, y-down
    # degenerate guards: exact corner coincidence, then a relative
    # sliver bound (|det|/max|adj| ~ the smallest altitude in px)
    same01 = torch.all(cc[..., 0, :] == cc[..., 1, :], -1)
    same12 = torch.all(cc[..., 1, :] == cc[..., 2, :], -1)
    same02 = torch.all(cc[..., 0, :] == cc[..., 2, :], -1)
    valid = valid & ~(same01 | same12 | same02)
    adj = torch.stack([a00, a01, a02, a10, a11, a12, a20, a21, a22], -1)
    amax = torch.amax(torch.abs(adj), -1)
    valid = valid & (torch.abs(det) > 1e-3 * amax)
    nz = det != 0.0
    inv_det = torch.where(nz, 1.0 / torch.where(nz, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    gate = torch.where(valid, inv_det, torch.zeros_like(inv_det))
    e = adj * gate[..., None]              # positive-inside lambda/w planes
    z_plane = (z[..., 0:1] * e[..., 0:3] + z[..., 1:2] * e[..., 3:6] +
               z[..., 2:3] * e[..., 6:9])
    ids = torch.arange(t, dtype=torch.float32, device=cc.device).reshape(lead)
    tri_id = torch.where(valid, ids + float(id_base),
                         torch.full_like(ids, -1.0))
    # per-tri conservative screen AABB (full viewport for near-straddlers)
    w_ok = w > 1e-6
    iw = torch.where(w_ok, 1.0 / torch.where(w_ok, w, torch.ones_like(w)),
                     torch.zeros_like(w))
    sx = vx0 + (x * iw * 0.5 + 0.5) * vw
    sy = vy0 + (0.5 - y * iw * 0.5) * vh
    big = 3.4e38
    bx0 = torch.amin(torch.where(w_ok, sx, big), -1)
    bx1 = torch.amax(torch.where(w_ok, sx, -big), -1)
    by0 = torch.amin(torch.where(w_ok, sy, big), -1)
    by1 = torch.amax(torch.where(w_ok, sy, -big), -1)
    any_behind = torch.any(~w_ok, -1)
    aabb = torch.stack([torch.where(any_behind, vx0, bx0),
                        torch.where(any_behind, vy0, by0),
                        torch.where(any_behind, vx1, bx1),
                        torch.where(any_behind, vy1, by1)], -1)
    aabb = torch.where(valid[..., None], aabb, torch.zeros_like(aabb))
    zrec = torch.cat([-e, z_plane, tri_id[..., None], aabb,
                      torch.zeros(lead + (ZREC - 17,), dtype=torch.float32,
                                  device=cc.device)], -1)
    return zrec, valid


def cluster_screen_aabbs(cc, inst_ok, tri_valid, cs: int, width, height,
                         eps=1e-6):
    """Per-cluster conservative screen AABBs from clip-space corners.

    cc: (T, 3, 4) or (NCL, cs, 3, 4); inst_ok broadcastable to (NCL,);
    tri_valid (T,). Clusters with a corner at w <= eps get the full
    viewport. Returns (aabb (NCL,4), cl_valid (NCL,), zmax (NCL,)) — zmax
    the nearest reverse-z bound (the front-to-back sort key)."""
    if cc.ndim == 4:
        ncl = cc.shape[0]
        cc = cc.reshape(ncl * cs, 3, 4)
        tri_valid = tri_valid.reshape(ncl * cs)
    ncl = cc.shape[0] // cs
    vx0, vy0, vx1, vy1 = 0.0, 0.0, float(width), float(height)
    pts = cc.reshape(ncl, cs * 3, 4)
    w = pts[..., 3]
    x, y, zc = pts[..., 0], pts[..., 1], pts[..., 2]
    # conservative clip-space frustum cull (linear in homogeneous coords,
    # valid for any w sign)
    outside = (torch.all(x < -w, 1) | torch.all(x > w, 1) |
               torch.all(y < -w, 1) | torch.all(y > w, 1) |
               torch.all(zc > w, 1))
    ok = w > eps
    iw = torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                     torch.zeros_like(w))
    sx = vx0 + (x * iw * 0.5 + 0.5) * (vx1 - vx0)
    sy = vy0 + (0.5 - y * iw * 0.5) * (vy1 - vy0)
    big = 3.4e38
    x0 = torch.amin(torch.where(ok, sx, big), 1)
    x1 = torch.amax(torch.where(ok, sx, -big), 1)
    y0 = torch.amin(torch.where(ok, sy, big), 1)
    y1 = torch.amax(torch.where(ok, sy, -big), 1)
    any_behind = torch.any(~ok, 1)
    x0 = torch.where(any_behind, vx0, x0)
    y0 = torch.where(any_behind, vy0, y0)
    x1 = torch.where(any_behind, vx1, x1)
    y1 = torch.where(any_behind, vy1, y1)
    all_behind = torch.all(~ok, 1)
    cl_valid = (inst_ok.expand(ncl) & ~all_behind & ~outside &
                torch.any(tri_valid.reshape(ncl, cs), 1))
    zn = zc * iw
    zmax = torch.amax(torch.where(ok, zn, -big), 1)
    zmax = torch.where(any_behind, 1.0, torch.clamp(zmax, 0.0, 1.0))
    return torch.stack([x0, y0, x1, y1], 1), cl_valid, zmax


def bin_clusters(aabb, valid, *, ntx, nty, tile_w, tile_h,
                 max_clusters_per_tile, pair_budget, order_key=None):
    """Bin cluster AABBs to tiles (ref position: the binned-phase build of
    `render_phase/mod.rs:110`, at meshlet granularity). order_key, if
    given, is a per-cluster uint16 minor sort key (front-to-back). The
    sort is stable, so equal keys keep cluster order — that order decides
    equal-depth winners in the raster. Returns (cl_table (num_tiles,
    max_cl) int32 with -1 padding, cl_counts (num_tiles,) int32, stats);
    max_cl rounds up to a multiple of 128."""
    max_cl = _pad_to(max_clusters_per_tile, 128)
    num_tiles = ntx * nty
    dev = aabb.device
    x0 = torch.floor(aabb[:, 0] / tile_w).to(torch.int32)
    y0 = torch.floor(aabb[:, 1] / tile_h).to(torch.int32)
    x1 = torch.floor(aabb[:, 2] / tile_w).to(torch.int32)
    y1 = torch.floor(aabb[:, 3] / tile_h).to(torch.int32)
    onscreen = (x1 >= 0) & (x0 < ntx) & (y1 >= 0) & (y0 < nty) & \
        (aabb[:, 2] > aabb[:, 0]) & (aabb[:, 3] > aabb[:, 1])
    x0, x1 = torch.clamp(x0, 0, ntx - 1), torch.clamp(x1, 0, ntx - 1)
    y0, y1 = torch.clamp(y0, 0, nty - 1), torch.clamp(y1, 0, nty - 1)
    kx, ky = x1 - x0 + 1, y1 - y0 + 1
    counts = torch.where(valid & onscreen, kx * ky, 0)
    owner, rank, pvalid, total = expand_runs(counts, pair_budget)
    code = (y0 * 2048 + x0) * 32 + torch.clamp(kx, max=31)
    c = code[owner]
    kxo = c % 32
    x0o = (c // 32) % 2048
    y0o = c // 65536
    tile_id = (y0o + rank // kxo) * ntx + (x0o + rank % kxo)
    tile_id = torch.where(pvalid, tile_id, num_tiles)
    if order_key is None:
        key = tile_id
    else:
        key = tile_id * 65536 + torch.where(pvalid, order_key[owner], 0)
    perm = torch.argsort(key, stable=True)
    sorted_tile = (key[perm] // (1 if order_key is None else 65536)
                   ).to(torch.int32).contiguous()
    tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_tile, tids, side="left").to(torch.int32)
    ends = torch.searchsorted(sorted_tile, tids + 1, side="left").to(torch.int32)
    pair_cl = owner[perm]
    cl_counts = torch.clamp(ends - starts, max=max_cl)
    slot = starts[:, None] + torch.arange(max_cl, dtype=torch.int32,
                                          device=dev)[None, :]
    in_range = slot < ends[:, None]
    slot = torch.clamp(slot, max=pair_budget - 1)
    cl_table = torch.where(in_range, pair_cl[slot], -1).to(torch.int32)
    stats = {
        "pair_overflow": torch.clamp(total - pair_budget, min=0),
        "tile_overflow": torch.clamp(torch.amax(ends - starts) - max_cl,
                                     min=0),
    }
    return cl_table, cl_counts, stats


def cluster_records(zrec, cs: int):
    """(T, ZREC) → (NCL, rec_w): one contiguous record row per cluster,
    rec_w = cs*ZREC padded to a multiple of 128. Invalid triangles have
    all-zero records."""
    ncl = zrec.shape[0] // cs
    rec_w = _pad_to(cs * ZREC, 128)
    flat = zrec.reshape(ncl, cs * ZREC)
    return torch.nn.functional.pad(flat, (0, rec_w - cs * ZREC))


def _scissor_vec(scissor, device):
    """The scissor rect [x0, y0, x1, y1) as a (4,) f32 tensor on `device`,
    each slot set in place (a fill, or a device copy of a 0-d tensor): no
    blocking host read a call."""
    sc = torch.empty(4, dtype=torch.float32, device=device)
    for k, v in enumerate(scissor):
        sc[k].fill_(v)
    return sc


def _raster_visbuf_plain(depth, winner, recs, cl_table, cl_counts,
                         scissor=None, *, tile_h, tile_w, cs):
    """Plain PyTorch version of B2: every tile walks its cluster list in
    order, vectorized over tiles (one Python step per list slot and
    triangle)."""
    H, W = depth.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    nt = nty * ntx
    dev = depth.device

    def to_tiles(img):
        p = torch.nn.functional.pad(img, (0, ntx * tile_w - W,
                                          0, nty * tile_h - H))
        return p.reshape(nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3) \
            .reshape(nt, tile_h, tile_w)

    dep, win = to_tiles(depth), to_tiles(winner)
    ti = torch.arange(nt, device=dev)
    tx0 = ((ti % ntx) * tile_w).to(torch.float32)
    ty0 = ((ti // ntx) * tile_h).to(torch.float32)
    tx1, ty1 = tx0 + float(tile_w), ty0 + float(tile_h)
    px = (torch.arange(tile_w, device=dev).to(torch.float32)[None, None, :]
          + tx0[:, None, None]) + 0.5
    py = (torch.arange(tile_h, device=dev).to(torch.float32)[None, :, None]
          + ty0[:, None, None]) + 0.5
    sciss = True
    if scissor is not None:
        sc = _scissor_vec(scissor, dev)
        sciss = (px >= sc[0]) & (py >= sc[1]) & (px < sc[2]) & (py < sc[3])
    for slot in range(int(cl_counts.max()) if nt else 0):
        active = slot < cl_counts
        rec = recs[torch.clamp(cl_table[:, slot], min=0)]   # (nt, rec_w)
        for s in range(cs):
            def d(k, _b=s * ZREC):
                return rec[:, _b + k][:, None, None]
            hit = active & (rec[:, s * ZREC + 12] >= 0) & \
                (rec[:, s * ZREC + 15] > tx0) & (rec[:, s * ZREC + 13] < tx1) & \
                (rec[:, s * ZREC + 16] > ty0) & (rec[:, s * ZREC + 14] < ty1)
            inside = (d(0) * px + d(1) * py + d(2) <= 0) & \
                (d(3) * px + d(4) * py + d(5) <= 0) & \
                (d(6) * px + d(7) * py + d(8) <= 0)
            z = d(9) * px + d(10) * py + d(11)
            zpass = hit[:, None, None] & sciss & inside & (z > dep)
            dep = torch.where(zpass, z, dep)
            win = torch.where(zpass, d(12), win)

    def from_tiles(t):
        return t.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3) \
            .reshape(nty * tile_h, ntx * tile_w)[:H, :W]

    return from_tiles(dep), from_tiles(win)


STREAM_BLOCK_H, STREAM_BLOCK_W = 16, 64    # kernel B2's CTA block


def tri_in_stream_block(recs, cl_table, cl_counts, height, width, *,
                        tile_h=32, tile_w=128, cs=12):
    """(T, nby, nbx, S, cs) bool, nby = ceil(tile_h / STREAM_BLOCK_H), nbx =
    ceil(tile_w / STREAM_BLOCK_W), S = the longest list: which (listed
    cluster, triangle) entries of each tile kernel B2 walks in each
    STREAM_BLOCK_H x STREAM_BLOCK_W block of it, in plain PyTorch (for
    tests and measurement; the plain version walks the whole list).

    An entry is kept iff its cluster is listed (id >= 0), it passes the
    reference's tile test (valid id, screen AABB against the whole tile)
    and no edge reads > 0 at the block's least corner: the centre of the
    block's part in the tile and the frame picked by the signs of the
    edge's d0 and d1, in the walk's arithmetic (d0*px + d1*py) + d2. Each
    product and sum is rounded, and rounding is monotone, so that corner
    is where the edge reads least over the block: a dropped entry reads
    outside at every centre of the block. A NaN keeps the entry. A block
    with no pixel in the frame keeps nothing."""
    nty, ntx = _pad_to(height, tile_h) // tile_h, _pad_to(width, tile_w) \
        // tile_w
    nt = nty * ntx
    dev = recs.device
    bh, bw = STREAM_BLOCK_H, STREAM_BLOCK_W
    nby, nbx = -(-tile_h // bh), -(-tile_w // bw)
    ns = min(int(cl_counts.max()), cl_table.shape[1]) if nt else 0
    ids = cl_table[:, :ns]
    listed = (torch.arange(ns, device=dev)[None, :] < cl_counts[:, None]) & \
        (ids >= 0)
    d = recs[ids.clamp(min=0).long()][..., :cs * ZREC] \
        .reshape(nt, ns, cs, ZREC)
    ti = torch.arange(nt, device=dev)
    tx0, ty0 = (ti % ntx) * tile_w, (ti // ntx) * tile_h
    fx0, fy0 = tx0.to(torch.float32)[:, None, None], \
        ty0.to(torch.float32)[:, None, None]
    hit = listed[..., None] & (d[..., 12] >= 0) & (d[..., 15] > fx0) & \
        (d[..., 13] < fx0 + float(tile_w)) & (d[..., 16] > fy0) & \
        (d[..., 14] < fy0 + float(tile_h))
    x0 = tx0[:, None] + torch.arange(nbx, device=dev)[None, :] * bw
    y0 = ty0[:, None] + torch.arange(nby, device=dev)[None, :] * bh
    x1 = torch.minimum(torch.minimum(x0 + bw, tx0[:, None] + tile_w),
                       torch.full_like(x0, width))
    y1 = torch.minimum(torch.minimum(y0 + bh, ty0[:, None] + tile_h),
                       torch.full_like(y0, height))
    cx0, cx1 = ((v.to(torch.float32) + 0.5)[:, None, :, None, None]
                for v in (x0, x1 - 1))
    cy0, cy1 = ((v.to(torch.float32) + 0.5)[:, :, None, None, None]
                for v in (y0, y1 - 1))
    keep = hit[:, None, None] & \
        ((x0 < x1)[:, None, :] & (y0 < y1)[:, :, None])[..., None, None]
    e = d[:, None, None]
    for k in range(3):
        a, b, c = e[..., 3 * k], e[..., 3 * k + 1], e[..., 3 * k + 2]
        least = a * torch.where(a >= 0, cx0, cx1) + \
            b * torch.where(b >= 0, cy0, cy1) + c
        keep = keep & ~(least > 0)
    return keep


def raster_visbuf(depth, winner, recs, cl_table, cl_counts, scissor=None, *,
                  tile_h=32, tile_w=128, cs=12):
    """Streaming-tile visbuffer raster (kernel B2; replaces the JAX
    package's `raster_visbuf` → `_stream_kernel`).

    depth/winner (H, W) f32; recs (NCL, rec_w) from cluster_records;
    cl_table (num_tiles, max_cl) int32 and cl_counts (num_tiles,) int32
    from bin_clusters; scissor None or the pixel rect (x0, y0, x1, y1)
    (floats or 0-d tensors). Each tile walks its cluster list in order:
    per triangle a screen-AABB reject, then the inclusive edge test
    `(d0*px + d1*py) + d2 <= 0` on 3 edges and a strict `z > depth`, at
    the pixels inside the scissor. Returns new (depth, winner f32 tri ids,
    -1 = none); the inputs are never written.

    The kernel reads cluster rows by id from `recs` (the JAX kernel DMAs
    pre-gathered per-tile copies, tile_chunk_records — a block loading its
    own rows needs no copy). CPU tensors run the plain PyTorch version;
    CUDA tensors launch `csrc/stream_raster.cu` (16 x 64-pixel CTAs, each
    walking the entries tri_in_stream_block keeps for its block)."""
    dev = _cuda.call_device(depth, winner, recs, cl_table, cl_counts)
    if dev.type == "cpu":
        return _raster_visbuf_plain(depth, winner, recs, cl_table, cl_counts,
                                    scissor, tile_h=tile_h, tile_w=tile_w,
                                    cs=cs)
    if depth.dim() != 2 or recs.dim() != 2 or cl_table.dim() != 2:
        raise ValueError("raster_visbuf: depth (H, W), recs (NCL, rec_w) "
                         "and cl_table (num_tiles, max_cl) expected")
    H, W = depth.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    nt, max_cl = cl_table.shape
    rec_w = recs.shape[1]
    if nt != nty * ntx:
        raise ValueError(f"cl_table has {nt} tiles, the frame {nty * ntx}")
    if not 1 <= cs <= 256 or cs * ZREC > rec_w:
        raise ValueError("raster_visbuf: cs must be in 1..256 and cs * ZREC "
                         "<= rec_w")
    if rec_w % 4 or recs.data_ptr() % 16:
        raise ValueError("raster_visbuf: recs rows must be 16-byte aligned "
                         "(rec_w a multiple of 4), as cluster_records makes "
                         "them")
    _cuda.require(depth, "depth", torch.float32)
    _cuda.require(winner, "winner", torch.float32, (H, W))
    _cuda.require(recs, "recs", torch.float32)
    _cuda.require(cl_table, "cl_table", torch.int32)
    _cuda.require(cl_counts, "cl_counts", torch.int32, (nt,))
    sc = None if scissor is None else _scissor_vec(scissor, dev)
    dep_out = torch.empty_like(depth)
    win_out = torch.empty_like(winner)
    vec_ok = int(depth.data_ptr() % 16 == 0 and winner.data_ptr() % 16 == 0)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.bt_stream_raster(
            recs.data_ptr(), rec_w, cl_table.data_ptr(), max_cl,
            cl_counts.data_ptr(), nt, ntx, cs, tile_h, tile_w, H, W,
            depth.data_ptr(), winner.data_ptr(),
            None if sc is None else sc.data_ptr(), vec_ok,
            dep_out.data_ptr(), win_out.data_ptr(), _cuda.stream_ptr(depth))
    _cuda.check(err, "bt_stream_raster")
    raster_visbuf.launches += 1
    return dep_out, win_out


raster_visbuf.launches = 0


def pack_flat_shade(cn, materials, light_vec, valid):
    """Per-triangle FLAT shade records (..., 8): with identical corner
    normals per triangle, shade once at pack time. materials (..., 9):
    rgba, emissive, metallic, roughness."""
    lead = cn.shape[:-2]
    n = cn[..., 0, :]
    n = n * torch.rsqrt(torch.clamp(torch.sum(n * n, -1, keepdim=True),
                                    min=1e-12))
    lam = torch.clamp(-(n[..., 0] * light_vec[0] + n[..., 1] * light_vec[1] +
                        n[..., 2] * light_vec[2]), min=0.0)
    rgb = materials[..., 0:3] * (light_vec[6:9] +
                                 light_vec[3:6] * lam[..., None]) + \
        materials[..., 4:7]
    out = torch.cat([rgb, materials[..., 3:4],
                     torch.zeros(lead + (4,), dtype=torch.float32,
                                 device=cn.device)], -1)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def resolve_flat(winner, flat_rec, color_planar):
    """Compose per-pixel colors from flat-shade records (one 8-wide row
    gather; winner == -1 keeps the input)."""
    ok = winner >= 0
    rec = flat_rec[torch.clamp(winner, min=0)]         # (H, W, 8)
    return torch.where(ok[None], rec[..., 0:4].permute(2, 0, 1), color_planar)


def pack_flat_gbuf(cn, materials, valid):
    """Flat-mesh G-buffer records, one 16-wide table: [albedo rgba, normal
    xyz, pad, emissive rgb, metallic, roughness, clearcoat, clearcoat
    roughness, reflectance]; materials with specular tint (18+ columns)
    append tint rgb + 5 pad (24 wide). materials (..., 9 or 15+): rgba,
    emissive, metallic, roughness, clearcoat, ccr, anisotropy, anisotropy
    rotation, parallax depth scale, reflectance[, tint rgb]. Leading dims
    are batch dims (see pack_planes_h)."""
    lead = cn.shape[:-2]
    dev = cn.device
    n = cn[..., 0, :]
    n = n * torch.rsqrt(torch.clamp(torch.sum(n * n, -1, keepdim=True),
                                    min=1e-12))
    if materials.shape[-1] < 15:
        pad = torch.zeros(lead + (15 - materials.shape[-1],),
                          dtype=torch.float32, device=dev)
        pad[..., -1] = 0.5                       # default reflectance
        materials = torch.cat([materials, pad], -1)
    parts = [materials[..., 0:4], n,
             torch.zeros(lead + (1,), dtype=torch.float32, device=dev),
             materials[..., 4:11], materials[..., 14:15]]
    if materials.shape[-1] >= 18:
        parts += [materials[..., 15:18],
                  torch.zeros(lead + (5,), dtype=torch.float32, device=dev)]
    ab = torch.cat(parts, -1)
    return torch.where(valid[..., None], ab, torch.zeros_like(ab))


def resolve_gbuf_flat(winner, frec, gbuf):
    """G-buffer write from flat records: one row gather per pixel. Plane
    order: albedo rgba 0:4, normal 4:7, emissive 7:10, metallic 10,
    roughness 11, clearcoat 12, clearcoat roughness 13, anisotropy
    tangent + strength 14:18 (zero: flat meshes shade isotropic),
    reflectance 18, specular tint 19:22 (22-plane G-buffers).
    winner == -1 keeps the incoming gbuf.

    With 24-wide tinted records and 22 planes the JAX twin raises (its
    concatenation makes 25 planes); here the tint fills planes 19:22."""
    ok = winner >= 0
    # gathered planar, from the transposed table: (16|24, H, W), contiguous
    ab = frec.t()[:, torch.clamp(winner, min=0)]
    nplanes = gbuf.shape[0]
    planes = torch.cat([ab[0:7], ab[8:15]])                 # 14
    if nplanes > 14:
        planes = torch.cat([planes, torch.zeros(
            (nplanes - 14,) + planes.shape[1:], dtype=planes.dtype,
            device=planes.device)])
    if nplanes >= 19:
        planes[18] = ab[15]
    if nplanes >= 22 and frec.shape[-1] >= 19:
        planes[19:22] = ab[16:19]
    return torch.where(ok[None], planes, gbuf)
