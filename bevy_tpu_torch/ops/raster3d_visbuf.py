"""Visibility-buffer raster pieces (port of bevy_tpu/ops/raster3d_visbuf.py;
ref: bevy's meshlet software raster, `bevy_pbr/src/meshlet/`).

- `pack_planes_h`: clipless homogeneous triangle setup (Olano-Greer): edge
  and depth planes from the adjugate of the clip-space corner matrix, so
  near-plane straddlers need no clipping; with `build_srec=True` also the
  64-wide shade records (SREC) of smooth, textured and skinned meshes.
- `cluster_screen_aabbs` / `bin_clusters` / `cluster_records`: cluster
  culling, tile binning and the per-cluster record rows.
- `raster_visbuf`: the streaming-tile depth+id raster (kernel B2,
  `csrc/stream_raster.cu`, replacing `_stream_kernel` of the JAX package).
- `pack_flat_shade` / `resolve_flat`: shade-once flat forward resolve.
- `pack_flat_gbuf` / `resolve_gbuf_flat`: the flat deferred branch, one
  16-wide (24 with specular tint) record per triangle and one gather
  into the G-buffer planes.
- `sample_atlas`, `resolve_shade`, `resolve_forward`, `resolve_gbuf`: the
  shade-record resolves — one 64-wide row gather a pixel,
  perspective-correct normals and UVs, the material atlas (base colour,
  normal map, emissive / metallic-roughness / occlusion textures,
  lightmap, parallax occlusion), forward Lambert or the G-buffer write.

Conventions: reverse-z GREATER (clear 0), CCW front faces, y-down pixels,
pixel centers at +0.5.

Shade record slots (SREC = 64 floats, 67 with specular tint): 1/w plane
0:3, normal/w planes 3:12, rgba 12:16, emissive 16:19, metallic 19,
roughness 20, u/w and v/w planes 21:27, base-colour rect 27:31, tangent
31:34, normal-map rect 34:38, lightmap rect 38:42, clearcoat and its
roughness 42:44, anisotropy strength and rotation 44:46, depth-map rect
46:50, parallax depth scale 50, emissive / metallic-roughness /
occlusion rects 51:55 / 55:59 / 59:63, reflectance 63, specular tint
64:67. A rect with u1 <= u0 is absent.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.math.quat import cross
from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops.binning import expand_runs

ZREC = 20   # per-tri z-record: 3 edge planes (9), z plane (3), id, aabb (4), pad
SREC = 64   # per-tri shade record (see the module docstring)


def _pad_to(x, m):
    return (x + m - 1) // m * m


def pack_planes_h(cc, cn, valid, width, height, id_base=0, *,
                  viewport=None, build_srec=False, materials=None, cuv=None,
                  tex_rect=None,
                  tangents=None, nm_rect=None, lm_rect=None, dm_rect=None,
                  em_rect=None, mr_rect=None, oc_rect=None):
    """Homogeneous (clipless) triangle setup.

    cc: (..., 3, 4) clip-space corners; cn: (..., 3, 3) corner normals;
    valid: (...,) bool. Returns (zrec (..., ZREC), valid_out (...,)), or
    with `build_srec` (zrec, srec (..., SREC or SREC + 3), valid_out).
    Leading dims are batch dims; triangle ids are global row-major over
    them + id_base. Every expression keeps the JAX package's evaluation
    order: the degenerate guards compare exact f32 values. viewport: None
    (the full frame) or the pixel rect (x0, y0, x1, y1) NDC maps onto
    (floats, 0-d tensors or a (4,) tensor: a camera's viewport on the
    device); the planes are in absolute framebuffer pixels.

    The shade record's inputs (all per triangle, (..., k)): materials
    (..., 9 | 15 | 18) [rgba, emissive, metallic, roughness, clearcoat,
    clearcoat roughness, anisotropy strength, anisotropy rotation,
    parallax depth scale, reflectance, specular tint rgb] (fewer than 15
    columns: zeros and reflectance 0.5; 18: the tint slots 64:67); cuv
    (..., 3, 2) corner UVs with tex_rect (..., 4) the base-colour atlas
    rect; tangents (..., 3) with nm_rect (..., 4); lm_rect, dm_rect,
    em_rect, mr_rect, oc_rect (..., 4) atlas rects. An absent part is
    zeros (see the module docstring for the slots)."""
    lead = cc.shape[:-2]
    t = 1
    for d in lead:
        t *= int(d)
    x, y, w = cc[..., 0], cc[..., 1], cc[..., 3]
    z = cc[..., 2]
    vx0, vy0, vx1, vy1 = _viewport(viewport, width, height)
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
    if not build_srec:
        return zrec, valid
    return zrec, _shade_records(
        e, cn, lead, cc.device, materials, cuv, tex_rect, tangents, nm_rect,
        lm_rect, dm_rect, em_rect, mr_rect, oc_rect), valid


def _shade_records(e, cn, lead, dev, materials, cuv, tex_rect, tangents,
                   nm_rect, lm_rect, dm_rect, em_rect, mr_rect, oc_rect):
    """The shade records of pack_planes_h (JAX's `build_srec` branch):
    every q/w plane is sum_i(q_i * e_i) over the lambda_i/w planes e."""
    def zeros(k):
        return torch.zeros(lead + (k,), dtype=torch.float32, device=dev)

    def combo(q):  # q: (..., 3) corner values -> plane sum_i q_i * e_i
        return (q[..., 0:1] * e[..., 0:3] + q[..., 1:2] * e[..., 3:6] +
                q[..., 2:3] * e[..., 6:9])

    if materials is None:
        materials = zeros(14)
    if materials.shape[-1] < 15:      # pad clearcoat / aniso / pom / refl
        pad = zeros(15 - materials.shape[-1])
        pad[..., -1] = 0.5            # absent reflectance: the 4% default
        materials = torch.cat([materials, pad], -1)
    pom_part = torch.cat([dm_rect if dm_rect is not None else zeros(4),
                          materials[..., 13:14]], -1)  # depth map, scale
    if cuv is not None and tex_rect is not None:
        uv_part = torch.cat([combo(cuv[..., 0]), combo(cuv[..., 1]),
                             tex_rect], -1)
    else:
        uv_part = zeros(10)
    if tangents is not None and nm_rect is not None:
        nm_part = torch.cat([tangents, nm_rect], -1)
    else:
        nm_part = zeros(7)
    def rect(r):
        return r if r is not None else zeros(4)

    parts = [combo(torch.ones_like(cn[..., 0])), combo(cn[..., 0]),
             combo(cn[..., 1]), combo(cn[..., 2]), materials[..., :9],
             uv_part, nm_part, rect(lm_rect), materials[..., 9:11],
             materials[..., 11:13], pom_part, rect(em_rect), rect(mr_rect),
             rect(oc_rect), materials[..., 14:15]]  # reflectance: slot 63
    if materials.shape[-1] >= 18:
        parts.append(materials[..., 15:18])        # specular tint 64:67
    return torch.cat(parts, -1)


def _viewport(viewport, width, height):
    """(x0, y0, x1, y1): the full frame's floats, or the rect's four
    entries (0-d tensors when it is a tensor)."""
    if viewport is None:
        return 0.0, 0.0, float(width), float(height)
    return tuple(viewport)


def cluster_screen_aabbs(cc, inst_ok, tri_valid, cs: int, width, height,
                         viewport=None, eps=1e-6):
    """Per-cluster conservative screen AABBs from clip-space corners.

    cc: (T, 3, 4) or (NCL, cs, 3, 4); inst_ok broadcastable to (NCL,);
    tri_valid (T,); viewport as pack_planes_h's. Clusters with a corner at
    w <= eps get the whole viewport rect. Returns (aabb (NCL,4), cl_valid
    (NCL,), zmax (NCL,)) — zmax the nearest reverse-z bound (the
    front-to-back sort key)."""
    if cc.ndim == 4:
        ncl = cc.shape[0]
        cc = cc.reshape(ncl * cs, 3, 4)
        tri_valid = tri_valid.reshape(ncl * cs)
    ncl = cc.shape[0] // cs
    vx0, vy0, vx1, vy1 = _viewport(viewport, width, height)
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
    """The scissor rect [x0, y0, x1, y1) as a (4,) f32 tensor on `device`:
    a (4,) tensor as it is (a camera's viewport, on the device), else each
    slot set in place (a fill, or a device copy of a 0-d tensor): no
    blocking host read a call."""
    if isinstance(scissor, torch.Tensor) and scissor.shape == (4,):
        return scissor.to(device=device, dtype=torch.float32).contiguous()
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


def _pixel_grids(H, W, device):
    px = (torch.arange(W, dtype=torch.float32, device=device) + 0.5)[None, :] \
        .expand(H, W)
    py = (torch.arange(H, dtype=torch.float32, device=device) + 0.5)[:, None] \
        .expand(H, W)
    return px, py


def _unit(v):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, -1, keepdim=True),
                                       min=1e-12))


def sample_atlas(atlas, uv):
    """Bilinear, edge-clamped atlas sample (ref: the texture() call of pbr
    shading; the atlas stands in for the bindless texture array). atlas
    (AH, AW, 4) linear f32; uv (..., 2) in absolute [0, 1] atlas space.
    Returns (..., 4). The texel index is floored before its cast."""
    ah, aw = atlas.shape[0], atlas.shape[1]
    x = uv[..., 0] * aw - 0.5
    y = uv[..., 1] * ah - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0, y0 = x0f.long(), y0f.long()
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0c = torch.clamp(x0, 0, aw - 1)
    x1c = torch.clamp(x0 + 1, 0, aw - 1)
    y0c = torch.clamp(y0, 0, ah - 1)
    y1c = torch.clamp(y0 + 1, 0, ah - 1)
    t00 = atlas[y0c, x0c]
    t01 = atlas[y0c, x1c]
    t10 = atlas[y1c, x0c]
    t11 = atlas[y1c, x1c]
    top = t00 * (1 - fx) + t01 * fx
    bot = t10 * (1 - fx) + t11 * fx
    return top * (1 - fy) + bot * fy


def _resolve(winner, srec, atlas, ray, parallax_layers):
    """resolve_shade's work, also returning the gathered rows and the
    pixel grids and 1/w (resolve_forward's lightmap term reads them)."""
    H, W = winner.shape
    ok = winner >= 0
    rec = srec[torch.clamp(winner, min=0).long()]     # (H, W, SREC)
    px, py = _pixel_grids(H, W, winner.device)
    iw = rec[..., 0] * px + rec[..., 1] * py + rec[..., 2]
    iw = torch.where(torch.abs(iw) > 1e-12, iw, torch.ones_like(iw))
    nx = (rec[..., 3] * px + rec[..., 4] * py + rec[..., 5]) / iw
    ny = (rec[..., 6] * px + rec[..., 7] * py + rec[..., 8]) / iw
    nz = (rec[..., 9] * px + rec[..., 10] * py + rec[..., 11]) / iw
    n = _unit(torch.stack([nx, ny, nz], -1))
    # mat columns: rgba 0:4, emissive 4:7, metallic 7, roughness 8,
    # clearcoat 9:11, raw tangent 11:14, anisotropy strength / rotation
    # 14:16, reflectance 16, specular tint 17:20 (67-wide records)
    parts = [rec[..., 12:21], rec[..., 42:44], rec[..., 31:34],
             rec[..., 44:46], rec[..., 63:64]]
    if srec.shape[-1] >= 67:
        parts.append(rec[..., 64:67])
    mat = torch.cat(parts, -1)
    if atlas is None:
        return n, mat, ok, rec, px, py, iw
    u = (rec[..., 21] * px + rec[..., 22] * py + rec[..., 23]) / iw
    v = (rec[..., 24] * px + rec[..., 25] * py + rec[..., 26]) / iw
    if parallax_layers and ray is not None:
        u, v = _parallax(atlas, rec, n, ok, u, v, px, py, ray,
                         int(parallax_layers))
    # REPEAT wrap inside the sub-rect (glTF's default sampler)
    fu = u - torch.floor(u)
    fv = v - torch.floor(v)

    def channel(lo):
        """(present, texel) of the optional atlas rect at srec slot lo."""
        c0u, c0v = rec[..., lo], rec[..., lo + 1]
        c1u, c1v = rec[..., lo + 2], rec[..., lo + 3]
        return (c1u > c0u) & ok, sample_atlas(atlas, torch.stack(
            [c0u + fu * (c1u - c0u), c0v + fv * (c1v - c0v)], -1))

    textured, texel = channel(27)
    base = torch.where(textured[..., None], mat[..., 0:4] * texel,
                       mat[..., 0:4])
    mat = torch.cat([base, mat[..., 4:]], -1)
    # normal mapping: the tangent-space texel through the per-triangle
    # TBN (ref: pbr_functions.wesl apply_normal_mapping)
    has_nm, ntex = channel(34)
    ntex = ntex[..., :3] * 2.0 - 1.0
    tang = rec[..., 31:34]
    tang = _unit(tang - n * torch.sum(tang * n, -1, keepdim=True))
    bitan = cross(n, tang)
    nmapped = _unit(tang * ntex[..., 0:1] + bitan * ntex[..., 1:2] +
                    n * ntex[..., 2:3])
    n = torch.where(has_nm[..., None], nmapped, n)
    # emissive_texture modulates the emissive factor; the glTF
    # metallic-roughness packing is G = roughness, B = metallic; the
    # occlusion texture's R attenuates the albedo (folded into the
    # diffuse colour, as the reference resolve does)
    has_em, em_tx = channel(51)
    emi = torch.where(has_em[..., None], mat[..., 4:7] * em_tx[..., :3],
                      mat[..., 4:7])
    has_mr, mr_tx = channel(55)
    met = torch.where(has_mr, mat[..., 7] * mr_tx[..., 2], mat[..., 7])
    rgh = torch.where(has_mr, mat[..., 8] * mr_tx[..., 1], mat[..., 8])
    has_oc, oc_tx = channel(59)
    base2 = torch.where(has_oc[..., None], mat[..., 0:3] * oc_tx[..., 0:1],
                        mat[..., 0:3])
    mat = torch.cat([base2, mat[..., 3:4], emi, met[..., None],
                     rgh[..., None], mat[..., 9:]], -1)
    return n, mat, ok, rec, px, py, iw


def _parallax(atlas, rec, n, ok, u, v, px, py, ray, nl):
    """Parallax occlusion (ref: parallax_mapping.wesl parallaxed_uv): the
    view ray marches `nl` depth layers through the depth map (srec 46:50
    rect, 50 scale; a larger texel is deeper), one secant refinement at
    the crossing; returns the shifted (u, v)."""
    d0u, d0v = rec[..., 46], rec[..., 47]
    d1u, d1v = rec[..., 48], rec[..., 49]
    pscale = rec[..., 50]
    has_pom = (d1u > d0u) & (pscale > 0.0) & ok
    vx = -(ray[0, 0] + px * ray[1, 0] + py * ray[2, 0])
    vy = -(ray[0, 1] + px * ray[1, 1] + py * ray[2, 1])
    vz = -(ray[0, 2] + px * ray[1, 2] + py * ray[2, 2])
    inv_vl = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz,
                                     min=1e-12))
    vx, vy, vz = vx * inv_vl, vy * inv_vl, vz * inv_vl
    tg = rec[..., 31:34]
    tg = tg - n * (tg[..., 0:1] * n[..., 0:1] + tg[..., 1:2] * n[..., 1:2] +
                   tg[..., 2:3] * n[..., 2:3])
    tg = _unit(tg)
    bt = cross(n, tg)
    vt = vx * tg[..., 0] + vy * tg[..., 1] + vz * tg[..., 2]
    vb = vx * bt[..., 0] + vy * bt[..., 1] + vz * bt[..., 2]
    vn = torch.clamp(vx * n[..., 0] + vy * n[..., 1] + vz * n[..., 2],
                     min=0.05)
    ou = pscale * vt / vn          # uv shift per unit of map depth
    ov = pscale * vb / vn

    def dsample(uu, vv):
        fu_ = uu - torch.floor(uu)
        fv_ = vv - torch.floor(vv)
        return sample_atlas(atlas, torch.stack(
            [d0u + fu_ * (d1u - d0u), d0v + fv_ * (d1v - d0v)], -1))[..., 0]

    prev_d = torch.zeros_like(u)
    prev_h = dsample(u, v)
    found = prev_h <= 0.0
    best = torch.zeros_like(u)
    for i in range(1, nl + 1):
        d_i = torch.full_like(u, i / nl)
        h_i = dsample(u - d_i * ou, v - d_i * ov)
        below = d_i >= h_i
        newly = below & ~found
        denom = (prev_h - prev_d) - (h_i - d_i)
        tfrac = torch.clamp((prev_h - prev_d) / torch.where(
            torch.abs(denom) > 1e-6, denom, torch.full_like(denom, 1e-6)),
            0.0, 1.0)
        d_hit = prev_d + tfrac * (d_i - prev_d)
        best = torch.where(newly, d_hit, best)
        found = found | below
        prev_d, prev_h = d_i, h_i
    best = torch.where(found, best, torch.ones_like(best))
    return (torch.where(has_pom, u - best * ou, u),
            torch.where(has_pom, v - best * ov, v))


def resolve_shade(winner, srec, atlas=None, ray=None, parallax_layers=0):
    """Per-pixel varyings and material of the visibility buffer's winners
    (ref: the meshlet resolve_material position). winner (H, W) int32
    (-1 = background), srec (T, SREC) from pack_planes_h. One 64-wide row
    gather a pixel. Returns (normal (H, W, 3) unit, mat (H, W, 17, or 20
    with tint), ok (H, W)); mat columns: rgba 0:4, emissive 4:7, metallic
    7, roughness 8, clearcoat 9:11, tangent 11:14, anisotropy 14:16,
    reflectance 16, tint 17:20.

    With `atlas` (AH, AW, 4), perspective-correct UVs sample it, wrapped
    (REPEAT) inside each rect: the base-colour texture modulates rgba, a
    normal map bends the normal through the per-triangle TBN, and the
    emissive, metallic-roughness and occlusion textures modulate their
    factors. parallax_layers > 0 with `ray` (3, 3) (the camera's pixel-ray
    planes: world direction = ray[0] + px * ray[1] + py * ray[2]) first
    shifts the UVs by a parallax-occlusion march through the depth map."""
    n, mat, ok, *_ = _resolve(winner, srec, atlas, ray, parallax_layers)
    return n, mat, ok


def resolve_forward(winner, srec, light_vec, color_planar, atlas=None,
                    ray=None, parallax_layers=0):
    """Forward Lambert directional + ambient shade of the visibility
    buffer's winners (the lighting of resolve_flat, per pixel), composed
    over color_planar (4, H, W) (winner == -1 keeps it). With an atlas, a
    lightmap rect (srec 38:42) adds albedo * lightmap, sampled at the
    mesh UVs before any parallax shift (ref: the lightmap term of pbr
    shading)."""
    n, mat, ok, rec, px, py, iw = _resolve(winner, srec, atlas, ray,
                                           parallax_layers)
    lam = torch.clamp(-(n[..., 0] * light_vec[0] + n[..., 1] * light_vec[1] +
                        n[..., 2] * light_vec[2]), min=0.0)
    rgb = mat[..., 0:3] * (light_vec[6:9] + light_vec[3:6] * lam[..., None]) \
        + mat[..., 4:7]
    if atlas is not None:
        u = (rec[..., 21] * px + rec[..., 22] * py + rec[..., 23]) / iw
        v = (rec[..., 24] * px + rec[..., 25] * py + rec[..., 26]) / iw
        l0u, l0v = rec[..., 38], rec[..., 39]
        l1u, l1v = rec[..., 40], rec[..., 41]
        has_lm = (l1u > l0u) & ok
        fu = u - torch.floor(u)
        fv = v - torch.floor(v)
        lm = sample_atlas(atlas, torch.stack(
            [l0u + fu * (l1u - l0u), l0v + fv * (l1v - l0v)], -1))
        rgb = rgb + torch.where(has_lm[..., None], mat[..., 0:3] * lm[..., :3],
                                torch.zeros_like(rgb))
    out = torch.cat([rgb, mat[..., 3:4]], -1).permute(2, 0, 1)
    return torch.where(ok[None], out, color_planar)


def resolve_gbuf(winner, srec, gbuf, atlas=None, ray=None,
                 parallax_layers=0):
    """G-buffer write from the visibility buffer's winners (ref: the
    deferred prepass, bevy_core_pipeline/src/deferred/). Planes: albedo
    rgba 0:4, normal 4:7, emissive 7:10, metallic 10, roughness 11,
    clearcoat 12, clearcoat roughness 13, anisotropy tangent 14:17 (the
    mesh tangent orthonormalised against the normal, rotated about it by
    the material's anisotropy rotation; ref: anisotropy.wesl), anisotropy
    strength 17, reflectance 18, specular tint 19:22 (with 67-wide
    records); the first gbuf.shape[0] of them are written, winner == -1
    keeps the incoming gbuf."""
    n, mat, ok, *_ = _resolve(winner, srec, atlas, ray, parallax_layers)
    tang = mat[..., 11:14]
    tang = _unit(tang - n * torch.sum(tang * n, -1, keepdim=True))
    rot = mat[..., 15:16]
    trot = tang * torch.cos(rot) + cross(n, tang) * torch.sin(rot)
    gparts = [mat[..., 0:4], n, mat[..., 4:7], mat[..., 7:11], trot,
              mat[..., 14:15], mat[..., 16:17]]            # (H, W, 19)
    if mat.shape[-1] >= 20:
        gparts.append(mat[..., 17:20])                     # tint 19:22
    planes = torch.cat(gparts, -1)[..., :gbuf.shape[0]].permute(2, 0, 1)
    # contiguous (P, H, W), as B3 takes it: torch.where may keep the
    # permuted planes' strides
    return torch.where(ok[None], planes, gbuf).contiguous()
