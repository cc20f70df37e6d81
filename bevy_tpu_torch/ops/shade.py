"""Deferred shading with tile-binned lights (port of
bevy_tpu/ops/shade_pallas.py; ref: the clustered light binning of
`bevy_light/src/cluster/assign.rs` + the per-fragment light loop of
`pbr_lighting.wesl`, shaped as bevy's deferred path).

- `bin_lights`: screen-AABB tile binning of the lights into a per-tile
  record table `(T, F, max_per_tile)`, in PyTorch, static shapes.
- `deferred_shade`: kernel B3 (`csrc/deferred_shade.cu`, replacing
  `_shade_kernel` of the JAX package) on CUDA tensors; its plain PyTorch
  version `_deferred_shade_plain` on CPU tensors.

Per pixel: world position from reverse-z depth and the inverse
view-projection, Cook-Torrance GGX for the directional light (times the
shadow factor) plus ambient, then the tile's light list in order, each
light skipped when its range sphere misses the tile's sub-frustum; sky
pixels take the clear colour. Distance attenuation is the reference's
smooth inverse-square window: saturate(1 - (d²/r²)²)² / (d² + 1).

Light records (F fields, see render/deferred.py): x y z, r g b
(premultiplied by intensity), range, pad | dir xyz, cos_outer,
1/(cos_inner - cos_outer), pad, pad, rect flag | u axis, v axis, half
width, half height. F = 8 (points only), 16 (spots) or 24 (rect lights).
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ops import _cuda

PI = 3.14159265
# G-buffer planes: albedo rgba 0:4, normal 4:7, emissive 7:10, metallic 10,
# roughness 11, clearcoat 12:14, anisotropy tangent + strength 14:18,
# reflectance 18, specular tint 19:22
VARIANTS = ("spot", "rect", "clearcoat", "anisotropy", "reflectance",
            "specular_tint")


def _pad_to(x, m):
    return (x + m - 1) // m * m


def _to_int(x):
    """floor()ed f32 → int32 (bounded first: the values only feed clamps
    and onscreen tests, where ±1e9 and the reference's saturation agree)."""
    return torch.clamp(x, -1e9, 1e9).to(torch.int32)


def bin_lights(center_px, radius_px, active, nty, ntx, tile_h, tile_w,
               pairs_per_light, max_per_tile, records):
    """Tile-bin lights by conservative screen AABB (center ± radius px).
    records (L, F) pre-packed light rows. Returns (table (T, F,
    max_per_tile) f32, tile_counts (T,) int32, stats) with stats
    {light_pair_overflow, light_tile_overflow} int32 scalars: the pairs
    past pair_cap, and the most lists past max_per_tile in any one tile
    (those lights are dropped from that tile's image). Every shape is
    static (pair_cap = L * pairs_per_light + T): no host sync."""
    num_tiles = nty * ntx
    nl = records.shape[0]
    dev = records.device
    x0 = _to_int(torch.floor((center_px[:, 0] - radius_px) / tile_w))
    x1 = _to_int(torch.floor((center_px[:, 0] + radius_px) / tile_w))
    y0 = _to_int(torch.floor((center_px[:, 1] - radius_px) / tile_h))
    y1 = _to_int(torch.floor((center_px[:, 1] + radius_px) / tile_h))
    onscreen = (x1 >= 0) & (x0 < ntx) & (y1 >= 0) & (y0 < nty) & active
    x0, x1 = torch.clamp(x0, 0, ntx - 1), torch.clamp(x1, 0, ntx - 1)
    y0, y1 = torch.clamp(y0, 0, nty - 1), torch.clamp(y1, 0, nty - 1)
    kx, ky = x1 - x0 + 1, y1 - y0 + 1
    counts = torch.where(onscreen, kx * ky, 0)
    pair_cap = nl * pairs_per_light + num_tiles
    ends_l = torch.cumsum(counts, 0, dtype=torch.int32)
    starts_l = ends_l - counts
    total = ends_l[-1]
    pos = torch.arange(pair_cap, dtype=torch.int32, device=dev)
    # owner of each pair slot: scatter-max of the light index at its first
    # slot (a buffer one longer takes the dropped writes), then cummax
    mark_at = torch.where(counts > 0, torch.clamp(starts_l, max=pair_cap),
                          pair_cap).long()
    mark = torch.full((pair_cap + 1,), -1, dtype=torch.int32, device=dev)
    mark.scatter_reduce_(0, mark_at, torch.arange(nl, dtype=torch.int32,
                                                  device=dev), "amax")
    owner = torch.clamp(torch.cummax(mark[:pair_cap], 0).values, 0, nl - 1)
    owner_l = owner.long()
    rank = pos - starts_l[owner_l]
    kxo = torch.clamp(kx, min=1)[owner_l]
    tile_id = (y0[owner_l] + rank // kxo) * ntx + (x0[owner_l] + rank % kxo)
    pvalid = pos < torch.clamp(total, max=pair_cap)
    tile_id = torch.where(pvalid, tile_id, num_tiles).to(torch.int32)
    # sort pairs by tile, stable, carrying the light index along
    sorted_tile, perm = torch.sort(tile_id, stable=True)
    pair_light = owner_l[perm]
    tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_tile, tids, right=False) \
        .to(torch.int32)
    ends = torch.searchsorted(sorted_tile, tids + 1, right=False) \
        .to(torch.int32)
    tile_counts = torch.clamp(ends - starts, max=max_per_tile)
    slot = starts[:, None] + torch.arange(max_per_tile, dtype=torch.int32,
                                          device=dev)[None, :]
    slot = torch.clamp(slot, max=pair_cap - 1).long()
    table = records[pair_light[slot]].permute(0, 2, 1).contiguous()
    stats = {
        "light_pair_overflow": torch.clamp(total - pair_cap, min=0),
        "light_tile_overflow": torch.clamp(
            torch.amax(ends - starts) - max_per_tile, min=0),
    }
    return table, tile_counts, stats


BLOCK = 16               # kernel B3's CTA block: BLOCK x BLOCK pixels
PLANE_MARGIN = 2.0 ** -10  # B3's block side-plane margin, relative


def _side_planes(params, x0, y0, w, h):
    """World-space side planes of the sub-frustum through the screen
    rects [x0, x0 + w) x [y0, y0 + h) (x0, y0 f32 tensors, y0 with the band
    row offset added), through the camera, oriented inward: (..., 4, 3),
    in kernel B3's `sub_frustum` arithmetic."""
    p = params

    def corner_dir(cx, cy):
        nxc = 2.0 * cx / p[25] - 1.0
        nyc = 1.0 - 2.0 * cy / p[26]
        # unproject at z_ndc = 1 (near, reverse-z); direction from camera
        ux = p[0] * nxc + p[1] * nyc + p[2] + p[3]
        uy = p[4] * nxc + p[5] * nyc + p[6] + p[7]
        uz = p[8] * nxc + p[9] * nyc + p[10] + p[11]
        uw = p[12] * nxc + p[13] * nyc + p[14] + p[15]
        inv = 1.0 / torch.where(torch.abs(uw) > 1e-12, uw,
                                torch.full_like(uw, 1e-12))
        return (ux * inv - p[31], uy * inv - p[32], uz * inv - p[33])

    ca = corner_dir(x0, y0)
    cb = corner_dir(x0 + w, y0)
    cc = corner_dir(x0 + w, y0 + h)
    cd = corner_dir(x0, y0 + h)
    ce = corner_dir(x0 + 0.5 * w, y0 + 0.5 * h)

    def side_plane(a, b):
        nx = a[1] * b[2] - a[2] * b[1]
        ny = a[2] * b[0] - a[0] * b[2]
        nz = a[0] * b[1] - a[1] * b[0]
        inv_n = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz,
                                        min=1e-18))
        s = torch.where(nx * ce[0] + ny * ce[1] + nz * ce[2] >= 0.0,
                        inv_n, -inv_n)
        return torch.stack([nx * s, ny * s, nz * s], -1)

    return torch.stack([side_plane(ca, cb), side_plane(cb, cc),
                        side_plane(cc, cd), side_plane(cd, ca)], -2)


def tile_side_planes(params, nty, ntx, tile_h, tile_w):
    """World-space side planes of each bin tile's sub-frustum, through the
    camera, oriented inward: (T, 4, 3). The reference's per-light early
    skip tests a light's centre against them (see light_in_tile)."""
    t = torch.arange(nty * ntx, device=params.device)
    tx0 = ((t % ntx) * tile_w).to(torch.float32)
    ty0 = ((t // ntx) * tile_h).to(torch.float32) + params[34]
    return _side_planes(params, tx0, ty0, tile_w, tile_h)


def light_in_tile(planes, rec, params):
    """(T,) bool: the light of record rows rec (T, F) is not outside any
    side plane of its tile by more than its range (exact-conservative:
    outside means zero attenuation on every pixel of the tile)."""
    lc = (rec[:, 0] - params[31], rec[:, 1] - params[32],
          rec[:, 2] - params[33])
    rng = rec[:, 6]
    inside = None
    for k in range(4):
        pl = planes[:, k]
        d = pl[:, 0] * lc[0] + pl[:, 1] * lc[1] + pl[:, 2] * lc[2] > -rng
        inside = d if inside is None else inside & d
    return inside


def _to_tiles(img, tile_h, tile_w, value=0.0):
    """(H, W) → (T, tile_h, tile_w), padded with `value`, tiles row-major."""
    H, W = img.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    q = torch.nn.functional.pad(img, (0, ntx * tile_w - W,
                                      0, nty * tile_h - H), value=value)
    return q.reshape(nty, tile_h, ntx, tile_w).permute(0, 2, 1, 3) \
        .reshape(nty * ntx, tile_h, tile_w)


def tile_world_positions(depth, params, *, tile_h=32, tile_w=128):
    """(dep, wx, wy, wz), each (T, tile_h, tile_w): every pixel's depth
    and its world position unprojected from reverse-z depth through the
    inverse view-projection (params as deferred_shade's, the band row
    offset params[34] included), in kernel B3's arithmetic. Pixels past
    the frame hold depth 0 (sky)."""
    H, W = depth.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    dev = depth.device
    p = params
    ti = torch.arange(nty * ntx, device=dev)
    tx0 = ((ti % ntx) * tile_w).to(torch.float32)[:, None, None]
    ty0 = ((ti // ntx) * tile_h).to(torch.float32)[:, None, None]
    px = torch.arange(tile_w, device=dev).to(torch.float32)[None, None, :] \
        + tx0 + 0.5
    py = torch.arange(tile_h, device=dev).to(torch.float32)[None, :, None] \
        + ty0 + 0.5
    py = py + p[34]
    dep = _to_tiles(depth, tile_h, tile_w)
    ndx = 2.0 * px / p[25] - 1.0
    ndy = 1.0 - 2.0 * py / p[26]
    wx = p[0] * ndx + p[1] * ndy + p[2] * dep + p[3]
    wy = p[4] * ndx + p[5] * ndy + p[6] * dep + p[7]
    wz = p[8] * ndx + p[9] * ndy + p[10] * dep + p[11]
    ww = p[12] * ndx + p[13] * ndy + p[14] * dep + p[15]
    inv_ww = 1.0 / torch.where(torch.abs(ww) > 1e-9, ww,
                               torch.ones_like(ww))
    return dep, wx * inv_ww, wy * inv_ww, wz * inv_ww


def light_in_block(depth, light_table, tile_counts, params, *, tile_h=32,
                   tile_w=128, rect=False):
    """(T, tile_h // 16, tile_w // 16, S) bool, S = the longest list: the
    listed lights each 16x16 block of kernel B3 walks, in plain PyTorch
    and the kernel's arithmetic (for tests and measurement; the plain
    version walks the reference's tile lists).

    A block with no geometry pixel walks nothing. Otherwise a listed
    light is kept unless (rect lights: always kept)
    - it fails the reference's tile test (light_in_tile), or
    - it lies outside one of the block's own sub-frustum side planes by
      more than range * (1 + PLANE_MARGIN) + PLANE_MARGIN * |light - eye|_1,
      or
    - its range sphere misses the AABB of the block's geometry world
      positions: the gap to the box, squared and summed in the body's
      order, over max(range², 1e-9) is >= 1. Rounding is monotone, so
      then every geometry pixel of the block has q >= 1 and win == 0."""
    dep, wx, wy, wz = tile_world_positions(depth, params, tile_h=tile_h,
                                           tile_w=tile_w)
    nt = dep.shape[0]
    ntx = _pad_to(depth.shape[1], tile_w) // tile_w
    nby, nbx = tile_h // BLOCK, tile_w // BLOCK
    dev = depth.device
    counts = torch.clamp(tile_counts, max=light_table.shape[2])
    ns = int(counts.max()) if nt else 0
    geom = (dep > 0.0).reshape(nt, nby, BLOCK, nbx, BLOCK)

    def blocks(v, fill, op):
        v = torch.where(geom, v.reshape(geom.shape), fill)
        return op(op(v, 4).values, 2).values          # (T, nby, nbx)

    lo = [blocks(v, torch.inf, torch.min) for v in (wx, wy, wz)]
    hi = [blocks(v, -torch.inf, torch.max) for v in (wx, wy, wz)]
    has_geom = geom.any(4).any(2)
    rec = light_table[:, :, :ns]                           # (T, F, S)
    keep = (torch.arange(ns, device=dev)[None, :] < counts[:, None])
    keep = (keep[:, None, None, :] & has_geom[..., None]) \
        .expand(nt, nby, nbx, ns).clone()
    if rect or ns == 0:
        return keep
    nty = nt // ntx
    keep &= torch.stack([light_in_tile(tile_side_planes(params, nty, ntx,
                                                        tile_h, tile_w),
                                       rec[:, :, s], params)
                         for s in range(ns)], 1)[:, None, None, :]
    t = torch.arange(nt, device=dev)[:, None, None]
    bx0 = ((t % ntx) * tile_w + torch.arange(nbx, device=dev) * BLOCK)
    by0 = ((t // ntx) * tile_h
           + torch.arange(nby, device=dev)[:, None] * BLOCK)
    bx0, by0 = torch.broadcast_tensors(bx0, by0)
    planes = _side_planes(params, bx0.to(torch.float32),
                          by0.to(torch.float32) + params[34], BLOCK,
                          BLOCK)                           # (T, nby, nbx, 4, 3)
    l0, l1, l2, rng = (rec[:, k][:, None, None, :] for k in (0, 1, 2, 6))
    lcx, lcy, lcz = l0 - params[31], l1 - params[32], l2 - params[33]
    margin = PLANE_MARGIN * (rng + torch.abs(lcx) + torch.abs(lcy)
                             + torch.abs(lcz))
    for k in range(4):
        pl = planes[..., k, :, None]
        keep &= pl[..., 0, :] * lcx + pl[..., 1, :] * lcy + \
            pl[..., 2, :] * lcz > -(rng + margin)

    def gap(c, lo, hi):
        lo, hi = lo[..., None], hi[..., None]
        return torch.where(c > hi, c - hi,
                           torch.where(c < lo, c - lo, torch.zeros_like(c)))

    gx, gy, gz = gap(l0, lo[0], hi[0]), gap(l1, lo[1], hi[1]), \
        gap(l2, lo[2], hi[2])
    rng2 = torch.clamp(rng * rng, min=1e-9)
    keep &= ~((gx * gx + gy * gy + gz * gz) / rng2 >= 1.0)
    return keep


def light_win(rec, wx, wy, wz, rect=False):
    """win (T, th, tw): the range window of each tile's light record rows
    rec (T, F) at the tiles' world positions (tile_world_positions), in
    the body of _deferred_shade_plain's arithmetic (rect: from the closest
    point of the rect). A pair with win == 0 adds +0.0: the pairs with
    win > 0 are the ones B3's cull must keep (for tests and
    measurement)."""
    def d(k):
        return rec[:, k][:, None, None]

    dx, dy, dz = d(0) - wx, d(1) - wy, d(2) - wz
    if rect:
        qu = torch.clamp(-(dx * d(16) + dy * d(17) + dz * d(18)), -d(22),
                         d(22))
        qv = torch.clamp(-(dx * d(19) + dy * d(20) + dz * d(21)), -d(23),
                         d(23))
        dx = dx + qu * d(16) + qv * d(19)
        dy = dy + qu * d(17) + qv * d(20)
        dz = dz + qu * d(18) + qv * d(21)
    q = (dx * dx + dy * dy + dz * dz) / torch.clamp(d(6) * d(6), min=1e-9)
    return torch.clamp(1.0 - q * q, 0.0, 1.0)


def _deferred_shade_plain(gbuffer, depth, light_table, tile_counts, params,
                          shadow=None, *, tile_h=32, tile_w=128, spot=True,
                          rect=False, clearcoat=True, anisotropy=False,
                          reflectance=False, specular_tint=False):
    """Plain PyTorch version of B3: the reference's per-tile program,
    vectorized over every pixel of every tile, one Python step per light
    slot (slot < max(tile_counts); one host sync to read it). Expressions
    keep the reference's association order; (1-loh)^5 is x2=x*x, x4=x2*x2,
    x4*x as JAX's integer_pow makes it."""
    _, H, W = gbuffer.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    nt = nty * ntx
    p = params

    def to_tiles(img, value=0.0):
        return _to_tiles(img, tile_h, tile_w, value)

    def g(k):
        return to_tiles(gbuffer[k])

    dep, wx, wy, wz = tile_world_positions(depth, params, tile_h=tile_h,
                                           tile_w=tile_w)
    geom = dep > 0.0

    ar, ag, ab, aa = g(0), g(1), g(2), g(3)
    nx, ny, nz = g(4), g(5), g(6)
    er, eg, eb = g(7), g(8), g(9)
    met = g(10)
    rough = torch.clamp(g(11), 0.045, 1.0)
    if clearcoat:
        cc = g(12)
        ccr = torch.clamp(g(13), 0.045, 1.0)
        cc_a2 = (ccr * ccr) * (ccr * ccr)
    if anisotropy:
        tx, ty, tz = g(14), g(15), g(16)
        aniso = g(17)
        tlen2 = tx * tx + ty * ty + tz * tz
        fy_ = torch.where(torch.abs(ny) < 0.9, 1.0, 0.0)
        fx_ = 1.0 - fy_
        use_fb = tlen2 < 0.25
        tx = torch.where(use_fb, fy_ * nz, tx)
        ty = torch.where(use_fb, -fx_ * nz, ty)
        tz = torch.where(use_fb, fx_ * ny - fy_ * nx, tz)
        inv_tl = torch.rsqrt(torch.clamp(tx * tx + ty * ty + tz * tz,
                                         min=1e-12))
        tx, ty, tz = tx * inv_tl, ty * inv_tl, tz * inv_tl
        aniso = torch.where(use_fb, 0.0, aniso)

    vx, vy, vz = p[31] - wx, p[32] - wy, p[33] - wz
    inv_vlen = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz,
                                       min=1e-9))
    vx, vy, vz = vx * inv_vlen, vy * inv_vlen, vz * inv_vlen
    nov = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-4)
    alpha = rough * rough
    a2 = alpha * alpha
    if anisotropy:
        bx_ = ny * tz - nz * ty
        by_ = nz * tx - nx * tz
        bz_ = nx * ty - ny * tx
        at = torch.clamp(alpha * (1.0 + aniso), min=1e-3)
        ab_r = torch.clamp(alpha * (1.0 - aniso), min=1e-3)
        tov = tx * vx + ty * vy + tz * vz
        bov = bx_ * vx + by_ * vy + bz_ * vz
        lv_a, lv_b = at * tov, ab_r * bov
        lam_v_c = torch.sqrt(torch.clamp(lv_a * lv_a + lv_b * lv_b +
                                         nov * nov, min=1e-12))
    dr = ar * (1.0 - met)
    dg = ag * (1.0 - met)
    db = ab * (1.0 - met)
    base_f0 = 0.16 * g(18) * g(18) if reflectance else 0.04
    if specular_tint:
        f0r = base_f0 * g(19) * (1.0 - met) + ar * met
        f0g = base_f0 * g(20) * (1.0 - met) + ag * met
        f0b = base_f0 * g(21) * (1.0 - met) + ab * met
    else:
        f0r = base_f0 * (1.0 - met) + ar * met
        f0g = base_f0 * (1.0 - met) + ag * met
        f0b = base_f0 * (1.0 - met) + ab * met

    def shade_light(lx, ly, lz, cr, cg, cb):
        nol = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
        hx, hy, hz = lx + vx, ly + vy, lz + vz
        inv_h = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                        min=1e-9))
        noh = torch.clamp((nx * hx + ny * hy + nz * hz) * inv_h, min=0.0)
        loh = torch.clamp((lx * hx + ly * hy + lz * hz) * inv_h, min=0.0)
        if anisotropy:
            toh = (tx * hx + ty * hy + tz * hz) * inv_h
            boh = (bx_ * hx + by_ * hy + bz_ * hz) * inv_h
            a2an = at * ab_r
            qt, qb = toh / at, boh / ab_r
            dsum = qt * qt + qb * qb + noh * noh
            dist = 1.0 / torch.clamp(PI * a2an * dsum * dsum, min=1e-9)
            tol = tx * lx + ty * ly + tz * lz
            bol = bx_ * lx + by_ * ly + bz_ * lz
            ll_a, ll_b = at * tol, ab_r * bol
            lam_l = torch.sqrt(torch.clamp(ll_a * ll_a + ll_b * ll_b +
                                           nol * nol, min=1e-12))
            vis = 0.5 / torch.clamp(nol * lam_v_c + nov * lam_l, min=1e-4)
        else:
            den = noh * noh * (a2 - 1.0) + 1.0
            dist = a2 / torch.clamp(PI * den * den, min=1e-9)
            vis = 0.5 / torch.clamp(
                nol * (nov * (1.0 - alpha) + alpha) +
                nov * (nol * (1.0 - alpha) + alpha), min=1e-4)
        x = 1.0 - loh
        x2 = x * x
        fres = x2 * x2 * x
        dv = dist * vis
        sr = dv * (f0r + (1.0 - f0r) * fres)
        sg = dv * (f0g + (1.0 - f0g) * fres)
        sb = dv * (f0b + (1.0 - f0b) * fres)
        if not clearcoat:
            return ((dr + sr) * cr * nol, (dg + sg) * cg * nol,
                    (db + sb) * cb * nol)
        ccden = noh * noh * (cc_a2 - 1.0) + 1.0
        ccdist = cc_a2 / torch.clamp(PI * ccden * ccden, min=1e-9)
        ccvis = 0.25 / torch.clamp(loh * loh, min=1e-4)
        fc = (0.04 + 0.96 * fres) * cc
        coat = ccdist * ccvis * fc
        keep = 1.0 - fc
        return (((dr + sr) * keep + coat) * cr * nol,
                ((dg + sg) * keep + coat) * cg * nol,
                ((db + sb) * keep + coat) * cb * nol)

    lit = to_tiles(shadow, 1.0) if shadow is not None else 1.0
    drr, drg, drb = shade_light(-p[16], -p[17], -p[18], p[19], p[20], p[21])
    acc_r = ar * p[22] + drr * lit
    acc_g = ag * p[23] + drg * lit
    acc_b = ab * p[24] + drb * lit

    planes = tile_side_planes(params, nty, ntx, tile_h, tile_w)
    tile_geom = torch.amax(dep.reshape(nt, -1), 1) > 0.0
    counts = torch.clamp(tile_counts, max=light_table.shape[2])
    nslots = int(counts.max()) if nt else 0
    for s in range(nslots):
        rec = light_table[:, :, s]                       # (T, F)
        on = (s < counts) & tile_geom
        if not rect:
            on = on & light_in_tile(planes, rec, params)

        def d(k):
            return rec[:, k][:, None, None]

        dx, dy, dz = d(0) - wx, d(1) - wy, d(2) - wz
        if rect:
            qu = torch.clamp(-(dx * d(16) + dy * d(17) + dz * d(18)),
                             -d(22), d(22))
            qv = torch.clamp(-(dx * d(19) + dy * d(20) + dz * d(21)),
                             -d(23), d(23))
            side = torch.where((d(15) > 0.5) &
                               (dx * d(8) + dy * d(9) + dz * d(10) > 0.0),
                               0.0, 1.0)
            dx = dx + qu * d(16) + qv * d(19)
            dy = dy + qu * d(17) + qv * d(20)
            dz = dz + qu * d(18) + qv * d(21)
        d2 = dx * dx + dy * dy + dz * dz
        inv_d = torch.rsqrt(torch.clamp(d2, min=1e-9))
        rng2 = torch.clamp(d(6) * d(6), min=1e-9)
        q = d2 / rng2
        win = torch.clamp(1.0 - q * q, 0.0, 1.0)
        atten = win * win / (d2 + 1.0)
        if spot:
            cos_to = -(dx * inv_d * d(8) + dy * inv_d * d(9) +
                       dz * inv_d * d(10))
            cone = torch.clamp((cos_to - d(11)) * d(12), 0.0, 1.0)
            atten = atten * cone * cone
        if rect:
            atten = atten * side
        pr, pg, pb = shade_light(dx * inv_d, dy * inv_d, dz * inv_d,
                                 d(3) * atten, d(4) * atten, d(5) * atten)
        m = on[:, None, None]
        acc_r = torch.where(m, acc_r + pr, acc_r)
        acc_g = torch.where(m, acc_g + pg, acc_g)
        acc_b = torch.where(m, acc_b + pb, acc_b)

    out = torch.stack([torch.where(geom, acc_r + er, p[27]),
                       torch.where(geom, acc_g + eg, p[28]),
                       torch.where(geom, acc_b + eb, p[29]),
                       torch.where(geom, aa, p[30])])
    return out.reshape(4, nty, ntx, tile_h, tile_w).permute(0, 1, 3, 2, 4) \
        .reshape(4, nty * tile_h, ntx * tile_w)[:, :H, :W]


def deferred_shade(gbuffer, depth, light_table, tile_counts, params,
                   shadow=None, *, tile_h=32, tile_w=128, spot=True,
                   rect=False, clearcoat=True, anisotropy=False,
                   reflectance=False, specular_tint=False):
    """Deferred shade (kernel B3; replaces the JAX package's
    `deferred_shade` → `_shade_kernel`).

    gbuffer (19|22, H, W) f32, depth (H, W) f32 reverse-z; light_table
    (T, F, mpt) f32 and tile_counts (T,) int32 from bin_lights; params
    (40,) f32: [0:16 inv_vp row-major, 16:19 light dir, 19:22 light rgb,
    22:25 ambient rgb, 25 width, 26 height, 27:31 clear rgba, 31:34 camera
    position, 34 row offset]; shadow (H, W) lit factor of the directional
    light or None (fully lit). The six flags pick the static variant.
    Returns color (4, H, W) f32.

    CPU tensors run the plain PyTorch version; CUDA tensors launch
    `csrc/deferred_shade.cu` (one thread per pixel, 16x16 CTAs inside the
    tile_h x tile_w bin tiles)."""
    flags = dict(spot=spot, rect=rect, clearcoat=clearcoat,
                 anisotropy=anisotropy, reflectance=reflectance,
                 specular_tint=specular_tint)
    dev = _cuda.call_device(gbuffer, depth, light_table, tile_counts, params,
                            shadow)
    if dev.type == "cpu":
        return _deferred_shade_plain(gbuffer, depth, light_table,
                                     tile_counts, params, shadow,
                                     tile_h=tile_h, tile_w=tile_w, **flags)
    if gbuffer.dim() != 3 or light_table.dim() != 3:
        raise ValueError("deferred_shade: gbuffer (P, H, W) and light_table "
                         "(T, F, mpt) expected")
    nplanes, H, W = gbuffer.shape
    nty, ntx = _pad_to(H, tile_h) // tile_h, _pad_to(W, tile_w) // tile_w
    nt, nf, mpt = light_table.shape
    if nt != nty * ntx:
        raise ValueError(f"light_table has {nt} tiles, the frame {nty * ntx}")
    need_f = 24 if rect else (16 if spot else 8)
    need_p = 22 if specular_tint else 19
    if nf < need_f or nplanes < need_p:
        raise ValueError(f"deferred_shade: {flags} needs >= {need_f} light "
                         f"fields and >= {need_p} planes, got {nf}, "
                         f"{nplanes}")
    if tile_h % 16 or tile_w % 16:
        raise ValueError("deferred_shade: tile_h and tile_w must be "
                         "multiples of 16")
    _cuda.require(gbuffer, "gbuffer", torch.float32)
    _cuda.require(depth, "depth", torch.float32, (H, W))
    _cuda.require(light_table, "light_table", torch.float32)
    _cuda.require(tile_counts, "tile_counts", torch.int32, (nt,))
    _cuda.require(params, "params", torch.float32, (40,))
    if shadow is not None:
        _cuda.require(shadow, "shadow", torch.float32, (H, W))
    bits = sum(1 << i for i, name in enumerate(VARIANTS) if flags[name])
    out = torch.empty((4, H, W), dtype=torch.float32, device=depth.device)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.bt_deferred_shade(
            gbuffer.data_ptr(), nplanes, depth.data_ptr(),
            0 if shadow is None else shadow.data_ptr(),
            light_table.data_ptr(), nf, mpt, tile_counts.data_ptr(),
            params.data_ptr(), H, W, tile_h, tile_w, ntx, bits,
            out.data_ptr(), _cuda.stream_ptr(depth))
    _cuda.check(err, "bt_deferred_shade")
    deferred_shade.launches += 1
    return out


deferred_shade.launches = 0
