"""Window-splat rasterizer (port of bevy_tpu/ops/raster3d_splat.py; ref:
bevy's GPU-driven meshlet raster, `bevy_pbr/src/meshlet/`).

1. `build_windows`: each visible cluster emits one window per overlapped
   (win_h-row × 128-column) framebuffer block; single-band clusters get one
   window at their own y0. Exorbitant clusters go to the streaming-tile
   fallback (raster3d_visbuf.raster_visbuf).
2. `build_rec_rows` / `build_quad_rec_rows`: valid-first per-cluster
   record rows (3-edge triangles, stride 13, or 4-edge coplanar quads,
   stride 16).
3. `fused_eval_composite`: evaluates every window's records and merges
   depth + winner id into the framebuffer (kernel B1,
   `csrc/splat_raster.cu`, replacing `_fused_kernel`). The kernel walks
   only the 8 x 4-pixel tiles of a window where a slot can read inside;
   `window_px_kept` makes the same decisions in plain PyTorch.

The two-pass path of the multi-device raster (parallel/raster.py) splits
step 3: `compact_cluster_tris` sorts each cluster's triangles valid-first,
`eval_windows` (plain PyTorch, as the JAX package's is XLA) evaluates every
window into packed values — reverse-z depth with the low ID_BITS mantissa
bits replaced by the triangle-in-cluster index — and `composite_windows`
merges them in window order (kernel B6, `csrc/window_composite.cu`,
replacing `_composite_kernel`). The depth this path writes carries the
packed z.

Merge order. The TPU ran windows one after another, so each window's
read-modify-write saw all earlier ones. Under the strict `z > cur` test,
that sequential result at a pixel is exactly the lexicographic maximum of
(z, -seq) over the writes that pass the edge test, seq being the write's
position in (window, slot) order, with the incoming framebuffer value
winning all ties. Both versions below compute that maximum as a 64-bit
key `order(z) << 32 | (0xFFFFFFFE - seq)` (the incoming value carries low
bits 0xFFFFFFFF) with a max-reduction, then decode seq back to the
record's id — so windows may run in any order.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ops import _cuda
from bevy_tpu_torch.ops.binning import expand_runs
from bevy_tpu_torch.ops.raster3d_visbuf import ZREC, _scissor_vec

WIN_W = 128          # window width = one 128-px framebuffer column block
REC_FIELDS = 13      # triangle record: 3 edge planes (9) + z plane (3) + id
ID_BITS = 4          # low mantissa bits of packed z = tri-in-cluster id
ID_MASK = (1 << ID_BITS) - 1
_LOW = 0xFFFFFFFF    # low key bits of the incoming framebuffer value
_HI = 1 << 32        # key = order(z) * _HI | low bits


def build_rec_rows(zrec, cs: int, ntri: int):
    """Valid-first record packing, gather-free: slot s of a cluster's row
    is its s-th valid triangle (masked sum over the cs axis). Empty slots
    are all-zero records, which `z > depth` rejects. Returns (ncl, rrows,
    128) float32 rows of stride REC_FIELDS. zrec: (ncl*cs, ZREC) or
    (ncl, cs, ZREC)."""
    ncl = zrec.shape[0] if zrec.ndim == 3 else zrec.shape[0] // cs
    r = zrec.reshape(ncl, cs, -1)[:, :, :REC_FIELDS]
    valid = r[:, :, 12] >= 0.0                     # tri_id < 0 = culled
    vr = torch.where(valid, torch.cumsum(valid.to(torch.int32), 1) - 1, -1)
    slots = [torch.sum(r * (vr == s).to(r.dtype)[:, :, None], 1)
             for s in range(min(ntri, cs))]
    return _pad_rows(torch.cat(slots, 1))


def _pad_rows(rows):
    """(ncl, rowlen) → (ncl, rrows, 128), zero-padded."""
    rowlen = rows.shape[1]
    rrows = (rowlen + WIN_W - 1) // WIN_W
    rows = torch.nn.functional.pad(rows, (0, rrows * WIN_W - rowlen))
    return rows.reshape(rows.shape[0], rrows, WIN_W)


def coplanar_quad_pairs(positions, triangles):
    """Host-side static pairing of coplanar adjacent triangles into
    convex quads (a planar convex quad rasterizes with 4 edge planes + 1 z
    plane instead of two triangles' 6 + 2).

    Returns a list of entries covering every non-degenerate triangle:
    ("pair", iA, aU, aV, iB, bU, bV) — iA/iB local tri indices, aU/aV
    the A-local corner indices of the two SHARED verts (their lambda
    planes vanish on A's two boundary edges), bU/bV likewise for B —
    or ("tri", i) for unpaired triangles."""
    import numpy as np
    tris = np.asarray(triangles, np.int64)
    pos = np.asarray(positions, np.float64)
    tc = len(tris)
    n = np.cross(pos[tris[:, 1]] - pos[tris[:, 0]],
                 pos[tris[:, 2]] - pos[tris[:, 0]])
    nl = np.linalg.norm(n, axis=1)
    scale = float(np.max(np.abs(pos)) + 1e-12)
    nn = n / np.maximum(nl, 1e-20)[:, None]
    edge_map = {}
    for i in range(tc):
        if nl[i] < 1e-12:
            continue                       # degenerate (padding) tri
        for k in range(3):
            a, b = int(tris[i, k]), int(tris[i, (k + 1) % 3])
            edge_map.setdefault((min(a, b), max(a, b)), []).append((i, k))
    used = np.zeros(tc, bool)
    out = []
    for i in range(tc):
        if used[i] or nl[i] < 1e-12:
            continue
        used[i] = True
        match = None
        for k in range(3):
            a = int(tris[i, k])
            b = int(tris[i, (k + 1) % 3])
            for (j, kj) in edge_map.get((min(a, b), max(a, b)), ()):
                if j == i or used[j]:
                    continue
                if float(np.dot(nn[i], nn[j])) < 1.0 - 1e-5:
                    continue               # not coplanar / opposite facing
                oj = int(tris[j, (kj + 2) % 3])
                if abs(float(np.dot(pos[oj] - pos[tris[i, 0]], nn[i]))) \
                        > 1e-5 * scale:
                    continue               # parallel but offset planes
                # convexity of the union polygon oi -> a -> oj -> b
                oi = int(tris[i, (k + 2) % 3])
                quad = pos[[oi, a, oj, b]]
                ed = np.roll(quad, -1, 0) - quad
                cr = np.cross(ed, np.roll(ed, -1, 0)) @ nn[i]
                if not (np.all(cr > 1e-12 * scale * scale) or
                        np.all(cr < -1e-12 * scale * scale)):
                    continue               # non-convex quad
                match = (j, k, kj)
                break
            if match:
                break
        if match is None:
            out.append(("tri", i))
            continue
        j, k, kj = match
        used[j] = True
        a = int(tris[i, k])
        b = int(tris[i, (k + 1) % 3])
        bl = [int(x) for x in tris[j]]
        out.append(("pair", i, k, (k + 1) % 3, j,
                    bl.index(a), bl.index(b)))
    return out


def build_quad_rec_rows(zrec, cs: int, entries, nquad: int):
    """Quad records (nedge=4, stride 16) assembled from the per-triangle
    zrec by static slices: [edgeA_u, edgeA_v, edgeB_u, edgeB_v, z, id] —
    the lambda planes of the shared corners, z and id from triangle A. A
    quad is valid only when both triangles are; unpaired ("tri", i)
    entries repeat an edge plane as the 4th. Returns (ncl, rrows, 128)
    rows, valid-first like build_rec_rows."""
    ncl = zrec.shape[0] if zrec.ndim == 3 else zrec.shape[0] // cs
    r = zrec.reshape(ncl, cs, -1)
    qs, oks = [], []
    for e in entries:
        if e[0] == "pair":
            _, iA, aU, aV, iB, bU, bV = e
            qs.append(torch.cat([
                r[:, iA, 3 * aU:3 * aU + 3], r[:, iA, 3 * aV:3 * aV + 3],
                r[:, iB, 3 * bU:3 * bU + 3], r[:, iB, 3 * bV:3 * bV + 3],
                r[:, iA, 9:13]], 1))
            oks.append((r[:, iA, 12] >= 0.0) & (r[:, iB, 12] >= 0.0))
        else:
            i = e[1]
            qs.append(torch.cat([r[:, i, 0:9], r[:, i, 0:3], r[:, i, 9:13]], 1))
            oks.append(r[:, i, 12] >= 0.0)
    q = torch.stack(qs, 1)                         # (ncl, nq, 16)
    vq = torch.stack(oks, 1)                       # (ncl, nq)
    vr = torch.where(vq, torch.cumsum(vq.to(torch.int32), 1) - 1, -1)
    slots = [torch.sum(q * (vr == s).to(q.dtype)[:, :, None], 1)
             for s in range(min(nquad, len(entries)))]
    return _pad_rows(torch.cat(slots, 1))


def build_windows(aabb, cl_valid, *, win_h, width, height, budget,
                  max_blocks=32):
    """Decompose visible cluster AABBs into per-block windows.

    Returns dict with owner (B,) int32, meta (B,) int32 packed
    col*2048+y0, wvalid (B,) prefix bools, fallback (NCL,) bool (clusters
    for the streaming kernel), overflow () int32 dropped windows."""
    ncols = (width + WIN_W - 1) // WIN_W
    nbands = (height + win_h - 1) // win_h
    x0, y0, x1, y1 = aabb[:, 0], aabb[:, 1], aabb[:, 2], aabb[:, 3]
    onscreen = (x1 > 0) & (x0 < width) & (y1 > 0) & (y0 < height) & \
        (x1 > x0) & (y1 > y0) & cl_valid

    def cell(v, size, hi):
        return torch.clamp(torch.floor(v / size).to(torch.int32), 0, hi)

    c0 = cell(x0, WIN_W, ncols - 1)
    c1 = cell(x1 - 1e-3, WIN_W, ncols - 1)
    b0 = cell(y0, win_h, nbands - 1)
    b1 = cell(y1 - 1e-3, win_h, nbands - 1)
    nbx = c1 - c0 + 1
    single_band = y1 - y0 <= win_h - 1.0
    nby = torch.where(single_band, 1, b1 - b0 + 1)
    blocks = nbx * nby
    use = onscreen & (blocks <= max_blocks)
    owner, rank, pvalid, total = expand_runs(torch.where(use, blocks, 0),
                                             budget)
    ymax = max(height - win_h, 0)
    wy0 = torch.clamp(torch.floor(y0).to(torch.int32), 0, ymax)
    crow = torch.stack([c0, torch.clamp(nbx, min=1), b0, wy0,
                        single_band.to(torch.int32)], 1)[owner]   # (B, 5)
    col = torch.clamp(crow[:, 0] + rank % crow[:, 1], 0, ncols - 1)
    band_y = (crow[:, 2] + rank // crow[:, 1]) * win_h
    # single-band clusters: one unaligned window at their own y0
    wy = torch.where(crow[:, 4] > 0, crow[:, 3],
                     torch.clamp(band_y, 0, ymax))
    return {
        "owner": torch.where(pvalid, owner, 0).to(torch.int32),
        "meta": torch.where(pvalid, col * 2048 + wy, 0).to(torch.int32),
        "wvalid": pvalid,
        "fallback": onscreen & (blocks > max_blocks),
        "overflow": torch.clamp(total - budget, min=0),
    }


def compact_cluster_tris(zrec, cs: int):
    """Sort each cluster's triangles valid-first (invalid = backface or
    padding, marked by tri_id < 0 in slot 12), stably, so an `eval_tris`
    cap keeps the valid ones. Returns (zrec_sorted (T, ZREC), the most
    valid triangles in a cluster, a 0-dim tensor)."""
    t = zrec.shape[0]
    r = zrec.reshape(t // cs, cs, ZREC)
    invalid = r[:, :, 12] < 0
    order = torch.argsort(invalid.to(torch.int32), dim=1, stable=True)
    r = torch.take_along_dim(r, order[:, :, None], dim=1)
    return r.reshape(t, ZREC), torch.amax(torch.sum(~invalid, 1))


def _eval_block(rec, owner, meta, *, win_h, cs, id_base):
    """Packed values of one block of windows. rec (b, ntri, ZREC), owner
    and meta (b,). Each slot: inside where the largest edge and -z are
    below 0 (zeroed planes of invalid triangles give z == 0 and fail);
    the cluster-local id (slot 12 holds the global id) replaces the low
    ID_BITS of z; the block keeps the maximum. Returns (b, win_h, 128)."""
    dev = rec.device
    lane = torch.arange(WIN_W, dtype=torch.int32, device=dev)
    row = torch.arange(win_h, dtype=torch.int32, device=dev)
    px = ((meta // 2048)[:, None, None] * WIN_W + lane[None, None, :]
          ).to(torch.float32) + 0.5                       # (b, 1, 128)
    py = ((meta % 2048)[:, None, None] + row[None, :, None]
          ).to(torch.float32) + 0.5                       # (b, win_h, 1)
    acc = torch.zeros((owner.shape[0], win_h, WIN_W), dtype=torch.float32,
                      device=dev)
    for s in range(rec.shape[1]):
        def d(k, _s=s):
            return rec[:, _s, k][:, None, None]
        emax = torch.maximum(torch.maximum(
            d(0) * px + d(1) * py + d(2),
            d(3) * px + d(4) * py + d(5)),
            d(6) * px + d(7) * py + d(8))
        z = d(9) * px + d(10) * py + d(11)
        ok = torch.maximum(emax, -z) < 0
        lid = (rec[:, s, 12].to(torch.int32) - id_base - owner * cs) & ID_MASK
        packed = ((z.view(torch.int32) & ~ID_MASK) | lid[:, None, None]
                  ).view(torch.float32)
        acc = torch.maximum(acc, torch.where(ok, packed, 0.0))
    return acc


def eval_windows(zrec, cs: int, owner, meta, wvalid, *, win_h,
                 eval_tris=None, chunk=4096, id_base=0):
    """Evaluate cluster triangles over their windows (plain PyTorch; the
    JAX package's is XLA, no kernel).

    zrec (T, ZREC), compacted by compact_cluster_tris where `eval_tris`
    caps the slots; owner/meta/wvalid from build_windows; id_base the
    first global triangle id of this zrec. Returns (B, win_h, 128) float32
    packed values: reverse-z depth with the low ID_BITS mantissa bits
    replaced by the triangle-in-cluster index (0 = no hit).

    The JAX package loops over the valid prefix only (a `fori_loop` with a
    trip count read from `wvalid`). Here every window of the budget is
    evaluated, `chunk` at a time, so the frame makes no host read; windows
    past the prefix hold values that composite_windows never reads. The
    cost therefore follows the budget, not the window count."""
    del wvalid                       # the whole budget is evaluated
    ncl = zrec.shape[0] // cs
    ntri = cs if eval_tris is None else min(eval_tris, cs)
    if cs > (1 << ID_BITS):
        raise ValueError(f"cluster size {cs} exceeds the {ID_BITS} packed "
                         f"id bits")
    recs = zrec.reshape(ncl, cs, ZREC)[:, :ntri]
    b = owner.shape[0]
    out = torch.empty((b, win_h, WIN_W), dtype=torch.float32,
                      device=zrec.device)
    for start in range(0, b, chunk):
        o = owner[start:start + chunk]
        out[start:start + chunk] = _eval_block(
            recs[o.long()], o, meta[start:start + chunk], win_h=win_h, cs=cs,
            id_base=id_base)
    return out


# ----------------------------------------------------------------------
# Weighted-blended OIT and the occlusion hi-z (plain PyTorch: the JAX
# package's are XLA, no kernel)

def eval_oit_windows(zrec, frec, cs: int, owner, meta, wvalid, depth, *,
                     win_h, eval_tris=None, chunk=2048):
    """Weighted-blended OIT window evaluation (ref: bevy_core_pipeline's
    OIT, `src/oit/`; McGuire-Bavoil weighted blended transparency, order
    independent). zrec (T, ZREC) packed planes; frec (T, 8) flat lit rgb +
    alpha (slot 3); depth (H, W) the opaque reverse-z buffer: a fragment
    counts only where it is nearer. Returns (B, 5, win_h, 128): per window
    [w*r, w*g, w*b, w, revealage], every window of the budget evaluated
    (wvalid is accumulate_oit's to read)."""
    del wvalid
    ncl = zrec.shape[0] // cs
    ntri = cs if eval_tris is None else min(eval_tris, cs)
    recs = zrec.reshape(ncl, cs, ZREC)[:, :ntri]
    cols = frec.reshape(ncl, cs, 8)[:, :ntri, :4]
    h, w = depth.shape
    ncols = (w + WIN_W - 1) // WIN_W
    dep_pad = torch.nn.functional.pad(depth, (0, ncols * WIN_W - w, 0, win_h),
                                      value=3.4e38)
    dev = depth.device
    lane = torch.arange(WIN_W, dtype=torch.int32, device=dev)
    row = torch.arange(win_h, dtype=torch.int32, device=dev)
    b = owner.shape[0]
    out = torch.empty((b, 5, win_h, WIN_W), dtype=torch.float32, device=dev)
    for start in range(0, b, chunk):
        o = owner[start:start + chunk].long()
        m = meta[start:start + chunk]
        rec, col4 = recs[o], cols[o]
        colk, wy = m // 2048, m % 2048
        xs = colk[:, None, None] * WIN_W + lane[None, None, :]
        ys = wy[:, None, None] + row[None, :, None]
        px = xs.to(torch.float32) + 0.5                    # (b, 1, 128)
        py = ys.to(torch.float32) + 0.5                    # (b, win_h, 1)
        dep_w = dep_pad[ys.long(), xs.long()]              # (b, win_h, 128)
        acc = torch.zeros((o.shape[0], 4, win_h, WIN_W), dtype=torch.float32,
                          device=dev)
        reveal = torch.ones((o.shape[0], win_h, WIN_W), dtype=torch.float32,
                            device=dev)
        for s in range(ntri):
            def d(k, _s=s):
                return rec[:, _s, k][:, None, None]
            emax = torch.maximum(torch.maximum(
                d(0) * px + d(1) * py + d(2), d(3) * px + d(4) * py + d(5)),
                d(6) * px + d(7) * py + d(8))
            z = d(9) * px + d(10) * py + d(11)
            cover = (torch.maximum(emax, -z) < 0) & (z > dep_w)
            a = col4[:, s, 3][:, None, None] * cover.to(torch.float32)
            wz = a * (0.1 + z * z * 10.0)     # nearer (larger z) counts more
            acc = acc + torch.cat(
                [col4[:, s, 0:3, None, None] * wz[:, None], wz[:, None]], 1)
            reveal = reveal * (1.0 - a)
        out[start:start + chunk] = torch.cat([acc, reveal[:, None]], 1)
    return out


def accumulate_oit(oit, windows, meta, wvalid):
    """Merge OIT windows into the (5, H, W) accumulation buffer: the
    weighted sums add, the revealage multiplies (the JAX package merges
    the valid windows one after another; here one index_add_ and one
    product scatter, so the sums' order differs by rounding). Windows past
    the valid prefix are not read."""
    _, h, w = oit.shape
    ncols = (w + WIN_W - 1) // WIN_W
    wp = ncols * WIN_W
    b, _, win_h, _ = windows.shape
    dev = oit.device
    pad = torch.nn.functional.pad(oit, (0, wp - w, 0, win_h))
    lane = torch.arange(WIN_W, device=dev)
    row = torch.arange(win_h, device=dev)
    colk, y0 = (meta // 2048).long(), (meta % 2048).long()
    idx = (y0[:, None, None] + row[None, :, None]) * wp + \
        colk[:, None, None] * WIN_W + lane[None, None, :]     # (B, win_h, 128)
    idx = torch.where(wvalid[:, None, None], idx,
                      pad.shape[1] * wp)                     # a spare slot
    flat = torch.cat([pad.reshape(5, -1), pad.new_zeros((5, 1))], 1)
    sums = flat[:4].index_add(1, idx.reshape(-1),
                              windows[:, :4].permute(1, 0, 2, 3)
                              .reshape(4, -1))
    rev = flat[4].scatter_reduce(0, idx.reshape(-1),
                                 windows[:, 4].reshape(-1), "prod")
    out = torch.cat([sums, rev[None]], 0)[:, :-1]
    return out.reshape(5, h + win_h, wp)[:, :h, :w]


def oit_blend(color, oit):
    """Composite the OIT accumulation over the opaque colour (ref: the OIT
    resolve pass). color (4, H, W); oit (5, H, W)."""
    reveal = torch.clamp(oit[4], 0.0, 1.0)
    avg = oit[:3] / torch.clamp(oit[3], min=1e-6)[None]
    rgb = avg * (1.0 - reveal)[None] + color[:3] * reveal[None]
    return torch.cat([rgb, color[3:4]], 0)


def coarse_min_depth(depth, cell_h=16, cell_w=64):
    """Min-pool the reverse-z depth to a coarse grid: the hi-z level the
    occlusion test reads (ref: the downsample-depth pass of
    bevy_render/src/occlusion_culling and meshlet's hi-z). Padding is 0."""
    h, w = depth.shape
    hp = (h + cell_h - 1) // cell_h * cell_h
    wp = (w + cell_w - 1) // cell_w * cell_w
    if (hp, wp) != (h, w):
        depth = torch.nn.functional.pad(depth, (0, wp - w, 0, hp - h))
    return depth.reshape(hp // cell_h, cell_h, wp // cell_w, cell_w) \
        .amin((1, 3))


def occlusion_test(aabb, zmax, coarse, cell_h=16, cell_w=64, max_span=4):
    """Conservative per-cluster occlusion: occluded iff every coarse cell
    the screen box touches holds a depth nearer than the cluster's nearest
    bound `zmax`; boxes spanning more than max_span cells on an axis are
    kept. Returns (NCL,) bool."""
    nch, ncw = coarse.shape
    x0, y0, x1, y1 = aabb[:, 0], aabb[:, 1], aabb[:, 2], aabb[:, 3]
    cx0 = torch.floor(x0 / cell_w).to(torch.int32)
    cx1 = torch.floor((x1 - 1e-3) / cell_w).to(torch.int32)
    cy0 = torch.floor(y0 / cell_h).to(torch.int32)
    cy1 = torch.floor((y1 - 1e-3) / cell_h).to(torch.int32)
    spanx, spany = cx1 - cx0 + 1, cy1 - cy0 + 1
    small = (spanx <= max_span) & (spany <= max_span)
    m = torch.full(zmax.shape, 3.4e38, dtype=torch.float32,
                   device=zmax.device)
    for dy in range(max_span):
        for dx in range(max_span):
            cell = coarse[torch.clamp(cy0 + dy, 0, nch - 1).long(),
                          torch.clamp(cx0 + dx, 0, ncw - 1).long()]
            use = (dy < spany) & (dx < spanx)
            m = torch.minimum(m, torch.where(use, cell, 3.4e38))
    return small & (zmax < m)


# ----------------------------------------------------------------------
# B1: fused window evaluate + composite

def order_key(f):
    """float32 → int64 whose signed order is the float order."""
    b = f.view(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF).to(torch.int64)


def _key_float(hi):
    b = hi.to(torch.int32)
    return torch.where(b >= 0, b, b ^ 0x7FFFFFFF).view(torch.float32)


def _fused_plain(depth, winner, rec_rows, owner, meta, wvalid, scissor=None,
                 *, win_h, ntri, nedge, chunk=4096):
    """Plain PyTorch version of B1: per valid window, the first slot
    holding the maximal z that passes the edge test, then a scatter-max of
    the (z, -seq) keys over those windows, then the decode. Only the valid
    windows are walked (an invalid one writes nothing); seq stays the
    window's index in the budget. With a scissor rect only pixels whose
    centre lies in [x0, x1) x [y0, y1) write (the reference tests the rect
    at each slot; it is the same test at every slot of a pixel)."""
    H, W = depth.shape
    dev = depth.device
    sc = None if scissor is None else _scissor_vec(scissor, dev)
    stride = 3 * nedge + 4
    flat = rec_rows.reshape(rec_rows.shape[0], -1)
    d0 = depth.reshape(-1)
    key = torch.cat([order_key(d0) * _HI | _LOW,
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    lane = torch.arange(WIN_W, dtype=torch.int32, device=dev)
    row = torch.arange(win_h, dtype=torch.int32, device=dev)
    live = torch.nonzero(wvalid).reshape(-1)
    for start in range(0, live.shape[0], chunk):
        wi = live[start:start + chunk]
        o = owner[wi]
        m = meta[wi]
        rec = flat[o]                                        # (b, rowlen)
        x = ((m // 2048) * WIN_W)[:, None, None] + lane[None, None, :]
        y = (m % 2048)[:, None, None] + row[None, :, None]
        px = x.to(torch.float32) + 0.5                       # (b, 1, 128)
        py = y.to(torch.float32) + 0.5                       # (b, win_h, 1)
        best = torch.full((o.shape[0], win_h, WIN_W), float("-inf"),
                          device=dev)
        best_s = torch.full(best.shape, -1, dtype=torch.int64, device=dev)
        for s in range(ntri):
            def d(j, _b=s * stride):
                return rec[:, _b + j][:, None, None]
            emax = None
            for j in range(nedge):
                e = (d(3 * j) * px + d(3 * j + 2)) + d(3 * j + 1) * py
                emax = e if emax is None else torch.maximum(emax, e)
            zb = 3 * nedge
            z = (d(zb) * px + d(zb + 2)) + d(zb + 1) * py
            ok = (emax <= 0) & (z > best)
            best = torch.where(ok, z, best)
            best_s = torch.where(ok, s, best_s)
        inb = (x < W) & (y < H)
        if sc is not None:
            inb = inb & (px >= sc[0]) & (px < sc[2]) & (py >= sc[1]) & \
                (py < sc[3])
        p = (y.clamp(max=H - 1) * W + x.clamp(max=W - 1)).to(torch.int64)
        take = inb & (best_s >= 0) & (best > d0[p])
        seq = wi.to(torch.int64)[:, None, None] * ntri + best_s
        k = order_key(best) * _HI | (0xFFFFFFFE - seq)
        key.scatter_reduce_(0, torch.where(take, p, H * W).reshape(-1),
                            k.reshape(-1), "amax")
    key = key[:H * W]
    low = key & _LOW
    changed = low != _LOW
    seq = torch.where(changed, 0xFFFFFFFE - low, 0)
    rid = flat[owner[seq // ntri], (seq % ntri) * stride + 3 * nedge + 3]
    dep = torch.where(changed, _key_float(
        torch.div(key, _HI, rounding_mode="floor")), d0)
    win = torch.where(changed, rid, winner.reshape(-1))
    return dep.reshape(H, W), win.reshape(H, W)


def window_px_kept(rec_rows, meta, depth, scissor=None, *, win_h, ntri,
                   nedge):
    """(B, TILES, ntri) bool: which (8 x 4-pixel tile, record slot) pairs
    of each window kernel B1 evaluates, in plain PyTorch (for tests and
    measurement; the plain version walks every pixel of every window).
    rec_rows (B, row) are the windows' owners' record rows (rec_rows of the
    call, indexed by owner), meta (B,) their packed col*2048 + y0, depth
    the call's incoming (H, W) depth. Tile t of a window covers columns
    8 * (t % 16) + [0, 8) and rows 4 * (t // 16) + [0, 4); TILES = 16 *
    ceil(win_h / 4).

    A pair is dropped iff some edge of the slot reads > 0 at the tile's
    pixel centre where that edge reads least (the left or right column by
    the sign of its x coefficient, the top or bottom row by the sign of
    its y coefficient), in the walk's arithmetic `(a*px + c) + b*py`, or
    does so over the tile's 32 x 16 block (the kernel's first, coarser
    pass: columns 32 * (t % 16 // 4), rows 16 * (t // 64)), or the tile
    lies past the frame, or the slot's depth plane is all zeros and no
    depth is below 0. Correct rounding is monotone, so that edge
    then reads > 0 (or NaN) at every pixel of the tile: the slot is inside
    at none of them. A zero depth plane reads z = 0 <= depth everywhere,
    and such a slot neither writes nor changes which slot of the window
    writes (csrc/splat_raster.cu). With a scissor rect [x0, x1) x [y0,
    y1), a tile is also dropped when no pixel centre of it, or of its
    32 x 16 block, can pass the rect: its last centre column below x0 or
    its first at or past x1 (rows alike)."""
    dev = rec_rows.device
    height, width = depth.shape
    b = meta.shape[0]
    stride = 3 * nedge + 4
    ntiles = WIN_W // 8 * ((win_h + 3) // 4)
    t = torch.arange(ntiles, device=dev)
    x0 = ((meta // 2048) * WIN_W)[:, None]
    y0 = (meta % 2048)[:, None]
    tx = x0 + (t % 16 * 8)[None, :]
    ty = y0 + (t // 16 * 4)[None, :]
    bx = x0 + (t % 16 // 4 * 32)[None, :]                  # its 32 x 16 block
    by = y0 + (t // 64 * 16)[None, :]
    rec = rec_rows.reshape(b, -1)[:, :ntri * stride].reshape(b, ntri,
                                                             stride)
    out = ~((tx < width) & (ty < height))[:, :, None]      # (B, TILES, 1)
    if scissor is not None:
        sc = _scissor_vec(scissor, dev)
        for x, y, w, h in ((bx, by, 32, 16), (tx, ty, 8, 4)):
            meets = ((x + w - 1).to(torch.float32) + 0.5 >= sc[0]) & \
                (x.to(torch.float32) + 0.5 < sc[2]) & \
                ((y + h - 1).to(torch.float32) + 0.5 >= sc[1]) & \
                (y.to(torch.float32) + 0.5 < sc[3])
            out = out | ~meets[:, :, None]
    for j in range(nedge):
        a, bb, c = (rec[:, None, :, 3 * j + k] for k in range(3))
        for x, y, w, h in ((bx, by, 32, 16), (tx, ty, 8, 4)):
            px = (x[:, :, None] + torch.where(a >= 0, 0, w - 1)).to(
                torch.float32) + 0.5
            py = (y[:, :, None] + torch.where(bb >= 0, 0, h - 1)).to(
                torch.float32) + 0.5
            out = out | ((a * px + c) + bb * py > 0)
    if not bool((depth < 0).any()):
        out = out | torch.all(rec[:, None, :, 3 * nedge:3 * nedge + 3] == 0,
                              -1)
    return ~out


def fused_eval_composite(depth, winner, rec_rows, owner, meta, wvalid,
                         scissor=None, *, win_h=32, ntri=8, nedge=3):
    """Evaluate + merge windows (kernel B1; replaces the JAX package's
    `fused_eval_composite` → `_fused_kernel`).

    depth/winner (H, W) f32; rec_rows (ncl, rrows, 128) from
    build_rec_rows (nedge=3) or build_quad_rec_rows (nedge=4), `ntri`
    record slots per row; owner/meta/wvalid from build_windows (wvalid a
    valid prefix, as build_windows gives it: the kernel stops at the first
    invalid window). Per pixel of each window and record slot: edges
    `e = (a*px + c) + b*py`, inside if every e <= 0; `z = (za*px + zc) +
    zb*py`; a write where z beats the depth (strict). scissor: None, or
    the pixel rect (x0, y0, x1, y1) (floats, 0-d tensors or a (4,) tensor
    on the device: a camera's viewport): a pixel whose centre lies
    outside [x0, x1) x [y0, y1) is not written (the reference's
    `use_scissor` instantiation).
    Returns new (depth, winner) — winner holds the record's id field
    (global tri id as f32). CPU tensors run the plain PyTorch version;
    CUDA tensors launch `csrc/splat_raster.cu`, which evaluates only the
    (tile, slot) pairs `window_px_kept` keeps: the same bits."""
    stride = 3 * nedge + 4
    if rec_rows.dim() != 3:
        raise ValueError("rec_rows must be (ncl, rrows, 128)")
    row_len = rec_rows.shape[1] * rec_rows.shape[2]
    if ntri * stride > row_len:
        raise ValueError(f"{ntri} slots of stride {stride} exceed the "
                         f"{row_len}-float record row")
    dev = _cuda.call_device(depth, winner, rec_rows, owner, meta, wvalid)
    if dev.type == "cpu":
        return _fused_plain(depth, winner, rec_rows, owner, meta, wvalid,
                            scissor, win_h=win_h, ntri=ntri, nedge=nedge)
    H, W = depth.shape
    nb = owner.shape[0]
    _cuda.require(depth, "depth", torch.float32)
    _cuda.require(winner, "winner", torch.float32, (H, W))
    _cuda.require(rec_rows, "rec_rows", torch.float32)
    _cuda.require(owner, "owner", torch.int32, (nb,))
    _cuda.require(meta, "meta", torch.int32, (nb,))
    _cuda.require(wvalid, "wvalid", torch.bool, (nb,))
    if nedge not in (3, 4) or nb * ntri >= 0xFFFFFFFE:
        raise ValueError("fused_eval_composite: unsupported shape")
    sc = None if scissor is None else _scissor_vec(scissor, dev)
    key = torch.empty(H * W + 1, dtype=torch.int64, device=depth.device)
    dep_out = torch.empty_like(depth)
    win_out = torch.empty_like(winner)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.bt_splat_fused(
            depth.data_ptr(), winner.data_ptr(), rec_rows.data_ptr(),
            row_len, owner.data_ptr(), meta.data_ptr(), wvalid.data_ptr(),
            nb, ntri, nedge, win_h, H, W, key.data_ptr(), dep_out.data_ptr(),
            win_out.data_ptr(), None if sc is None else sc.data_ptr(),
            _cuda.stream_ptr(depth))
    if err == _cuda.INVALID_VALUE:  # launched nothing
        raise ValueError(f"fused_eval_composite: one window of {ntri} "
                         f"slots and {win_h} rows exceeds a CTA's shared "
                         f"memory")
    _cuda.check(err, "bt_splat_fused")
    fused_eval_composite.launches += 1
    return dep_out, win_out


fused_eval_composite.launches = 0


# ----------------------------------------------------------------------
# B6: window composite

def _composite_plain(depth, winner, windows, owner, meta, wvalid, *, win_h,
                     cs, chunk=4096):
    """Plain PyTorch version of B6: a scatter-max of the (dz, -window) keys
    of every in-frame pixel of every valid window where dz beats the
    incoming depth (strict), then the decode."""
    H, W = depth.shape
    dev = depth.device
    d0 = depth.reshape(-1)
    key = torch.cat([order_key(d0) * _HI | _LOW,
                     torch.zeros(1, dtype=torch.int64, device=dev)])
    lane = torch.arange(WIN_W, dtype=torch.int32, device=dev)
    row = torch.arange(win_h, dtype=torch.int32, device=dev)
    for start in range(0, owner.shape[0], chunk):
        m = meta[start:start + chunk]
        dz = windows[start:start + chunk]                  # (b, win_h, 128)
        x = ((m // 2048) * WIN_W)[:, None, None] + lane[None, None, :]
        y = (m % 2048)[:, None, None] + row[None, :, None]
        inb = (x < W) & (y < H) & wvalid[start:start + chunk, None, None]
        p = (y.clamp(max=H - 1) * W + x.clamp(max=W - 1)).to(torch.int64)
        take = inb & (dz > d0[p])
        w = torch.arange(start, start + m.shape[0], device=dev)
        k = order_key(dz) * _HI | (0xFFFFFFFE - w)[:, None, None]
        key.scatter_reduce_(0, torch.where(take, p, H * W).reshape(-1),
                            k.reshape(-1), "amax")
    key = key[:H * W]
    low = key & _LOW
    changed = low != _LOW
    w = torch.where(changed, 0xFFFFFFFE - low, 0)
    hi = torch.div(key, _HI, rounding_mode="floor")
    dz = _key_float(hi)
    lid = dz.view(torch.int32) & ID_MASK
    glob = (owner[w] * cs + lid).to(torch.float32)
    dep = torch.where(changed, dz, d0)
    win = torch.where(changed, glob, winner.reshape(-1))
    return dep.reshape(H, W), win.reshape(H, W)


def composite_windows(depth, winner, windows, owner, meta, wvalid, *,
                      win_h=32, cs=12):
    """Merge evaluated windows into the framebuffer (kernel B6; replaces
    the JAX package's `composite_windows` → `_composite_kernel`).

    depth/winner (H, W) f32; windows (B, win_h, 128) packed from
    eval_windows; owner (B,) int32 each window's cluster (global: the
    shard's offset added), meta (B,) int32 col*2048 + y0 and wvalid (B,)
    bool, a valid prefix, from build_windows. In window order, a pixel
    takes window w where its packed dz > the current depth (strictly),
    writing depth = dz and winner = float(owner[w] * cs + (bits(dz) & 15)):
    the first writer wins ties between windows, and the incoming value wins
    ties against every window. Returns new (depth, winner).

    Windows at single-band clusters' own y0 overlap, so the merge is the
    64-bit key max of B1 (`order(dz) << 32 | (0xFFFFFFFE - w)`, the
    incoming value's low bits 0xFFFFFFFF) and a decode — the windows may
    run in any order. CPU tensors run the plain PyTorch version; CUDA
    tensors launch `csrc/window_composite.cu` (a persistent grid over the
    valid windows, one warp a 2-row group; an empty pixel, dz <= 0, loads
    no depth unless some incoming depth is below 0)."""
    dev = _cuda.call_device(depth, winner, windows, owner, meta, wvalid)
    if dev.type == "cpu":
        return _composite_plain(depth, winner, windows, owner, meta, wvalid,
                                win_h=win_h, cs=cs)
    H, W = depth.shape
    nb = owner.shape[0]
    _cuda.require(depth, "depth", torch.float32)
    _cuda.require(winner, "winner", torch.float32, (H, W))
    _cuda.require(windows, "windows", torch.float32, (nb, win_h, WIN_W))
    _cuda.require(owner, "owner", torch.int32, (nb,))
    _cuda.require(meta, "meta", torch.int32, (nb,))
    _cuda.require(wvalid, "wvalid", torch.bool, (nb,))
    if nb >= 0xFFFFFFFE or cs > (1 << ID_BITS) or \
            nb * ((win_h + 1) // 2) > 0x7FFFFFFF:
        raise ValueError("composite_windows: unsupported shape")
    if windows.data_ptr() % 16:
        raise ValueError("composite_windows: windows must be 16-byte "
                         "aligned (the kernel loads 4 columns at once)")
    key = torch.empty(H * W + 1, dtype=torch.int64, device=dev)
    dep_out = torch.empty_like(depth)
    win_out = torch.empty_like(winner)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        err = lib.bt_window_composite(
            depth.data_ptr(), winner.data_ptr(), windows.data_ptr(),
            owner.data_ptr(), meta.data_ptr(), wvalid.data_ptr(), nb, win_h,
            cs, H, W, key.data_ptr(), dep_out.data_ptr(), win_out.data_ptr(),
            _cuda.stream_ptr(depth))
    _cuda.check(err, "bt_window_composite")
    composite_windows.launches += 1
    return dep_out, win_out


composite_windows.launches = 0
