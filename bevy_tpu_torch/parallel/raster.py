"""Multi-device cluster raster and row-band deferred shade (port of
bevy_tpu/parallel/raster.py; ref position: the GPU-driven preprocessing
of bevy_render/src/batching/gpu_preprocessing.rs scaled past one device).

Sharding plan, as the JAX package's, over the devices of a `ShardMesh`:

- Clusters (`sharded_flat_raster`) or instances (`sharded_instance_raster`)
  shard: shard d culls, packs and evaluates its part with record ids
  offset by `id_base = d * tv`, so the shards' record tables concatenate
  into one global id space.
- Each shard composites its windows (kernel B6) into a private full-size
  visibility buffer: packed reverse-z|id depth, winner = global record row.
- Merge: the frame splits into n row bands. Band b of every shard is copied
  onto `devices[b]` (the JAX package's `all_to_all`), which takes the depth
  maximum and its first argmax (`torch.argmax` takes the first maximum, as
  `jnp.argmax` does). The packed depth makes the merge order-free.
- The flat-shade records of every shard are concatenated onto each band's
  device (the `all_gather`) and each band resolves there.
- `sharded_deferred_shade` shades each row band of the G-buffer on its
  device with kernel B3, the tile table sliced to the band's tile rows and
  the band's first row in params[34]; no exchange.

Where results live: the JAX package leaves colour and depth row-sharded.
The port's RenderTarget lives on the World's device, so the bands come
back there with one `torch.cat`.

Every shard runs in this one process, one after another; on
several cards their kernel launches are asynchronous and overlap, and the
band exchange is device-to-device copies. No tensor that two shards share
is written in place: where the mesh repeats a device, `.to(dev)` returns
the same tensor.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.ops.raster3d_splat import (
    build_windows, compact_cluster_tris, composite_windows, eval_windows,
)
from bevy_tpu_torch.ops.raster3d_visbuf import (
    ZREC, cluster_screen_aabbs, pack_flat_shade, pack_planes_h, resolve_flat,
)
from bevy_tpu_torch.ops.shade import deferred_shade


def _shard_visbuf(d, k, zrec, aabb, cl_valid, classes, *, width, height,
                  cs, window_budget, eval_tris, id_base):
    """One shard's windows, evaluated and composited (B6) into a private
    (H, W) packed depth + global winner buffer, one pass a window class.
    Returns (depth, winner, dropped windows, fallback clusters)."""
    dev = zrec.device
    zrec_c, _ = compact_cluster_tris(zrec.reshape(-1, ZREC), cs)
    depth = torch.zeros((height, width), dtype=torch.float32, device=dev)
    winner = torch.full((height, width), -1.0, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    fallback = torch.zeros((), dtype=torch.int32, device=dev)
    for class_h, cmask in classes:
        wins = build_windows(aabb, cl_valid & cmask, win_h=class_h,
                             width=width, height=height, budget=window_budget)
        with span("mesh:shard_eval"):
            windows = eval_windows(zrec_c, cs, wins["owner"], wins["meta"],
                                   wins["wvalid"], win_h=class_h,
                                   eval_tris=eval_tris, id_base=id_base)
        with span("mesh:composite_B6"):
            depth, winner = composite_windows(
                depth, winner, windows, wins["owner"] + d * k, wins["meta"],
                wins["wvalid"], win_h=class_h, cs=cs)
        dropped = dropped + wins["overflow"]
        fallback = fallback + torch.sum(wins["fallback"], dtype=torch.int32)
    return depth, winner, dropped, fallback


def _merge_bands(mesh, shards, color, depth):
    """Band merge + resolve. shards: per shard (depth, winner, flat records)
    on its device; color (4, H, W) / depth (H, W) the incoming target.
    Returns (color, depth) on the target's device."""
    n = mesh.size
    H = depth.shape[0]
    bh = H // n
    out_c, out_d = [], []
    with span("mesh:band_merge"):
        for b, dev in enumerate(mesh.devices):
            rows = slice(b * bh, (b + 1) * bh)
            db = torch.stack([s[0][rows].to(dev) for s in shards])
            wb = torch.stack([s[1][rows].to(dev) for s in shards])
            top = torch.amax(db, 0)
            src = torch.argmax(db, 0)
            depth_s = depth[rows].to(dev)
            band_winner = torch.gather(wb, 0, src[None])[0]
            band_winner = torch.where(top > depth_s, band_winner, -1.0)
            frec_all = torch.cat([s[2].to(dev) for s in shards])
            out_c.append(resolve_flat(band_winner.to(torch.int32), frec_all,
                                      color[:, rows].to(dev)))
            out_d.append(torch.maximum(top, depth_s))
        return (torch.cat([c.to(color.device) for c in out_c], 1),
                torch.cat([x.to(depth.device) for x in out_d]))


def sharded_flat_raster(mesh, cc, cn, tri_ok, mat_tri, light_vec, *, width,
                        height, cluster_size=12, win_h=32, visible_budget=4096,
                        window_budget=8192):
    """Rasterise clusters over every device of `mesh`.

    cc (T, 3, 4) clip-space corners, cn (T, 3, 3) world normals, tri_ok (T,)
    valid, mat_tri (T, 9) per-triangle materials, with T a multiple of
    cluster_size; light_vec (16,). Flat-forward shade. Shard d keeps the
    visible clusters with index % n == d, compacted into
    max(8, visible_budget // n) slots, and one window class of win_h rows.
    Height must divide by the device count. Returns colour (4, H, W) and
    packed depth (H, W) on the device of `cc`."""
    n = mesh.size
    cs = cluster_size
    n_cl = cc.shape[0] // cs
    if height % n:
        raise ValueError(f"height {height} does not divide across {n} "
                         f"devices")
    k = max(8, visible_budget // n)          # per-shard cluster budget
    tv = k * cs
    shards = []
    for d, dev in enumerate(mesh.devices):
        with span("mesh:shard_setup"):
            cc_d, cn_d, ok_d, mat_d, lv = (
                x.to(dev) for x in (cc, cn, tri_ok, mat_tri, light_vec))
            aabb, cl_valid, _ = cluster_screen_aabbs(
                cc_d, torch.ones(n_cl, dtype=torch.bool, device=dev), ok_d,
                cs, width, height)
            cl_idx = torch.arange(n_cl, dtype=torch.int32, device=dev)
            mine = cl_valid & (cl_idx % n == d)
            m32 = mine.to(torch.int32)
            pos = torch.cumsum(m32, 0) - 1
            tgt = torch.where(mine & (pos < k), pos, k)
            ids = torch.zeros(k + 1, dtype=torch.int32, device=dev)
            ids[tgt.long()] = cl_idx
            ids = ids[:k].long()
            v = torch.arange(k, device=dev) < torch.sum(m32)
            cc_v = cc_d.reshape(n_cl, cs, 3, 4)[ids]
            cn_v = cn_d.reshape(n_cl, cs, 3, 3)[ids]
            ok_v = v[:, None] & ok_d.reshape(n_cl, cs)[ids]
            mat_v = mat_d.reshape(n_cl, cs, -1)[ids]
            zrec, valid = pack_planes_h(cc_v, cn_v, ok_v, width, height,
                                        id_base=d * tv)
            frec = pack_flat_shade(cn_v, mat_v, lv, valid).reshape(tv, -1)
        depth, winner, _, _ = _shard_visbuf(
            d, k, zrec, aabb[ids], v, ((win_h, v),), width=width,
            height=height, cs=cs, window_budget=window_budget, eval_tris=None,
            id_base=d * tv)
        shards.append((depth, winner, frec))
    out = cc.device
    return _merge_bands(
        mesh, shards, torch.zeros((4, height, width), device=out),
        torch.zeros((height, width), device=out))


def sharded_instance_raster(mesh, clip, nrm, tris, inst_ok, mat_inst,
                            light_vec, color, depth, *, width, height,
                            cluster_size=12, win_h=32, window_budget=8192,
                            eval_tris=None):
    """The flat-opaque mesh pass sharded over instances (the path of
    Mesh3dPlugin(shards=...)).

    Per shard, on its device: its instance slice's corner extraction,
    cluster screen AABBs and cull, plane setup with the shard's id base,
    flat shade records, and two window classes (half and full win_h, as
    the unsharded pass) evaluated and composited with B6; then the band
    merge and resolve. Clusters too large for windows (the unsharded
    pass's fallback to B2) are not rasterised, as in the JAX package: they
    are counted.

    clip (Ni, VC, 4) clip-space vertices, nrm (Ni, VC, 3), tris (TCp, 3)
    the mesh's triangle index table padded to whole clusters (padding
    triangles degenerate), inst_ok (Ni,), mat_inst (Ni, 9); Ni and height
    divide by the device count. color (4, H, W) / depth (H, W) are the
    incoming target. Returns (color, depth, overflow, fallback) on the
    target's device: overflow counts dropped windows plus fallback
    clusters (the JAX package's one count), fallback the clusters alone."""
    n = mesh.size
    cs = cluster_size
    ni = clip.shape[0]
    if ni % n or height % n:
        raise ValueError(f"instances ({ni}) and height ({height}) must "
                         f"divide across {n} devices")
    nis = ni // n                            # instances per shard
    tcp = tris.shape[0]
    cc_num = tcp // cs                       # clusters per instance
    k = nis * cc_num                         # clusters per shard
    tv = k * cs
    nm = mat_inst.shape[1]
    half_h = max(win_h // 2, 8)
    shards, overflow, fallback = [], [], []
    for d, dev in enumerate(mesh.devices):
        with span("mesh:shard_setup"):
            rows = slice(d * nis, (d + 1) * nis)
            clip_s, nrm_s, ok_s, mat_s = (
                x[rows].to(dev) for x in (clip, nrm, inst_ok, mat_inst))
            tri_idx = tris.to(dev)
            cc = clip_s[:, tri_idx].reshape(k, cs, 3, 4)
            cn = nrm_s[:, tri_idx].reshape(k, cs, 3, 3)
            tri_ok = ok_s[:, None].expand(nis, tcp).reshape(k, cs)
            aabb, cl_valid, _ = cluster_screen_aabbs(
                cc, ok_s[:, None].expand(nis, cc_num).reshape(k),
                tri_ok.reshape(tv), cs, width, height)
            mat_tri = mat_s[:, None, None, :].expand(nis, cc_num, cs, nm) \
                .reshape(k, cs, nm)
            zrec, valid = pack_planes_h(cc, cn, tri_ok, width, height,
                                        id_base=d * tv)
            frec = pack_flat_shade(cn, mat_tri, light_vec.to(dev),
                                   valid).reshape(tv, -1)
            h_px = aabb[:, 3] - aabb[:, 1]
        dep, win, drop, fb = _shard_visbuf(
            d, k, zrec, aabb, cl_valid,
            ((half_h, h_px <= half_h - 1.0), (win_h, h_px > half_h - 1.0)),
            width=width, height=height, cs=cs, window_budget=window_budget,
            eval_tris=eval_tris, id_base=d * tv)
        shards.append((dep, win, frec))
        overflow.append(drop + fb)
        fallback.append(fb)
    color, depth = _merge_bands(mesh, shards, color, depth)
    return (color, depth, sum(x.to(depth.device) for x in overflow),
            sum(x.to(depth.device) for x in fallback))


def sharded_deferred_shade(mesh, gbuffer, depth, light_table, tile_counts,
                           params, shadow=None, *, tile_h=32, tile_w=128,
                           **variant):
    """Row-band sharded deferred shade (kernel B3 on each band).

    gbuffer (P, H, W), depth (H, W), shadow (H, W) or None; light_table
    (T, F, mpt) and tile_counts (T,) binned over the band-padded grid of
    n * band rows, band = H / n rounded up to whole tiles; params (40,).
    Band d shades rows [d*band, (d+1)*band) on devices[d] with its tile
    rows of the table and its first row in params[34], so each pixel
    reconstructs its global ray. `variant` takes deferred_shade's flags.
    Returns color (4, H, W) on the device of `depth`."""
    n = mesh.size
    _, h, w = gbuffer.shape
    band = (h + n * tile_h - 1) // (n * tile_h) * tile_h   # rows a band
    hp = band * n
    ntx = (w + tile_w - 1) // tile_w
    tb = band // tile_h * ntx                              # tiles a band
    if light_table.shape[0] != n * tb:
        raise ValueError(f"light_table has {light_table.shape[0]} tiles, "
                         f"the band-padded grid {n * tb}")
    gb = torch.nn.functional.pad(gbuffer, (0, 0, 0, hp - h))
    dp = torch.nn.functional.pad(depth, (0, 0, 0, hp - h))
    sh = None if shadow is None else \
        torch.nn.functional.pad(shadow, (0, 0, 0, hp - h), value=1.0)
    out = []
    for d, dev in enumerate(mesh.devices):
        with span("lights:shade_band_B3"):
            rows = slice(d * band, (d + 1) * band)
            prm = params.to(dev).clone()
            prm[34] = float(d * band)
            out.append(deferred_shade(
                gb[:, rows].to(dev).contiguous(), dp[rows].to(dev),
                light_table[d * tb:(d + 1) * tb].to(dev),
                tile_counts[d * tb:(d + 1) * tb].to(dev), prm,
                None if sh is None else sh[rows].to(dev), tile_h=tile_h,
                tile_w=tile_w, **variant))
    return torch.cat([c.to(depth.device) for c in out], 1)[:, :h]
