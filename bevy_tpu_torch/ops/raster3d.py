"""Triangle setup and near-plane clipping for the general mesh route (port
of bevy_tpu/ops/raster3d.py; ref: the GPU preprocessing and the hardware
clipper in front of bevy's Opaque3d main pass).

Conventions (matching bevy/wgpu): right-handed y-up world, camera looks
-z, reverse-z depth in [0,1] (GREATER test, clear 0), CCW front faces
with back-face culling. Pixel (0,0) top-left, y down.

The JAX module's `raster_triangles` (its XLA raster backend) is not
ported: the port rasters these triangles with kernel B7
(ops/raster3d_tris.py).
"""

from __future__ import annotations

import torch


def triangle_setup_corners(clip_c, tri_active, width, height,
                           viewport=None):
    """Per-corner clip coords (T,3,4) → screen-space setup dict: corners
    (T,3,2), depth (T,3) NDC z, inv_w (T,3), area2 (T,) (negative for
    front faces after the y flip), valid (T,) and aabb (T,4) screen
    x0 y0 x1 y1. Run clip_near_corners first if geometry can straddle the
    near plane: corners with w <= 1e-6 still invalidate the triangle here
    (a guard, not a clipper). viewport: None (the whole target) or the
    pixel rect (x0, y0, x1, y1) NDC maps onto (ref: Camera::viewport)."""
    w = clip_c[..., 3]
    w_ok = w > 1e-6
    inv_w = 1.0 / torch.where(w_ok, w, 1.0)
    ndc = clip_c[..., :3] * inv_w[..., None]
    if viewport is None:
        vx0, vy0, vw, vh = 0.0, 0.0, width, height
    else:
        vx0, vy0, vx1, vy1 = viewport
        vw, vh = vx1 - vx0, vy1 - vy0
    sx = vx0 + (ndc[..., 0] * 0.5 + 0.5) * vw
    sy = vy0 + (0.5 - ndc[..., 1] * 0.5) * vh
    ax, ay = sx[:, 0], sy[:, 0]
    bx, by = sx[:, 1], sy[:, 1]
    cx, cy = sx[:, 2], sy[:, 2]
    area2 = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    valid = tri_active & (area2 < -1e-12) & torch.all(w_ok, dim=1)
    return {
        "corners": torch.stack([sx, sy], dim=-1),
        "depth": ndc[..., 2],
        "inv_w": inv_w,
        "area2": area2,
        "valid": valid,
        "aabb": torch.stack([
            torch.minimum(torch.minimum(ax, bx), cx),
            torch.minimum(torch.minimum(ay, by), cy),
            torch.maximum(torch.maximum(ax, bx), cx),
            torch.maximum(torch.maximum(ay, by), cy)], dim=1),
    }


def clip_near_corners(clip_c, var_c, active, eps=1e-4, extra_budget=None):
    """Near-plane clip of each triangle against w = eps (the reference
    clipper's role). clip_c (T,3,4) per-corner clip coords, var_c (T,3,K)
    per-corner varyings (interpolated along clipped edges in clip space),
    active (T,) bool.

    Returns (clip_c2, var_c2, active2, src): rows [0, T) hold each input
    triangle's primary output in place (rotated or clipped, winding kept);
    rows [T, T+B) the second triangles of 2-inside/1-outside crossings,
    compacted in input order into a static budget B = extra_budget
    (default max(64, T//4)); src (T+B,) int32 maps every output row to
    its source triangle. Second triangles past the budget are dropped."""
    t = clip_c.shape[0]
    dev = clip_c.device
    if extra_budget is None:
        extra_budget = max(64, t // 4)
    inside = clip_c[..., 3] > eps
    cnt = inside.to(torch.int32).sum(1)
    # rotate so the singleton corner (the inside one when cnt == 1, the
    # outside one when cnt == 2) sits first; a cyclic shift keeps winding
    r = torch.where(cnt == 1, torch.argmax(inside.to(torch.int32), 1),
                    torch.argmax((~inside).to(torch.int32), 1))
    idx = (r[:, None] + torch.arange(3, device=dev)[None]) % 3
    cc = torch.gather(clip_c, 1, idx[:, :, None].expand(t, 3, 4))
    vv = torch.gather(var_c, 1, idx[:, :, None].expand(t, 3,
                                                       var_c.shape[2]))

    def lerp_at(a_c, a_v, b_c, b_v):
        wa, wb = a_c[:, 3], b_c[:, 3]
        d = wa - wb
        tt = (wa - eps) / torch.where(torch.abs(d) > 1e-20, d, 1.0)
        tt = torch.clamp(tt, 0.0, 1.0)[:, None]
        return a_c + tt * (b_c - a_c), a_v + tt * (b_v - a_v)

    i01_c, i01_v = lerp_at(cc[:, 0], vv[:, 0], cc[:, 1], vv[:, 1])
    i02_c, i02_v = lerp_at(cc[:, 0], vv[:, 0], cc[:, 2], vv[:, 2])
    # primary triangle (cnt == 3: untouched; cnt == 1: the tip kept, both
    # far corners pulled to the plane; cnt == 2: the near corner pushed to
    # the plane along edge 0→1, plus a second triangle for the quad's rest)
    one = torch.stack([cc[:, 0], i01_c, i02_c], 1)
    one_v = torch.stack([vv[:, 0], i01_v, i02_v], 1)
    two = torch.stack([i01_c, cc[:, 1], cc[:, 2]], 1)
    two_v = torch.stack([i01_v, vv[:, 1], vv[:, 2]], 1)
    c1 = (cnt == 1)[:, None, None]
    c2 = (cnt == 2)[:, None, None]
    prim_c = torch.where(c1, one, torch.where(c2, two, cc))
    prim_v = torch.where(c1, one_v, torch.where(c2, two_v, vv))
    prim_ok = active & (cnt >= 1)

    # second triangles (i01, v2, i02) of the cnt == 2 rows → static budget
    sec_need = active & (cnt == 2)
    pos = torch.cumsum(sec_need.to(torch.int32), 0) - 1
    tgt = torch.where(sec_need & (pos < extra_budget), pos, extra_budget)
    rows = torch.zeros(extra_budget + 1, dtype=torch.int32, device=dev)
    rows[tgt.long()] = torch.arange(t, dtype=torch.int32, device=dev)
    rows = rows[:extra_budget]
    nsec = sec_need.to(torch.int32).sum()
    sec_ok = torch.arange(extra_budget, device=dev) < \
        torch.clamp(nsec, max=extra_budget)
    rl = rows.long()
    sec_c = torch.stack([i01_c[rl], cc[rl, 2], i02_c[rl]], 1)
    sec_v = torch.stack([i01_v[rl], vv[rl, 2], i02_v[rl]], 1)
    src = torch.cat([torch.arange(t, dtype=torch.int32, device=dev), rows])
    return (torch.cat([prim_c, sec_c]), torch.cat([prim_v, sec_v]),
            torch.cat([prim_ok, sec_ok]), src)
