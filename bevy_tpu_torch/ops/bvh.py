"""Cluster BVH culling (port of bevy_tpu/ops/bvh.py; ref: bevy meshlet's
BVH-driven cull, `bevy_pbr/src/meshlet/cull_bvh.wesl`, and the BVH build of
`from_mesh.rs`).

The tree is culled level-synchronously: each level is one vectorized
conservative frustum test over its node boxes, masked by the parent level,
instead of a work-queue traversal. A node test reads 8 corners where a
per-cluster test reads 3 * cs, and an interior node's verdict gates its
whole subtree.

The build runs on the host once a mesh (numpy, as the JAX package's):
clusters are Morton-ordered by box centre, then packed bottom-up with
fanout-F contiguous children (node i's children are [i*F, i*F+F) of the
next level).
"""

from __future__ import annotations

import numpy as np
import torch


def _morton3(x, y, z, bits=10):
    """Interleave 3 x bits-bit integers into a Morton code."""
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(bits):
        out |= ((x >> i) & 1).astype(np.uint64) << np.uint64(3 * i)
        out |= ((y >> i) & 1).astype(np.uint64) << np.uint64(3 * i + 1)
        out |= ((z >> i) & 1).astype(np.uint64) << np.uint64(3 * i + 2)
    return out


def cluster_local_aabbs(positions, triangles, cs: int):
    """(NCL, 2, 3) local-space min / max of each cluster of `cs`
    consecutive triangles (the padding tail repeats the last triangle)."""
    tris = np.asarray(triangles, np.int64)
    tc = tris.shape[0]
    ncl = (tc + cs - 1) // cs
    pad = ncl * cs - tc
    if pad:
        tris = np.concatenate([tris, np.repeat(tris[-1:], pad, 0)], 0)
    pts = np.asarray(positions, np.float32)[tris].reshape(ncl, cs * 3, 3)
    return np.stack([pts.min(1), pts.max(1)], 1)


def build_cluster_bvh(local_aabbs, fanout: int = 8, device="cpu"):
    """The level pyramid over cluster boxes. Returns (levels, order):
    `levels`, root first, (n_level, 2, 3) float32 min / max tensors on
    `device`; `order` (NCL,) int64, the Morton permutation from leaf
    position to cluster id. Padding nodes are inverted boxes (max < min),
    which fail every test."""
    aabbs = np.asarray(local_aabbs, np.float32)
    center = (aabbs[:, 0] + aabbs[:, 1]) * 0.5
    lo = center.min(0)
    span = np.maximum(center.max(0) - lo, 1e-9)
    q = np.clip(((center - lo) / span * 1023).astype(np.int64), 0, 1023)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]),
                       kind="stable").astype(np.int64)
    levels = [aabbs[order]]
    while levels[0].shape[0] > 1:
        cur = levels[0]
        pad = (-cur.shape[0]) % fanout
        if pad:
            empty = np.stack([np.full((pad, 3), 1.0, np.float32),
                              np.full((pad, 3), -1.0, np.float32)], 1)
            cur = np.concatenate([cur, empty], 0)
        grp = cur.reshape(-1, fanout, 2, 3)
        levels.insert(0, np.stack([grp[:, :, 0].min(1), grp[:, :, 1].max(1)],
                                  1))
    return ([torch.as_tensor(lv, device=device) for lv in levels],
            torch.as_tensor(order, device=device))


def _corners(aabb):
    """(N, 2, 3) min / max -> (N, 8, 3) box corners (corner i takes max on
    axis k where bit k of i is set)."""
    lo, hi = aabb[:, 0], aabb[:, 1]
    i = torch.arange(8, device=aabb.device)
    picks = torch.stack([(i >> k) & 1 for k in range(3)], 1).to(aabb.dtype)
    return lo[:, None, :] + picks[None] * (hi - lo)[:, None, :]


def _outside(aabb, mvp):
    """True where all 8 corners lie outside one frustum plane (the clip-
    space test of the per-cluster cull, valid for any w sign). mvp (4, 4)
    or (B, 4, 4) instance matrices."""
    c = _corners(aabb)
    ch = torch.cat([c, torch.ones(c.shape[:2] + (1,), dtype=c.dtype,
                                  device=c.device)], -1)
    if mvp.dim() == 2:
        clip = torch.einsum("ij,nkj->nki", mvp, ch)
    else:
        clip = torch.einsum("bij,nkj->bnki", mvp, ch)
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    return (torch.all(x < -w, -1) | torch.all(x > w, -1) |
            torch.all(y < -w, -1) | torch.all(y > w, -1) |
            torch.all(z > w, -1))


def bvh_cull(levels, order, mvp, ncl: int, fanout: int = 8):
    """Level-synchronous BVH frustum cull: each cluster's visibility in
    cluster order (True = possibly visible, a superset of the per-cluster
    test): (NCL,) for mvp (4, 4), (B, NCL) for instance matrices
    (B, 4, 4)."""
    mask = None
    for lv in levels:
        vis = ~_outside(lv, mvp) & torch.all(lv[:, 1] >= lv[:, 0], -1)
        if mask is not None:
            par = torch.repeat_interleave(mask, fanout, dim=-1)
            vis = vis & par[..., :vis.shape[-1]]
        mask = vis
    leaf = mask[..., :ncl]
    out = torch.zeros(leaf.shape, dtype=torch.bool, device=leaf.device)
    out[..., order] = leaf
    return out
