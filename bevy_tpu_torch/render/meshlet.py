"""Meshlet LOD (port of bevy_tpu/render/meshlet.py; ref:
`bevy_pbr/src/meshlet/from_mesh.rs` — cluster-group simplification via a
QEM simplifier — and the per-frame screen-space-error LOD cut of
`cull_bvh.wesl` / `lod.rs`).

The simplification runs once a mesh on the host (numpy QEM edge
collapse, the JAX package's own code): a chain of simplified whole
meshes with their geometric error (`build_lod_chain`, drawn per instance
by `select_lod`), or a cluster DAG whose per-instance cut mixes levels
within one mesh (`build_cluster_dag`, `select_dag_cut`). The selections
run on the device each frame.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from bevy_tpu_torch.render.mesh import Mesh


def _vertex_quadrics(pos, tris):
    """Per-vertex 4x4 error quadrics: sum of plane quadrics of incident
    triangles (Garland-Heckbert)."""
    v0 = pos[tris[:, 0]]
    v1 = pos[tris[:, 1]]
    v2 = pos[tris[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    area = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(area, 1e-12)
    d = -np.sum(n * v0, axis=1, keepdims=True)
    plane = np.concatenate([n, d], 1)                     # (T, 4)
    # area-weighted plane quadric K = w * p p^T
    k = plane[:, :, None] * plane[:, None, :] * \
        np.maximum(area, 1e-12)[:, :, None]               # (T, 4, 4)
    q = np.zeros((pos.shape[0], 4, 4), np.float64)
    for c in range(3):
        np.add.at(q, tris[:, c], k)
    return q


def _collapse_cost(q, p):
    """Quadric error of placing the merged vertex at p (homogeneous)."""
    ph = np.array([p[0], p[1], p[2], 1.0])
    return float(ph @ q @ ph)


def simplify_mesh(mesh, target_tris, lock_boundary=True):
    """QEM edge-collapse simplification to ~target_tris triangles.

    Returns (Mesh, max_error) where max_error is the largest per-collapse
    quadric displacement (world units) — the level's geometric error used
    by the runtime screen-error LOD test. Attributes (normal, uv) carry
    from the kept endpoint; midpoint placement; boundary edges optionally
    locked (open meshes keep their silhouette). Ref:
    meshlet/from_mesh.rs simplification loop (meshoptimizer
    simplify + simplify_scale)."""
    pos = np.asarray(mesh.positions, np.float64).copy()
    nrm = np.asarray(mesh.normals, np.float64).copy()
    uv = np.asarray(mesh.uvs, np.float64).copy()
    tris = np.asarray(mesh.triangles, np.int64).copy()
    nv = pos.shape[0]

    # weld coincident vertices for connectivity (faceted meshes ship
    # duplicated corners); collapses act on weld classes, attributes stay
    # per original vertex of the surviving class representative
    key = np.round(pos * 1e6).astype(np.int64)
    _, weld, inv = np.unique(key, axis=0, return_index=True,
                             return_inverse=True)
    cls = inv                                 # vertex -> weld class
    rep = np.full(np.max(inv) + 1, -1, np.int64)
    for i in range(nv):
        if rep[cls[i]] < 0:
            rep[cls[i]] = i

    ctris = cls[tris]                          # class-space triangles
    live_tri = (ctris[:, 0] != ctris[:, 1]) & \
               (ctris[:, 1] != ctris[:, 2]) & (ctris[:, 0] != ctris[:, 2])
    cpos = np.zeros((rep.shape[0], 3), np.float64)
    cpos[cls] = pos
    q = _vertex_quadrics(cpos, ctris[live_tri])

    # boundary detection in class space: edges with exactly one face
    if lock_boundary:
        e = np.concatenate([ctris[live_tri][:, [0, 1]],
                            ctris[live_tri][:, [1, 2]],
                            ctris[live_tri][:, [2, 0]]])
        e = np.sort(e, axis=1)
        eu, cnt = np.unique(e, axis=0, return_counts=True)
        locked = np.zeros(rep.shape[0], bool)
        locked[eu[cnt == 1].ravel()] = True
    else:
        locked = np.zeros(rep.shape[0], bool)

    parent = np.arange(rep.shape[0])

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    # candidate edges (class space) with QEM costs
    def edge_heap():
        t = ctris[live_tri]
        e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
        e = np.unique(np.sort(e, axis=1), axis=0)
        h = []
        for a, b in e:
            if locked[a] or locked[b]:
                continue
            mid = (cpos[a] + cpos[b]) * 0.5
            h.append((_collapse_cost(q[a] + q[b], mid), int(a), int(b)))
        heapq.heapify(h)
        return h

    heap = edge_heap()
    n_live = int(live_tri.sum())
    max_err = 0.0
    stale_rounds = 0
    while n_live > target_tris and heap:
        cost, a, b = heapq.heappop(heap)
        ra, rb = find(a), find(b)
        if ra == rb or locked[ra] or locked[rb]:
            continue
        # lazy-deletion staleness check: cost must match current quadrics
        mid = (cpos[ra] + cpos[rb]) * 0.5
        cur = _collapse_cost(q[ra] + q[rb], mid)
        if cur > cost * 1.5 + 1e-12:
            heapq.heappush(heap, (cur, ra, rb))
            stale_rounds += 1
            if stale_rounds > len(heap) * 2 + 64:
                break
            continue
        stale_rounds = 0
        # collapse b -> a at midpoint
        parent[rb] = ra
        q[ra] = q[ra] + q[rb]
        disp = np.linalg.norm(cpos[ra] - mid)
        max_err = max(max_err, float(disp),
                      float(np.sqrt(max(cur, 0.0))))
        cpos[ra] = mid
        # remap + drop degenerate triangles
        hit = (ctris == rb).any(1) | (ctris == ra).any(1)
        ctris[ctris == rb] = ra
        deg = (ctris[:, 0] == ctris[:, 1]) | (ctris[:, 1] == ctris[:, 2]) \
            | (ctris[:, 0] == ctris[:, 2])
        newly = live_tri & deg
        n_live -= int(newly.sum())
        live_tri = live_tri & ~deg
        # push refreshed edges around the merged vertex
        t = ctris[live_tri & hit]
        around = t[(t == ra).any(1)]
        for tri in around:
            for i in range(3):
                x, y = int(tri[i]), int(tri[(i + 1) % 3])
                if x == ra or y == ra:
                    rx, ry = find(x), find(y)
                    if rx != ry and not (locked[rx] or locked[ry]):
                        m2 = (cpos[rx] + cpos[ry]) * 0.5
                        heapq.heappush(
                            heap,
                            (_collapse_cost(q[rx] + q[ry], m2), rx, ry))

    # rebuild a compact vertex-level mesh: per surviving class, one
    # representative original vertex carries the attributes
    final_cls = np.array([find(c) for c in range(rep.shape[0])])
    out_tris = final_cls[ctris[live_tri]]
    used = np.unique(out_tris)
    remap = np.full(rep.shape[0], -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    new_pos = cpos[used]
    new_nrm = nrm[rep[np.minimum(used, rep.shape[0] - 1)]]
    new_uv = uv[rep[np.minimum(used, rep.shape[0] - 1)]]
    # renormalize carried normals
    nl = np.linalg.norm(new_nrm, axis=1, keepdims=True)
    new_nrm = new_nrm / np.maximum(nl, 1e-12)
    out = Mesh(new_pos.astype(np.float32), new_nrm.astype(np.float32),
               new_uv.astype(np.float32),
               remap[out_tris].astype(np.int32))
    return out, max_err


def build_lod_chain(mesh, levels=3, ratio=0.35):
    """LOD0 = input; each further level targets `ratio` x the previous
    triangle count via QEM collapse. Returns (meshes, errors) with
    errors[0] == 0 and errors monotone nondecreasing (a level's error is
    at least its parent's — ref: the DAG error monotonicity requirement
    of meshlet from_mesh.rs)."""
    meshes = [mesh]
    errors = [0.0]
    cur = mesh
    for _ in range(levels - 1):
        tgt = max(8, int(cur.num_triangles * ratio))
        if cur.num_triangles <= 16:
            break
        simp, err = simplify_mesh(cur, tgt)
        if simp.num_triangles >= cur.num_triangles:
            break
        meshes.append(simp)
        errors.append(max(err, errors[-1] * 1.0001))
        cur = simp
    return meshes, errors


def select_lod(dist, errors_world, fov, height, threshold_px=1.0):
    """Per-instance LOD pick: the coarsest level whose projected error
    stays under threshold_px (ref: the meshlet runtime cut test, projected
    group error < 1 px). dist (N,) camera distances, errors_world the
    per-level world-space errors (a list), fov a 0-d tensor. Returns (N,)
    int32 levels; err_px = err_world / dist * (height / (2 tan(fov/2)))."""
    scale = height / (2.0 * torch.tan(fov * 0.5))
    lvl = torch.zeros(dist.shape, dtype=torch.int32, device=dist.device)
    for li in range(1, len(errors_world)):
        err_px = errors_world[li] / torch.clamp(dist, min=1e-6) * scale
        lvl = torch.where(err_px < threshold_px, li, lvl)
    return lvl


# ---------------------------------------------------------------------------
# Cluster-DAG LOD (reference twin: bevy_pbr/src/meshlet/from_mesh.rs —
# per-cluster-group simplification building a DAG whose runtime cut mixes
# levels WITHIN one mesh; the Nanite scheme). The whole-mesh chain above
# stays for instancing scenes; the DAG is for dense hero meshes.


def _morton3(p):
    """(N,3) float → interleaved 30-bit Morton codes (10 bits/axis)."""
    q = p - p.min(0)
    q = q / np.maximum(q.max(0), 1e-12)
    g = np.minimum((q * 1023.0).astype(np.int64), 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(g[:, 0]) | (spread(g[:, 1]) << 1) | (spread(g[:, 2]) << 2)


def _cluster_tris(pos, tris, cs):
    """Partition triangles into Morton-ordered clusters of <= cs."""
    cent = pos[tris].mean(1)
    order = np.argsort(_morton3(cent), kind="stable")
    return [order[i:i + cs] for i in range(0, len(order), cs)]


def _sphere(points):
    c = (points.min(0) + points.max(0)) * 0.5
    r = float(np.linalg.norm(points - c, axis=1).max())
    return c.astype(np.float32), r


def build_cluster_dag(mesh, cs=12, group_size=4, max_levels=16,
                      simplify_ratio=0.5):
    """Build the cluster DAG: LOD0 clusters, then repeatedly group ~4
    adjacent clusters, QEM-simplify the group to ~half its triangles
    (boundary edges locked — shared edges with other groups appear open
    in the submesh, so the group's silhouette is pinned and cuts stay
    crack-free), and split the result into new (parent) clusters.

    Returns (dag_mesh, info): dag_mesh holds EVERY level's clusters
    concatenated cluster-major, each padded to exactly `cs` triangles
    with degenerate point-triangles (the pipeline's cluster unit —
    render/mesh3d.py derives clusters as consecutive cs-sized tri
    groups). info is a dict of per-cluster numpy arrays:
      own_err / own_center / own_radius  — error+sphere of the group the
          cluster was PRODUCED from (0 / own sphere for LOD0)
      parent_err / parent_center / parent_radius — error+sphere of the
          group the cluster was simplified INTO (+inf sphere=own for
          DAG roots)
    The runtime cut (select_dag_cut) draws a cluster iff its own error
    projects under the pixel threshold and its parent group error does
    not — each surface point is covered by exactly one cut cluster
    because every group's children share the parent test values (ref:
    the meshlet runtime cut rule, cull_bvh.wesl).
    Ref: /root/reference/crates/bevy_pbr/src/meshlet/from_mesh.rs:1."""
    INF = np.float32(3.4e38)
    out_pos, out_nrm, out_uv = [], [], []
    out_tris = []                       # per cluster: (cs,3) into OWN verts
    tri_valid = []                      # per cluster: (cs,) real-vs-padding
    own_err, own_c, own_r = [], [], []
    par_err, par_c, par_r = [], [], []  # filled when a cluster is grouped

    def emit_cluster(pos, nrm, uv, tris, err, gc, gr):
        """Append one cluster (<=cs tris) with its producing-group data;
        returns its index."""
        base = sum(p.shape[0] for p in out_pos)
        used = np.unique(tris)
        remap = np.full(used.max() + 1, -1, np.int64)
        remap[used] = np.arange(len(used))
        t = remap[tris]
        tri_valid.append(np.arange(cs) < len(t))
        if len(t) < cs:                 # degenerate padding
            pad = np.zeros((cs - len(t), 3), np.int64)
            t = np.concatenate([t, pad])
        out_pos.append(pos[used])
        out_nrm.append(nrm[used])
        out_uv.append(uv[used])
        out_tris.append(t + base)
        c, r = _sphere(pos[used])
        own_err.append(err)
        own_c.append(gc if gc is not None else c)
        own_r.append(gr if gr is not None else r)
        par_err.append(INF)             # overwritten when grouped
        par_c.append(c)
        par_r.append(r)
        return len(out_tris) - 1

    pos = np.asarray(mesh.positions, np.float64)
    nrm = np.asarray(mesh.normals, np.float64)
    uv = np.asarray(mesh.uvs, np.float64)
    tris = np.asarray(mesh.triangles, np.int64)

    # LOD0 clusters
    level = []
    for cl in _cluster_tris(pos, tris, cs):
        level.append((emit_cluster(pos, nrm, uv, tris[cl], 0.0, None, None),
                      pos, nrm, uv, tris[cl]))

    def _edge_keys(p, t):
        """Boundary-stable edge identity across submeshes: rounded
        endpoint positions (welded clusters share source geometry)."""
        q = np.round(p * 1e5).astype(np.int64)
        keys = set()
        for a, b, c in t:
            for x, y in ((a, b), (b, c), (c, a)):
                k1, k2 = tuple(q[x]), tuple(q[y])
                keys.add((k1, k2) if k1 <= k2 else (k2, k1))
        return keys

    for li in range(max_levels):
        if len(level) <= 1:
            break
        # deeper levels use LARGER groups: coarse patches are perimeter-
        # dominated (measured: 43 of 46 verts locked in a level-3 group
        # of 4), so the group must grow to keep an interior to collapse
        gsize = min(max(group_size, group_size << max(0, li - 1)),
                    max(2, len(level)))
        # group clusters by MESH adjacency (shared boundary edges) — the
        # graph-partition role of METIS in the reference's from_mesh.rs.
        # Morton grouping was tried first and stalls: spatially-near but
        # unconnected patches lock every edge and stop simplifying.
        ekeys = [_edge_keys(p, t) for _, p, _n, _u, t in level]
        edge_owner = {}
        adj = [dict() for _ in level]
        for i, ks in enumerate(ekeys):
            for k in ks:
                j = edge_owner.get(k)
                if j is None:
                    edge_owner[k] = i
                elif j != i:
                    adj[i][j] = adj[i].get(j, 0) + 1
                    adj[j][i] = adj[j].get(i, 0) + 1
        assigned = np.zeros(len(level), bool)
        groups_idx = []
        if len(level) <= gsize * 2:
            # endgame: one group — a closed surface's union has an empty
            # boundary, so the final simplifications are unconstrained
            groups_idx = [list(range(len(level)))]
            assigned[:] = True
        # seed from least-connected clusters (mesh borders/poles first)
        seed_order = np.argsort([len(a) for a in adj], kind="stable")
        for seed in seed_order:
            if assigned[seed]:
                continue
            grp = [int(seed)]
            assigned[seed] = True
            while len(grp) < gsize:
                # pick the candidate with the largest TOTAL shared-edge
                # weight to the group (blob growth, not chain growth)
                w_tot = {}
                for m in grp:
                    for n, w in adj[m].items():
                        if not assigned[n]:
                            w_tot[n] = w_tot.get(n, 0) + w
                if not w_tot:
                    break
                best = max(w_tot, key=w_tot.get)
                grp.append(best)
                assigned[best] = True
            groups_idx.append(grp)
        next_level = []
        for grp_members in groups_idx:
            gidx = [level[i] for i in grp_members]
            if len(gidx) == 1 and len(level) > gsize:
                next_level.append(gidx[0])
                continue
            # merge the group's geometry into one submesh
            gp, gn, gu, gt = [], [], [], []
            voff = 0
            for _, p, n, u, t in gidx:
                used = np.unique(t)
                remap = np.full(used.max() + 1, -1, np.int64)
                remap[used] = np.arange(len(used)) + voff
                gp.append(p[used])
                gn.append(n[used])
                gu.append(u[used])
                gt.append(remap[t])
                voff += len(used)
            gp = np.concatenate(gp)
            gn = np.concatenate(gn)
            gu = np.concatenate(gu)
            gt = np.concatenate(gt)
            gc, gr = _sphere(gp)
            child_err = max(own_err[i] for i, *_ in gidx)
            sub = Mesh(gp, gn, gu, gt)
            tgt = max(cs, int(len(gt) * simplify_ratio))
            simp, serr = simplify_mesh(sub, tgt, lock_boundary=True)
            # DAG error monotonicity: parent error strictly above children
            gerr = np.float32(max(serr, child_err) * 1.0001 + 1e-7)
            if simp.num_triangles >= len(gt):
                continue  # no progress: children stay roots (par = INF)
            for i, *_ in gidx:          # children: parent test values
                par_err[i] = gerr
                par_c[i] = gc
                par_r[i] = gr
            sp = np.asarray(simp.positions, np.float64)
            sn = np.asarray(simp.normals, np.float64)
            su = np.asarray(simp.uvs, np.float64)
            st = np.asarray(simp.triangles, np.int64)
            for cl in _cluster_tris(sp, st, cs):
                ci = emit_cluster(sp, sn, su, st[cl], float(gerr), gc, gr)
                next_level.append((ci, sp, sn, su, st[cl]))
        if not next_level or len(next_level) >= len(level):
            break
        level = next_level

    dag = Mesh(np.concatenate(out_pos).astype(np.float32),
               np.concatenate(out_nrm).astype(np.float32),
               np.concatenate(out_uv).astype(np.float32),
               np.concatenate(out_tris).astype(np.int32))
    info = {
        "own_err": np.asarray(own_err, np.float32),
        "own_center": np.stack(own_c).astype(np.float32),
        "own_radius": np.asarray(own_r, np.float32),
        "parent_err": np.asarray(par_err, np.float32),
        "parent_center": np.stack(par_c).astype(np.float32),
        "parent_radius": np.asarray(par_r, np.float32),
        # static per-tri validity: interior cluster padding must be
        # masked at trace time (the "band bug" — see render/mesh3d.py)
        "tri_valid": np.concatenate(tri_valid),
    }
    return dag, info


def dag_info_tensors(info, device):
    """The per-cluster arrays select_dag_cut reads, as tensors on
    `device` (once a mesh, at prepare)."""
    keys = ("own_err", "own_center", "own_radius", "parent_err",
            "parent_center", "parent_radius")
    return {k: torch.as_tensor(np.asarray(info[k]), device=device)
            for k in keys}


def select_dag_cut(cam_pos, info, fov, height, threshold_px=1.0):
    """The DAG cut: a cluster draws iff its own group error projects
    <= threshold_px and its parent group error projects above (ref: the
    meshlet cut test of cull_bvh.wesl). cam_pos (3,) or (N, 3) camera
    positions in mesh-local space (callers move the camera by each
    instance's inverse TRS); info from dag_info_tensors (or
    build_cluster_dag's numpy arrays); distances are sphere-conservative.
    Returns (ncl,) or (N, ncl) bool."""
    dev = cam_pos.device
    scale = height / (2.0 * torch.tan(torch.as_tensor(fov) * 0.5))

    def proj(err, center, radius):
        center = torch.as_tensor(center, device=dev)
        d = torch.linalg.vector_norm(center - cam_pos[..., None, :], dim=-1)
        d = torch.clamp(d - torch.as_tensor(radius, device=dev), min=1e-5)
        return torch.as_tensor(err, device=dev) / d * scale

    own = proj(info["own_err"], info["own_center"], info["own_radius"])
    par = proj(info["parent_err"], info["parent_center"],
               info["parent_radius"])
    return (own <= threshold_px) & (par > threshold_px)
