"""3D mesh rendering, opaque, forward or deferred (port of
bevy_tpu/render/mesh3d.py; ref: bevy_pbr's mesh pipeline + meshlet
visibility-buffer raster, Lambert directional + ambient, or the G-buffer
write of bevy's deferred path).

Three routes, as in the JAX package, each reaching its own kernels:

- **The group route** — `Mesh3dPlugin(backend="auto" | "pallas" |
  "pallas_interpret")`. Every mesh group renders as one uniform instanced
  batch: vertex transform by batched matmul, corner extraction by index
  gather, cluster cull, clipless plane setup, window decomposition, then
  B1 window splat (ops/raster3d_splat.fused_eval_composite) for small
  clusters and B2 streaming tiles (ops/raster3d_visbuf.raster_visbuf) for
  giant and near-plane ones, into one depth + winner-id buffer. Flat
  meshes without an atlas then take a shade-once flat resolve (forward)
  or a one-gather G-buffer write (`deferred=True`; render/deferred.py
  shades it); smooth meshes, textured materials (`atlas=`: base colour,
  normal, lightmap, emissive, metallic-roughness and occlusion textures,
  parallax occlusion, uv transforms) and skinned meshes
  (render/skinned.py) the 64-wide shade records and a per-pixel resolve,
  forward or into the G-buffer. With `Mesh3dPlugin(shards=...)`
  flat-forward groups raster sharded over a ShardMesh
  (parallel/raster.py `sharded_instance_raster`, window composite B6).
- **The general route** — `Mesh3dPlugin(backend="xla")` and
  `make_mesh_pass(..., plugin=None)` (JAX's general branch, which its
  "auto" takes for a forward pass everywhere but on a TPU). One mesh:
  the uniform sub-branch (every instance's vertices by batched matmul);
  several meshes or no plugin: the expanded sub-branch, per-vertex
  gathers through the EXPANSION tables (`install_expansion`). Then the
  near-plane clip (ops/raster3d.clip_near_corners), triangle setup,
  corner records (ops/raster3d_tris.pack_tri_table), tile binning
  (`bin_tris`) and B7 (`raster_tris(layout="corners")`): per-pixel
  perspective-correct Lambert + ambient + emissive. The port keeps no XLA
  raster: B7 is JAX's own "pallas" raster of this branch. It draws
  smooth-shaded and mixed-mesh scenes, every row opaque, reading
  base_color and emissive only; it ignores cull_budget, as JAX's branch
  does, and refuses `deferred=True` as JAX does.
- **`raster_batched_legacy`** — the gather-free raster tail for batched
  uniform geometry: one-hot corner extraction, `_near_clip`, plane
  records (`pack_tri_planes`) and B8 (`raster_tris(layout="planes" |
  "planes_gbuf")`), forward or into the G-buffer's first 12 planes, with
  an optional viewport scissor. No pass calls it; it is an entry for
  callers with their own batched geometry, as in the JAX package.

Both routes render one pass per Camera3d in ascending `order`; a
camera's viewport rect (vp_min / vp_max, target fractions) maps its NDC
onto that pixel rect, sets its aspect and scissors every kernel of its
pass (B1 and B2 on the group route, B7 on the general route), as the
JAX package's `_use_viewports` pass does. The deferred route refuses
several cameras and viewports (ROADMAP C3: the JAX package's deferred
shade and transmission read only the first camera).

The group route splits each mesh group by phase, as the JAX package
does: opaque rows (alpha >= 0.999), transparent rows (weighted-blended
OIT after the opaque groups, forward only: `raster_transparent`) and
transmissive rows (specular or diffuse transmission > 0, drawn by
render/transmission.py's TransmissionPlugin). Per group it also takes a
material depth bias, a custom material (`material_fn`, or
`extended_material` over the standard shade), two-phase occlusion
culling (`occlusion_cull`: last frame's visible clusters nearest-first,
a coarse hi-z, then the survivors; the per-(group, camera) masks in the
"mesh_vis" resource), the BVH cluster cull (`bvh_cull`, meshes of at
least 768 triangles, ops/bvh.py), LOD chains (`add_mesh(lods=)`, one
draw item a level, render/meshlet.py) and the cluster DAG
(`add_mesh_dag`).

`Mesh3dPlugin(motion_vectors=True)` keeps the previous frame's instance
transforms and view-projection (the "mesh_motion" resource) and writes
per-object motion vectors (the target's "motion" planes: previous-frame
pixel offset dy, dx and a validity plane) at the pixels each group-route
batch wins; TAA and motion blur (render/post.py) read them. The general
route clears the planes each frame and writes none, as the JAX package's
general branch. As in the JAX package, only the primary full-window
camera's view-projection is kept.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import component, field, resource
from bevy_tpu_torch.ecs.query import Query, Read, Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.affine import TRS, trs_to_mat4
from bevy_tpu_torch.math.quat import (
    quat_conjugate, quat_rotate_vec3, quat_to_mat3,
)
from bevy_tpu_torch.ops.bvh import (
    build_cluster_bvh, bvh_cull, cluster_local_aabbs,
)
from bevy_tpu_torch.ops.raster3d import (
    clip_near_corners, triangle_setup_corners,
)
from bevy_tpu_torch.ops.raster3d_splat import (
    accumulate_oit, build_quad_rec_rows, build_rec_rows, build_windows,
    coarse_min_depth, coplanar_quad_pairs, eval_oit_windows,
    fused_eval_composite, occlusion_test, oit_blend,
)
from bevy_tpu_torch.ops.raster3d_tris import (
    bin_tris, pack_tri_planes, pack_tri_table, raster_tris,
)
from bevy_tpu_torch.ops.raster3d_visbuf import (
    ZREC, bin_clusters, cluster_records, cluster_screen_aabbs,
    pack_flat_gbuf, pack_flat_shade, pack_planes_h, raster_visbuf,
    resolve_flat, resolve_forward, resolve_gbuf, resolve_gbuf_flat,
    resolve_shade,
)
from bevy_tpu_torch.parallel import as_mesh
from bevy_tpu_torch.parallel import raster as par_raster
from bevy_tpu_torch.render.camera import (
    Camera3d, camera_row, consts, perspective_infinite_reverse, pick_camera,
    pixel_world, select_cameras, view_matrix,
)
from bevy_tpu_torch.render.mesh import MeshPool
from bevy_tpu_torch.render.meshlet import (
    build_cluster_dag, build_lod_chain, dag_info_tensors, select_dag_cut,
    select_lod,
)
from bevy_tpu_torch.render.plugin import (
    PASS_SET, RenderTarget, add_render_stats,
)


@component
class Mesh3d:
    """Handle into the MeshPool (ref: Mesh3d + Handle<Mesh>); lod_near /
    lod_far bound the camera-distance band (ref: VisibilityRange)."""
    mesh = field((), torch.int32)
    layers = field((), torch.int32, default=1)  # ref: RenderLayers bitmask
    lod_near = field((), default=0.0)
    lod_far = field((), default=3.4e38)


@component
class MeshMaterial:
    """StandardMaterial subset (ref: bevy_pbr/src/pbr_material.rs). The
    same fields as the JAX package, so worlds convert column for column.
    The flat-forward path reads base_color, emissive, metallic and
    perceptual_roughness; the flat-deferred path also clearcoat,
    clearcoat_roughness, reflectance and (into a 22-plane G-buffer)
    specular_tint; the deferred shade records also the anisotropy fields
    (flat meshes shade isotropic, as in the JAX package). Alpha below
    0.999 puts a row in the transparent (OIT) phase; specular or diffuse
    transmission above 0 in the transmissive phase, which reads ior,
    thickness and the attenuation fields (render/transmission.py);
    depth_bias offsets the row's depth by bias * 1e-3 in NDC."""
    base_color = field(4, default=(1.0, 1.0, 1.0, 1.0))
    emissive = field(3)
    metallic = field(())
    perceptual_roughness = field((), default=0.5)
    clearcoat = field(())
    clearcoat_roughness = field((), default=0.5)
    specular_transmission = field(())
    ior = field((), default=1.5)
    anisotropy_strength = field(())
    anisotropy_rotation = field(())
    parallax_depth_scale = field(())
    dm_min = field(2)
    dm_max = field(2)
    thickness = field(())
    attenuation_distance = field(())
    attenuation_color = field(3, default=(1.0, 1.0, 1.0))
    diffuse_transmission = field(())
    reflectance = field((), default=0.5)
    specular_tint = field(3, default=(1.0, 1.0, 1.0))
    depth_bias = field(())
    uv_transform = field(6, default=(1.0, 0.0, 0.0, 1.0, 0.0, 0.0))
    uv_min = field(2)
    uv_max = field(2)
    nm_min = field(2)
    nm_max = field(2)
    lm_min = field(2)
    lm_max = field(2)
    em_min = field(2)
    em_max = field(2)
    mr_min = field(2)
    mr_max = field(2)
    oc_min = field(2)
    oc_max = field(2)


@component
class DirectionalLight:
    """ref: bevy_light DirectionalLight — direction is the entity's -Z
    axis; intensity normalized."""
    color = field(3, default=(1.0, 1.0, 1.0))
    illuminance = field((), default=1.0)


@resource
class AmbientLight:
    """ref: bevy_light AmbientLight resource."""
    color = field(3, default=(1.0, 1.0, 1.0))
    brightness = field((), default=0.08)


EXPANSION = "mesh_expansion"
# {"g<group>v<camera>": (n_cl,) bool}, each group's clusters visible at the
# end of last frame (two-phase occlusion culling)
MESH_VIS = "mesh_vis"
MAX_BLOCKS = 32          # windows a cluster may take before the fallback
MESH_ATLAS = "mesh_atlas"      # {"data": (AH, AW, 4) f32}, the material atlas
# {"t", "r", "s": the previous frame's GlobalTransform columns, "vp": its
# primary camera's view-projection}; only "vp" without motion vectors
MESH_MOTION = "mesh_motion"
GROUP_ROUTE = "the group route"
GENERAL_ROUTE = "the general route"


def _unported(feature, item, route=None):
    where = "" if route is None else f" on {route}"
    return NotImplementedError(
        f"{feature} is not ported to bevy_tpu_torch{where} yet "
        f"(ROADMAP {item})")


# Atlas rect columns whose records are built only where a live row sets
# them (the reference's trace-time gates), by the max corner's default
_CHANNEL_RECTS = (("emr", "em"), ("mrr", "mr"), ("ocr", "oc"))
_IDENTITY_UVT = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def _rebuild_expansion(world, plugin):
    """Host, on structural change only (ref position: PrepareMeshes).

    Both routes count the cameras (`_num_cameras`, one pass each) and note
    whether several cameras or a viewport rect need the viewport mapping
    (`_use_viewports`); the deferred route refuses them (ROADMAP C3).

    The general route records the uniform sub-branch's tables when every
    instance shares one mesh, and installs the pool and EXPANSION tables
    (`install_expansion`), as the JAX package does for its non-Pallas
    backends. The group route groups mesh instances per mesh (each group
    renders as one uniform batch) and splits each group by phase: opaque
    `rows_o` (alpha >= 0.999), transparent `rows_t`, transmissive `rows_x`
    (specular or diffuse transmission > 0), as the JAX package's
    `_rebuild_expansion`. It reads the live material rows once for the
    features a frame specialises on (parallax occlusion, uv transforms,
    the channel textures, anisotropy, depth bias) and builds each group's
    LOD levels, DAG tables and BVH."""
    route = plugin.route
    rows = world.query_rows(Mesh3d)
    cam_rows = world.query_rows(Camera3d)
    plugin._num_cameras = max(1, len(cam_rows))
    custom_vp = False
    if len(cam_rows):
        vmn = world.column(Camera3d, "vp_min").cpu().numpy()[cam_rows]
        vmx = world.column(Camera3d, "vp_max").cpu().numpy()[cam_rows]
        custom_vp = bool(np.any(vmn != 0.0) or np.any(vmx != 1.0))
    plugin._use_viewports = plugin._num_cameras > 1 or custom_vp
    if plugin._use_viewports and plugin.cfg["deferred"]:
        raise _unported("several cameras and camera viewports", "C3",
                        "the deferred route")
    mesh_ids = world.column(Mesh3d, "mesh").cpu().numpy()[rows]
    dev = world.device
    if route == GENERAL_ROUTE:
        ids = np.unique(mesh_ids)
        plugin._uniform = _uniform_tables(plugin.pool.meshes[int(ids[0])],
                                          rows, dev) \
            if len(ids) == 1 else None
        install_expansion(world, plugin.pool)
        return
    names = ("base_color", "parallax_depth_scale", "uv_transform",
             "anisotropy_strength", "specular_transmission",
             "diffuse_transmission", "depth_bias") + \
        tuple(f"{c}_max" for _, c in _CHANNEL_RECTS)
    col = {name: world.column(MeshMaterial, name).cpu().numpy()[rows]
           for name in names}
    textured = plugin.atlas is not None
    plugin._spec = dict(
        pom=textured and bool(np.any(col["parallax_depth_scale"] > 0.0)),
        uvt=bool(np.any(col["uv_transform"] !=
                        np.asarray(_IDENTITY_UVT, np.float32))),
        aniso=bool(np.any(col["anisotropy_strength"] > 0.0)),
        bias=bool(np.any(col["depth_bias"] != 0.0)),
        **{key: bool(np.any(col[f"{c}_max"] != 0.0))
           for key, c in _CHANNEL_RECTS})
    alpha = col["base_color"][:, 3]
    trans = np.maximum(col["specular_transmission"],
                       col["diffuse_transmission"]) > 0.0

    def batch_of(mid):
        return uniform_batch(plugin.pool.meshes[mid], dev, textured=textured,
                             tangents=plugin._spec["aniso"] and
                             plugin.cfg["deferred"])

    plugin._groups = []
    for mid in np.unique(mesh_ids):
        mid = int(mid)
        sel = mesh_ids == mid
        grows = rows[sel].astype(np.int64)
        ga, gx = alpha[sel], trans[sel]
        phases = {"o": grows[(ga >= 0.999) & ~gx],
                  "t": grows[(ga < 0.999) & ~gx], "x": grows[gx]}
        grp = dict(batch_of(mid), mesh=mid, n=len(grows),
                   rows=torch.as_tensor(grows, device=dev))
        for k, r in phases.items():
            grp[f"rows_{k}"] = torch.as_tensor(r, device=dev)
            grp[f"n_{k}"] = len(r)
        chain = plugin._lod_chains.get(mid)
        levels = [grp] if chain is None else \
            [grp] + [batch_of(i) for i in chain["ids"][1:]]
        dag = plugin._dags.get(mid)
        for li, lvl in enumerate(levels):
            mesh = plugin.pool.meshes[mid if li == 0 else chain["ids"][li]]
            if plugin._bvh_cull and mesh.num_triangles >= 12 * 64:
                lvl["bvh"] = build_cluster_bvh(
                    cluster_local_aabbs(mesh.positions, mesh.triangles, 12),
                    device=dev)
            if dag is not None:
                lvl["dag"] = dict(info=dag_info_tensors(dag["info"], dev),
                                  threshold_px=dag["threshold_px"],
                                  tri_mask=torch.as_tensor(
                                      dag["info"]["tri_valid"], device=dev))
        if chain is not None:
            grp["lods"] = levels
            grp["chain"] = chain
        plugin._groups.append(grp)


def install_expansion(world, pool):
    """Install the general route's device tables into `world`'s resources
    (the expanded half of the JAX package's `_rebuild_expansion` plus
    `MeshPool.build`): MeshPool.RESOURCE, the pool slab, and EXPANSION,
    per live Mesh3d row in row order its vertices (vert_inst: the row,
    vert_pool: the pool vertex) and triangles (tri_inst: the row,
    tri_verts: indices into the expanded vertices). A world without a
    mesh gets one inactive dummy triangle. Call it again after a
    structural change (Mesh3dPlugin(backend="xla") does, in its prepare
    hook)."""
    dev = world.device
    pool_t = pool.build(dev)
    rows = world.query_rows(Mesh3d).astype(np.int64)
    mids = world.column(Mesh3d, "mesh").cpu().numpy()[rows].astype(np.int64)
    v_cnt = np.asarray([m.num_vertices for m in pool.meshes])
    t_cnt = np.asarray([m.num_triangles for m in pool.meshes])
    if len(rows):
        vc, tc = v_cnt[mids], t_cnt[mids]
        vbase = np.cumsum(vc) - vc          # each instance's first vertex
        tbase = np.cumsum(tc) - tc
        v_off = np.cumsum(v_cnt) - v_cnt    # each mesh's slab offset
        t_off = np.cumsum(t_cnt) - t_cnt
        local_v = np.arange(vc.sum()) - np.repeat(vbase, vc)
        local_t = np.arange(tc.sum()) - np.repeat(tbase, tc)
        mesh_tris = np.concatenate([m.triangles for m in pool.meshes])
        exp = {
            "vert_inst": np.repeat(rows, vc),
            "vert_pool": local_v + np.repeat(v_off[mids], vc),
            "tri_inst": np.repeat(rows, tc),
            "tri_verts": mesh_tris[local_t + np.repeat(t_off[mids], tc)]
            + np.repeat(vbase, tc)[:, None],
        }
    else:
        exp = {"vert_inst": np.zeros(3), "vert_pool": np.zeros(3),
               "tri_inst": np.full(1, world.capacity - 1),
               "tri_verts": np.zeros((1, 3))}
    world.state["res"][MeshPool.RESOURCE] = pool_t
    world.state["res"][EXPANSION] = {
        k: torch.as_tensor(v.astype(np.int32), device=dev)
        for k, v in exp.items()}
    world.structure_version += 1


def _uniform_tables(mesh, rows, device):
    """The general route's uniform sub-branch constants, on the device
    once per prepare: homogeneous positions (VC, 4), normals (VC, 3), and
    per triangle of every instance (instance-major) its expanded vertex
    indices and its world row."""
    vc, tc = mesh.num_vertices, mesh.num_triangles
    ni = len(rows)
    tri_verts = (mesh.triangles.astype(np.int64)[None] +
                 (np.arange(ni) * vc)[:, None, None]).reshape(ni * tc, 3)
    ones = np.ones((vc, 1), np.float32)
    return {
        "rows": torch.as_tensor(rows.astype(np.int64), device=device),
        "ph": torch.as_tensor(np.concatenate([mesh.positions, ones], 1),
                              device=device),
        "normals": torch.as_tensor(mesh.normals, device=device),
        "tri_verts": torch.as_tensor(tri_verts, device=device),
        "tri_rows": torch.as_tensor(np.repeat(rows.astype(np.int64), tc),
                                    device=device),
    }


def uniform_batch(mesh, device, cs=12, rigid=True, textured=False,
                  tangents=False):
    """Per-mesh constants of a uniform batch, on the device once per
    prepare (so a frame copies nothing from the host): homogeneous
    positions, normals, the triangle index table padded to whole clusters
    (padding = degenerate), the bounding sphere, whether every triangle's
    corner normals are equal ("flat": the flat records shade it exactly),
    and for `rigid` geometry the static coplanar quad pairing
    (single-cluster, mostly-quad meshes only; skinned meshes pass
    rigid=False). `textured` adds the corner UVs ("cuv", (TCP, 3, 2)) and
    the mesh-space triangle tangents ("tan", (TCP, 3)), zero-padded;
    `tangents` the tangents alone (anisotropy without an atlas)."""
    tc0 = mesh.num_triangles
    tcp = (tc0 + cs - 1) // cs * cs
    tris = np.zeros((tcp, 3), np.int64)
    tris[:tc0] = mesh.triangles
    pos = mesh.positions
    cen = (pos.min(0) + pos.max(0)) * 0.5
    quads = None
    if rigid and tcp == cs:
        entries = coplanar_quad_pairs(pos, mesh.triangles)
        if 2 * sum(1 for e in entries if e[0] == "pair") >= tc0:
            quads = entries
    ones = np.ones((mesh.num_vertices, 1), np.float32)
    nrm = mesh.normals[mesh.triangles.astype(np.int64)]
    out = {
        "ph": torch.as_tensor(np.concatenate([pos, ones], 1), device=device),
        "normals": torch.as_tensor(mesh.normals, device=device),
        "tris": torch.as_tensor(tris, device=device),
        "center": torch.as_tensor(cen, device=device),
        "radius": float(np.linalg.norm(pos - cen, axis=1).max()),
        "quads": quads,
        "flat": bool(np.all(nrm[:, 0] == nrm[:, 1]) and
                     np.all(nrm[:, 0] == nrm[:, 2])),
    }
    if textured:
        cuv = np.zeros((tcp, 3, 2), np.float32)
        cuv[:tc0] = mesh.uvs[mesh.triangles.astype(np.int64)]
        out["cuv"] = torch.as_tensor(cuv, device=device)
    if textured or tangents:
        tan = np.zeros((tcp, 3), np.float32)
        tan[:tc0] = mesh.tri_tangents()
        out["tan"] = torch.as_tensor(tan, device=device)
    return out


def directional_light_vec(light, amb):
    """(16,) light params for the raster: [dir xyz, light rgb, ambient rgb,
    0…] from the first DirectionalLight entity + AmbientLight."""
    li, has_light = pick_camera(light.mask)
    rot = camera_row(light.global_transform.rotation, li)
    ldir = quat_rotate_vec3(rot, consts(rot.device)["-z"])
    lcol = camera_row(light.directional_light.color, li) * \
        camera_row(light.directional_light.illuminance, li) * has_light
    return torch.cat([ldir, lcol, amb.color * amb.brightness,
                      torch.zeros(7, device=rot.device)])


def motion_delta(tp, rp, sp, tc, rc, sc):
    """Per-instance previous-to-current affine D = M_prev M_cur^-1 as 12
    floats [A row-major 9, b 3], prev_world = A world + b (ref: the
    previous-frame MeshUniforms of bevy_pbr's motion-vector prepass)."""
    mp = quat_to_mat3(rp)
    mc = quat_to_mat3(rc)
    ratio = sp / torch.clamp(sc, min=1e-12)
    a = torch.einsum("nij,nj,nkj->nik", mp, ratio, mc)
    b = tp - torch.einsum("nij,nj->ni", a, tc)
    return torch.cat([a.reshape(-1, 9), b], -1)


def write_motion(target, winner, mot, prev_vp, cur_inv_vp):
    """Per-object motion vectors at the pixels this batch won: the winner's
    instance delta (mot (T, 12), by triangle id) takes the pixel's world
    position to the previous frame's, projected by the previous VP. The
    target's motion planes [dy, dx, valid] keep their value elsewhere."""
    depth = target.depth
    hh, ww = depth.shape
    ok = winner >= 0
    dmat = mot[torch.clamp(winner, min=0).long()]            # (H, W, 12)
    wpx = pixel_world(cur_inv_vp, depth, ww, hh)
    # a 3x3 affine a pixel, elementwise (a batched matmul of 3x3 blocks
    # is slow on the card)
    pw = torch.sum(dmat[..., 0:9].reshape(hh, ww, 3, 3) * wpx[..., None, :],
                   -1) + dmat[..., 9:12]
    pc = torch.einsum("ij,hwj->hwi", prev_vp,
                      torch.cat([pw, torch.ones_like(pw[..., :1])], -1))
    pcw = torch.where(torch.abs(pc[..., 3]) > 1e-8, pc[..., 3],
                      torch.ones_like(pc[..., 3]))
    px_prev = (pc[..., 0] / pcw * 0.5 + 0.5) * ww - 0.5
    py_prev = (0.5 - pc[..., 1] / pcw * 0.5) * hh - 0.5
    dev = depth.device
    ysf = (torch.arange(hh, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xsf = (torch.arange(ww, dtype=torch.float32, device=dev) + 0.5)[None, :]
    planes = torch.stack([py_prev - (ysf - 0.5), px_prev - (xsf - 0.5),
                          torch.ones_like(px_prev)])
    target.motion = torch.where(ok[None], planes, target.motion)


def raster_batched(clip, nrm, batch, inst_ok, mat_inst, light_vec,
                   target, stats, *, width, height, tile_h=16, tile_w=128,
                   max_per_tile=512, cluster_size=12, win_h=32,
                   window_budget=65536, eval_tris=None,
                   visible_budget=65536, deferred=False, depth_only=False,
                   flat_ok=False, corner_uv=None, uvr_i=None, uvt_i=None,
                   tan_i=None, nmr_i=None, lmr_i=None, dmr_i=None,
                   emr_i=None, mrr_i=None, ocr_i=None, atlas=None, ray=None,
                   parallax_layers=0, motd_i=None, prev_vp=None,
                   cur_inv_vp=None, viewport=None, vis_state=None,
                   phase_budget=16384, material_fn=None, bias_i=None,
                   cl_extra=None, tri_mask=None):
    """Visibility-buffer raster of one uniform batch.

    clip (Ni, VC, 4) clip-space positions, nrm (Ni, VC, 3) world normals,
    batch the mesh's `uniform_batch` constants, inst_ok (Ni,) bool,
    mat_inst (Ni, 9) [rgba, emissive, metallic, roughness], or (Ni, 15)
    with clearcoat, clearcoat roughness, anisotropy, anisotropy rotation,
    parallax depth scale and reflectance (always for the shade records or
    `deferred`), or (Ni, 18) with the specular tint rgb. Writes
    target.depth, and target.color (forward, composed over the incoming
    color) or target.gbuffer (deferred).

    `depth_only` (the shadow passes, render/shadow.py) writes target.depth
    alone: the plane records only (no shade record, whatever the mesh's
    normals or UVs), B1 and B2, no resolve; nrm, mat_inst and light_vec
    may then be None.

    Two record paths, one raster (B1 for two window classes, then B2 for
    the fallback clusters):
    - flat (`flat_ok`: every triangle's corner normals are equal, and no
      corner_uv, and no material_fn on the forward path): flat records
      shaded once a triangle (resolve_flat, resolve_gbuf_flat);
    - otherwise the 64-wide shade records (pack_planes_h(build_srec=True))
      and the per-pixel resolve_forward / resolve_gbuf, or the custom
      material: `material_fn(normal (H, W, 3), mat (H, W, 17|20), ok
      (H, W), light_vec)` returns rgba (H, W, 4) at the resolve
      (resolve_shade's planes). corner_uv (TC, 3, 2) static mesh UVs with
      uvr_i (Ni, 4) base-colour atlas rects, an optional uv_transform
      uvt_i (Ni, 6) (the Affine2 on mesh UVs before the rect wrap), tan_i
      (Ni, TCP, 3) world tangents a padded triangle, the atlas rects
      nmr_i, lmr_i, dmr_i, emr_i, mrr_i, ocr_i (Ni, 4), atlas (AH, AW, 4),
      and ray (3, 3) with parallax_layers > 0 for parallax occlusion (see
      ops/raster3d_visbuf.resolve_shade).

    viewport: None or a camera's pixel rect, a (4,) device tensor (x0, y0,
    x1, y1): NDC maps onto it and B1 and B2 scissor to it. bias_i (Ni,)
    material depth biases (clip z += bias * 1e-3 * w). cl_extra (Ni, CC)
    bool upstream cluster verdicts (the BVH cull, the DAG cut); tri_mask
    (TCP,) bool static triangle validity (the DAG's padding).

    vis_state {"mask": (Ni * CC,) bool}: two-phase occlusion culling (ref:
    bevy meshlet's two-pass cull). Phase 1 draws last frame's visible
    clusters nearest-first (at most phase_budget), a coarse min-depth
    then culls the rest, phase 2 draws the survivors; the final hi-z
    writes the next frame's mask into vis_state. Without it every visible
    cluster draws in one phase (compacted to visible_budget when fewer).
    Clusters past a budget count into stats.pair_overflow.

    motd_i (Ni, 12) per-instance motion deltas (motion_delta) with the
    previous VP prev_vp and this frame's inverse VP cur_inv_vp (4, 4):
    write_motion then writes target.motion where this batch won.

    Profiler spans (torch.profiler): mesh:setup, mesh:windows,
    mesh:splat_B1, mesh:fallback_bin, mesh:stream_B2, mesh:occlusion,
    mesh:resolve."""
    srec_in = None if depth_only or (
        flat_ok and corner_uv is None and (deferred or material_fn is None)) \
        else dict(corner_uv=corner_uv, uvr_i=uvr_i, uvt_i=uvt_i,
                  tan_i=tan_i, nmr_i=nmr_i, lmr_i=lmr_i, dmr_i=dmr_i,
                  emr_i=emr_i, mrr_i=mrr_i, ocr_i=ocr_i)
    cs = cluster_size
    dev = clip.device
    ni = clip.shape[0]
    tri_idx = batch["tris"]
    cc_num = tri_idx.shape[0] // cs                 # clusters per instance
    n_cl = ni * cc_num
    with span("mesh:setup"):
        # corner extraction: an index gather (bit-equal to the TPU's
        # one-hot matmul, whose every output is one product by 1.0)
        cc_all = clip[:, tri_idx].reshape(n_cl, cs, 3, 4)
        cn_all = None if depth_only else \
            nrm[:, tri_idx].reshape(n_cl, cs, 3, 3)
        cl_ok = inst_ok[:, None].expand(ni, cc_num).reshape(n_cl)
        if cl_extra is not None:
            cl_ok = cl_ok & cl_extra.reshape(n_cl)
        aabb_all, cl_valid, zmax_all = cluster_screen_aabbs(
            cc_all, cl_ok, torch.ones(n_cl * cs, dtype=torch.bool,
                                      device=dev), cs, width, height,
            viewport=viewport)
    ntri_f = cs if eval_tris is None else min(eval_tris, cs)
    quads = batch["quads"]

    def run_phase(sel, k, cluster_base, depth, winner, order="index"):
        """Select at most k clusters of `sel`, pack their records with ids
        offset by cluster_base * cs, and raster them (two window classes
        on B1, the fallback on B2). order "near": nearest first (a stable
        argsort, as the JAX package's); "index": a cumsum compaction,
        the identity when k covers every cluster. Returns (depth, winner,
        the resolve's records or None, the motion rows or None)."""
        with span("mesh:setup"):
            identity = k >= n_cl and order == "index"
            if identity:
                k, ids, v = n_cl, None, sel
            else:
                nsel = torch.sum(sel.to(torch.int32))
                if order == "near":
                    key = torch.where(sel, 1.0 - zmax_all, 3.4e38)
                    ids = torch.argsort(key, stable=True)[:k]
                    v = sel[ids]
                else:
                    pos = torch.cumsum(sel.to(torch.int32), 0) - 1
                    tgt = torch.where(sel & (pos < k), pos, k)
                    ids = torch.zeros(k + 1, dtype=torch.int64, device=dev)
                    ids[tgt.long()] = torch.arange(n_cl, device=dev)
                    ids = ids[:k]
                    v = torch.arange(k, device=dev) < nsel
                stats.pair_overflow = stats.pair_overflow + \
                    torch.clamp(nsel - k, min=0)
            inst_v = None if identity else ids // cc_num
            local = None if identity else ids % cc_num

            def per_inst(src):     # (Ni, w) -> (k, cs, w), row-major ids
                w_ = src.shape[1]
                if identity:
                    return src[:, None, None, :].expand(
                        ni, cc_num, cs, w_).reshape(n_cl, cs, w_)
                return src[inst_v][:, None, :].expand(k, cs, w_)

            def per_cluster(x):    # (n_cl, ...) -> (k, ...)
                return x if identity else x[ids]

            def per_local(x):      # (cc_num, ...) -> (k, ...)
                if identity:
                    return x[None].expand((ni,) + x.shape).reshape(
                        (n_cl,) + x.shape[1:])
                return x[local]

            cc = per_cluster(cc_all)
            cn = None if depth_only else per_cluster(cn_all)
            if bias_i is not None:
                # ref: StandardMaterial::depth_bias — a constant reverse-z
                # NDC offset: clip z += b * w survives the divide
                b = per_inst(bias_i.reshape(ni, 1))[..., 0] * 1e-3
                cc = torch.cat([cc[..., :2], cc[..., 2:3] + b[..., None, None]
                                * cc[..., 3:4], cc[..., 3:4]], -1)
            tri_ok = v[:, None].expand(k, cs)
            if tri_mask is not None:
                tri_ok = tri_ok & per_local(tri_mask.reshape(cc_num, cs))
            mat_tri = None if depth_only else per_inst(mat_inst)
            id_base = cluster_base * cs
            frec = None
            if depth_only:
                zrec, _ = pack_planes_h(cc, cn, tri_ok, width, height,
                                        id_base, viewport=viewport)
            elif srec_in is not None:
                zrec, frec, valid = pack_planes_h(
                    cc, cn, tri_ok, width, height, id_base,
                    viewport=viewport, build_srec=True, materials=mat_tri,
                    **_srec_parts(srec_in, batch, per_inst, per_local,
                                  per_cluster, n_cl, cc_num, cs))
            else:
                zrec, valid = pack_planes_h(cc, cn, tri_ok, width, height,
                                            id_base, viewport=viewport)
                if deferred:
                    frec = pack_flat_gbuf(cn, mat_tri, valid)
                else:
                    frec = pack_flat_shade(cn, mat_tri, light_vec, valid)
            if frec is not None:
                frec = frec.reshape(k * cs, frec.shape[-1])
            mot = None if motd_i is None else \
                per_inst(motd_i).reshape(k * cs, 12)
            if quads is not None:
                # coplanar-quad records: the window kernel evaluates ~half
                # the slots with 4-edge quads
                nslots = min(len(quads), max(2, (ntri_f + 1) // 2))
                rec_rows = build_quad_rec_rows(zrec, cs, quads, nslots)
                nedge = 4
            else:
                nslots = ntri_f
                rec_rows = build_rec_rows(zrec, cs, nslots)
                nedge = 3
            aabb = per_cluster(aabb_all)
            zmax = per_cluster(zmax_all)
        # two window classes: half-height windows for small footprints
        h_px = aabb[:, 3] - aabb[:, 1]
        half_h = max(win_h // 2, 8)
        classes = ((half_h, h_px <= half_h - 1.0),
                   (win_h, h_px > half_h - 1.0))
        # a class's window budget: every window its clusters can take (a
        # cluster of more than MAX_BLOCKS blocks goes to the fallback), so
        # only `window_budget` caps it. The JAX package's 4 k + 64 drops
        # windows of a few large clusters at 1280x720 (ROADMAP C3);
        # wherever it drops none, the windows and the frame are the same.
        wbudget = min(window_budget // 2, MAX_BLOCKS * k + 64)
        wbudget = (wbudget + 7) // 8 * 8
        fallback = None
        for class_h, cmask in classes:
            with span("mesh:windows"):
                wins = build_windows(aabb, v & cmask, win_h=class_h,
                                     width=width, height=height,
                                     budget=wbudget, max_blocks=MAX_BLOCKS)
            with span("mesh:splat_B1"):
                depth, winner = fused_eval_composite(
                    depth, winner, rec_rows, wins["owner"], wins["meta"],
                    wins["wvalid"], viewport, win_h=class_h, ntri=nslots,
                    nedge=nedge)
            stats.pair_overflow = stats.pair_overflow + wins["overflow"]
            fallback = wins["fallback"] if fallback is None else \
                fallback | wins["fallback"]

        # fallback: giant footprints + near-plane straddlers through the
        # binned streaming tile kernel, compacted first to a small static
        # budget
        with span("mesh:fallback_bin"):
            kfb = min(2048, k)
            fb32 = fallback.to(torch.int32)
            nfb = torch.sum(fb32)
            posf = torch.cumsum(fb32, 0) - 1
            tgtf = torch.where(fallback & (posf < kfb), posf, kfb)
            idsf = torch.zeros(kfb + 1, dtype=torch.int32, device=dev)
            idsf[tgtf.long()] = torch.arange(k, dtype=torch.int32,
                                             device=dev)
            idsf = idsf[:kfb]
            vfb = torch.arange(kfb, dtype=torch.int32, device=dev) < nfb
            stats.pair_overflow = stats.pair_overflow + \
                torch.clamp(nfb - kfb, min=0)
            stats.fallback_clusters = stats.fallback_clusters + nfb
            zrec_f = zrec.reshape(k, cs, ZREC)[idsf].reshape(kfb * cs, ZREC)
            hp_t = (height + tile_h - 1) // tile_h
            wp_t = (width + tile_w - 1) // tile_w
            qz = torch.clamp((1.0 - zmax[idsf]) * 65535.0, 0, 65535) \
                .to(torch.int32)
            cl_table, cl_counts, st = bin_clusters(
                aabb[idsf], vfb, ntx=wp_t, nty=hp_t, tile_w=tile_w,
                tile_h=tile_h,
                max_clusters_per_tile=max(256, max_per_tile // cs),
                pair_budget=4 * kfb + hp_t * wp_t + 1024, order_key=qz)
            recs = cluster_records(zrec_f, cs)
        with span("mesh:stream_B2"):
            depth, winner = raster_visbuf(depth, winner, recs, cl_table,
                                          cl_counts, viewport, tile_h=tile_h,
                                          tile_w=tile_w, cs=cs)
        stats.pair_overflow = stats.pair_overflow + st["pair_overflow"]
        stats.tile_overflow = stats.tile_overflow + st["tile_overflow"]
        return depth, winner, frec, mot

    depth = target.depth
    winner = torch.full_like(depth, -1.0)
    if vis_state is not None and not depth_only:
        kp = min(phase_budget, n_cl)
        prev = vis_state["mask"]
        depth, winner, f1, m1 = run_phase(cl_valid & prev, kp, 0, depth,
                                          winner, order="near")
        with span("mesh:occlusion"):
            occ = occlusion_test(aabb_all, zmax_all, coarse_min_depth(depth))
        depth, winner, f2, m2 = run_phase(cl_valid & ~prev & ~occ, kp, kp,
                                          depth, winner, order="near")
        frec = None if f1 is None else torch.cat([f1, f2])
        mot = None if m1 is None else torch.cat([m1, m2])
        with span("mesh:occlusion"):
            vis_state["mask"] = cl_valid & ~occlusion_test(
                aabb_all, zmax_all, coarse_min_depth(depth))
    else:
        depth, winner, frec, mot = run_phase(
            cl_valid, min(visible_budget, n_cl), 0, depth, winner)
    target.depth = depth
    if depth_only:
        return
    with span("mesh:resolve"):
        win = winner.to(torch.int32)
        if srec_in is not None and deferred:
            target.gbuffer = resolve_gbuf(win, frec, target.gbuffer,
                                          atlas=atlas, ray=ray,
                                          parallax_layers=parallax_layers)
        elif srec_in is not None and material_fn is not None:
            # custom material (ref: the Material trait + the custom shader
            # examples): user shading code in the resolve position
            n, mat, ok = resolve_shade(win, frec, atlas, ray=ray,
                                       parallax_layers=parallax_layers)
            rgba = material_fn(n, mat, ok, light_vec)
            target.color = torch.where(ok[None], rgba.permute(2, 0, 1),
                                       target.color)
        elif srec_in is not None:
            target.color = resolve_forward(win, frec, light_vec,
                                           target.color, atlas=atlas,
                                           ray=ray,
                                           parallax_layers=parallax_layers)
        elif deferred:
            target.gbuffer = resolve_gbuf_flat(win, frec, target.gbuffer)
        else:
            target.color = resolve_flat(win, frec, target.color)
        if mot is not None:
            write_motion(target, win, mot, prev_vp, cur_inv_vp)


def _srec_parts(srec_in, batch, per_inst, per_local, per_cluster, n_cl,
                cc_num, cs):
    """pack_planes_h's per-triangle shade-record inputs of one phase's
    clusters, in (k, cs, ...) cluster shapes (JAX's run_phase keeps flat
    (k * cs, ...) shapes here: the same row-major triangles,
    elementwise)."""
    cuv = rect = None
    if srec_in["corner_uv"] is not None and srec_in["uvr_i"] is not None:
        cuv = per_local(batch["cuv"].reshape(cc_num, cs, 3, 2))
        rect = per_inst(srec_in["uvr_i"])
        if srec_in["uvt_i"] is not None:
            # uv_transform (ref: StandardMaterial::uv_transform, an Affine2
            # on mesh UVs), before the per-instance atlas-rect wrap
            a = per_inst(srec_in["uvt_i"])
            u, v = cuv[..., 0], cuv[..., 1]
            cuv = torch.stack(
                [a[..., 0:1] * u + a[..., 1:2] * v + a[..., 4:5],
                 a[..., 2:3] * u + a[..., 3:4] * v + a[..., 5:6]], -1)
    tan = nm = None
    if srec_in["tan_i"] is not None:
        tan = per_cluster(srec_in["tan_i"].reshape(n_cl, cs, 3))
        # no normal map: a zero rect disables sampling, the tangent still
        # reaches the record (anisotropy needs it)
        nm = per_inst(srec_in["nmr_i"]) \
            if srec_in["nmr_i"] is not None and cuv is not None \
            else tan.new_zeros(tan.shape[:2] + (4,))

    def rect_of(key):
        x = srec_in[key]
        return per_inst(x) if x is not None and cuv is not None else None

    return dict(cuv=cuv, tex_rect=rect, tangents=tan, nm_rect=nm,
                lm_rect=rect_of("lmr_i"), dm_rect=rect_of("dmr_i"),
                em_rect=rect_of("emr_i"), mr_rect=rect_of("mrr_i"),
                oc_rect=rect_of("ocr_i"))


def _frustum_cull(batch, gt_t, gt_r, gt_s, inst_ok, view, fov, near, aspect,
                  budget):
    """Instance-level sphere-frustum cull + compaction (ref: the GPU
    frustum cull of mesh_preprocess.wesl): every later stage then runs on
    `budget` instances. Returns (ids (budget,) int32 into the batch rows,
    visible count)."""
    wc = gt_t + quat_rotate_vec3(gt_r, batch["center"][None] * gt_s)
    r_i = batch["radius"] * torch.amax(torch.abs(gt_s), 1)
    vch = wc @ view[:3, :3].T + view[:3, 3]
    tf_ = torch.tan(fov * 0.5)
    ta_ = tf_ * aspect
    vz = vch[:, 2]
    inside = -vz > near - r_i
    inside &= (-vz * ta_ - torch.abs(vch[:, 0])) > \
        -r_i * torch.sqrt(1.0 + ta_ * ta_)
    inside &= (-vz * tf_ - torch.abs(vch[:, 1])) > \
        -r_i * torch.sqrt(1.0 + tf_ * tf_)
    inside &= inst_ok
    ins32 = inside.to(torch.int32)
    posc = torch.cumsum(ins32, 0) - 1
    tgt = torch.where(inside & (posc < budget), posc, budget)
    ids = torch.zeros(budget + 1, dtype=torch.int32, device=gt_t.device)
    ids[tgt.long()] = torch.arange(gt_t.shape[0], dtype=torch.int32,
                                   device=gt_t.device)
    return ids[:budget], torch.sum(ins32)


def _camera_view(q, cam, ci, has_cam, width, height, use_viewports):
    """One camera's view (ci, has_cam: 0-d device tensors from pick_camera
    or select_cameras; its rows gathered with camera_row, so no host
    read): its rows, view and view-projection, viewport and aspect, and
    each mesh row's distance to it and visibility (RenderLayers bitmask +
    LOD distance band). With `use_viewports` the camera's rect fractions
    times the target give the pixel rect (x0, y0, x1, y1), a (4,) tensor,
    and the aspect its width over its height, as the JAX package's
    render_view; else no viewport and the target's aspect."""
    gt = cam.global_transform
    t = camera_row(gt.translation, ci)
    r = camera_row(gt.rotation, ci)
    fov = camera_row(cam.camera3d.fov, ci)
    near = camera_row(cam.camera3d.near, ci)
    if use_viewports:
        vmin = camera_row(cam.camera3d.vp_min, ci)
        vmax = camera_row(cam.camera3d.vp_max, ci)
        viewport = torch.stack([vmin[0] * width, vmin[1] * height,
                                vmax[0] * width, vmax[1] * height])
        aspect = (viewport[2] - viewport[0]) / torch.clamp(
            viewport[3] - viewport[1], min=1e-6)
    else:
        viewport, aspect = None, width / height
    view = view_matrix(t, r, camera_row(gt.scale, ci))
    vp = perspective_infinite_reverse(fov, aspect, near) @ view
    distr = torch.linalg.vector_norm(q.global_transform.translation - t,
                                     dim=-1)
    visrow = ((q.mesh3d.layers & camera_row(cam.camera3d.layers, ci)) != 0) \
        & (distr >= q.mesh3d.lod_near) & (distr < q.mesh3d.lod_far)
    return SimpleNamespace(has_cam=has_cam, translation=t, rotation=r,
                           fov=fov, near=near, viewport=viewport,
                           aspect=aspect, view=view, vp=vp, distr=distr,
                           visrow=visrow)


def _views(q, cam, plugin, width, height):
    """The pass's cameras in ascending `order` (ref: the camera driver's
    sorted_camera_index_for_target): their count is structural (the
    plugin's `_num_cameras`, read at prepare); one camera is the first
    alive row."""
    n = 1 if plugin is None else plugin._num_cameras
    use_vp = plugin is not None and plugin._use_viewports
    if n > 1:
        ids, valid = select_cameras(cam.camera3d.order, cam.mask, n)
        picks = [(ids[k], valid[k]) for k in range(n)]
    else:
        picks = [pick_camera(cam.mask)]
    return [_camera_view(q, cam, ci, ok, width, height, use_vp)
            for ci, ok in picks]


def _raster_tiled(fb, depth, table, valid, aabb, light_vec, scissor, stats,
                  *, width, height, tile_h, tile_w, pairs_per_tri,
                  max_per_tile, layout, pair_budget=None):
    """bin_tris + raster_tris (the port of `raster_tris_pallas`): returns
    the new (fb, depth) and adds the binning overflows to `stats`.
    Profiler spans mesh:tri_bin and mesh:tris_B7 or mesh:legacy_B8."""
    with span("mesh:tri_bin"):
        pair_tri, starts, counts, st = bin_tris(
            valid, aabb, height, width, tile_h=tile_h, tile_w=tile_w,
            pairs_per_tri=pairs_per_tri, max_per_tile=max_per_tile,
            pair_budget=pair_budget)
    with span("mesh:tris_B7" if layout == "corners" else "mesh:legacy_B8"):
        fb, depth = raster_tris(fb, depth, table, pair_tri, starts, counts,
                                light_vec, scissor, tile_h=tile_h,
                                tile_w=tile_w, layout=layout)
    stats.pair_overflow = stats.pair_overflow + st["pair_overflow"]
    stats.tile_overflow = stats.tile_overflow + st["tile_overflow"]
    return fb, depth


def _near_clip(cc, cn, valid, eps=1e-3):
    """Near-plane clipping at w = eps (ref: the hardware clipper wgpu
    relies on). cc (T,3,4) clip-space corners, cn (T,3,3) corner normals.
    Returns doubled arrays (2T, …): slot i the (possibly clipped)
    triangle, slot T+i the second triangle of a 1-behind quad split
    (invalid otherwise). Cyclic rotations keep the winding; the rotation
    is the reference's one-hot select (products by 1.0 and 0.0)."""
    behind = cc[..., 3] < eps
    nb = behind.to(torch.int32).sum(1)

    def rot(arr, k):
        return torch.roll(arr, -k, dims=1)

    # rotate so the single behind vertex (nb == 1) or the single front
    # vertex (nb == 2, rotated to slot 2) lands canonically
    b0, b1 = behind[:, 0], behind[:, 1]
    k1 = torch.where(b0, 0, torch.where(b1, 1, 2))     # behind-first
    k2 = torch.where(~b0, 1, torch.where(~b1, 2, 0))   # front-last
    k = torch.where(nb == 1, k1, torch.where(nb == 2, k2, 0))
    sel = torch.nn.functional.one_hot(k.long(), 3).to(cc.dtype)

    def select(arr):
        return (sel[:, 0, None, None] * arr +
                sel[:, 1, None, None] * rot(arr, 1) +
                sel[:, 2, None, None] * rot(arr, 2))

    ccr, cnr = select(cc), select(cn)
    a, b, c = ccr[:, 0], ccr[:, 1], ccr[:, 2]
    na, nbn, ncn = cnr[:, 0], cnr[:, 1], cnr[:, 2]

    def lerp_to_plane(p, q, np_, nq):
        d = q[:, 3:4] - p[:, 3:4]
        t = (eps - p[:, 3:4]) / torch.where(torch.abs(d) > 1e-12, d, 1.0)
        t = torch.clamp(t, 0.0, 1.0)
        return p + (q - p) * t, np_ + (nq - np_) * t

    # nb == 1 (A behind): A1 on AB, A2 on AC → (A1,B,C) + (A1,C,A2)
    a1, na1 = lerp_to_plane(a, b, na, nbn)
    a2, na2 = lerp_to_plane(a, c, na, ncn)
    # nb == 2 (A, B behind, C front): A' on AC, B' on BC → (A',B',C)
    ap, nap = lerp_to_plane(a, c, na, ncn)
    bp, nbp = lerp_to_plane(b, c, nbn, ncn)
    is1 = (nb == 1)[:, None, None]
    is2 = (nb == 2)[:, None, None]
    slot1_cc = torch.where(is1, torch.stack([a1, b, c], 1),
                           torch.where(is2, torch.stack([ap, bp, c], 1), ccr))
    slot1_cn = torch.where(is1, torch.stack([na1, nbn, ncn], 1),
                           torch.where(is2, torch.stack([nap, nbp, ncn], 1),
                                       cnr))
    return (torch.cat([slot1_cc, torch.stack([a1, c, a2], 1)]),
            torch.cat([slot1_cn, torch.stack([na1, ncn, na2], 1)]),
            torch.cat([valid & (nb < 3), valid & (nb == 1)]))


def raster_batched_legacy(clip, nrm, triangles, inst_ok, col_i, emi_i,
                          light_vec, target, stats, *, width, height,
                          tile_h, tile_w, pairs_per_tri, max_per_tile,
                          interpret, deferred=False, met_i=None, rgh_i=None,
                          viewport=None):
    """Gather-free raster tail for batched uniform geometry (kernel B8):
    clip (Ni, VC, 4) clip-space positions, nrm (Ni, VC, 3) world normals,
    triangles (TC, 3) static indices, inst_ok (Ni,) bool, per-instance
    colours (Ni, 4) / emissive (Ni, 3) and, for the G-buffer, metallic /
    roughness (Ni,) (defaults 0 and 0.5). Corner extraction (an index
    gather, the reference's one-hot matmul), exact near-plane clipping
    (quad splits use a second table half), plane setup, then B8:
    `deferred=False` composes Lambert + ambient + emissive into
    target.color, `deferred=True` writes G-buffer planes 0:12 of
    target.gbuffer; target.depth either way. viewport: None or the pixel
    rect (x0, y0, x1, y1) NDC maps onto, which also scissors the raster.
    `interpret` is the JAX signature's; the kernel route follows the
    tensors' device. Overflows add to stats.pair_overflow /
    tile_overflow."""
    del interpret
    dev = clip.device
    ni, vc = clip.shape[0], clip.shape[1]
    tri = torch.as_tensor(np.asarray(triangles, np.int64), device=dev)
    tc = tri.shape[0]
    t_half = ni * tc
    with span("mesh:setup_general"):
        quant = torch.cat([clip.movedim(-1, 1), nrm.movedim(-1, 1)], 1)
        corners = quant[:, :, tri.reshape(-1)].reshape(ni, 7, tc, 3)
        cc = corners[:, 0:4].movedim(1, -1).reshape(t_half, 3, 4)
        cn = corners[:, 4:7].movedim(1, -1).reshape(t_half, 3, 3)
        valid0 = inst_ok[:, None].expand(ni, tc).reshape(t_half)
        cc, cn, valid = _near_clip(cc, cn, valid0)
        inv_w = 1.0 / torch.clamp(cc[..., 3], min=1e-6)
        scissor = viewport
        if viewport is None:
            viewport = (0.0, 0.0, float(width), float(height))
        vx0, vy0, vx1, vy1 = viewport
        sx = vx0 + (cc[..., 0] * inv_w * 0.5 + 0.5) * (vx1 - vx0)
        sy = vy0 + (0.5 - cc[..., 1] * inv_w * 0.5) * (vy1 - vy0)
        cxy = torch.stack([sx, sy], -1)                 # (2T, 3, 2)
        ax, ay = cxy[:, 0, 0], cxy[:, 0, 1]
        bx, by = cxy[:, 1, 0], cxy[:, 1, 1]
        cx2, cy2 = cxy[:, 2, 0], cxy[:, 2, 1]
        area2 = (bx - ax) * (cy2 - ay) - (by - ay) * (cx2 - ax)
        valid = valid & (area2 < -1e-12)
        aabb = torch.stack([torch.amin(sx, 1), torch.amin(sy, 1),
                            torch.amax(sx, 1), torch.amax(sy, 1)], 1)

        def per_tri(x, default):     # (Ni, …) → (2T, …), or the default
            if x is None:
                return torch.full((2 * t_half,), default, device=dev)
            x = x[:, None].expand((ni, tc) + x.shape[1:])
            return x.reshape((t_half,) + x.shape[2:]).repeat(
                (2,) + (1,) * (x.dim() - 2))

        table = pack_tri_planes(cxy, cc[..., 2] * inv_w, inv_w, area2, valid,
                                cn, per_tri(col_i, None),
                                per_tri(emi_i, None), per_tri(met_i, 0.0),
                                per_tri(rgh_i, 0.5))
    # the pair budget follows the realistic pair rate (about half the
    # triangles are back-facing and most touch one tile), not the worst
    # case; overflow is counted in render_stats, as in the reference
    hp_t = (height + tile_h - 1) // tile_h
    wp_t = (width + tile_w - 1) // tile_w
    budget = int(t_half * min(pairs_per_tri, 2) * 0.4) + hp_t * wp_t + 8192
    fb, target.depth = _raster_tiled(
        target.gbuffer if deferred else target.color, target.depth, table,
        valid, aabb, light_vec, scissor, stats, width=width, height=height,
        tile_h=tile_h, tile_w=tile_w, pairs_per_tri=pairs_per_tri,
        max_per_tile=max_per_tile,
        layout="planes_gbuf" if deferred else "planes", pair_budget=budget)
    if deferred:
        target.gbuffer = fb
    else:
        target.color = fb


ROUTE_OF_BACKEND = {"auto": GROUP_ROUTE, "pallas": GROUP_ROUTE,
                    "pallas_interpret": GROUP_ROUTE, "xla": GENERAL_ROUTE}


def make_mesh_pass(width, height, plugin=None, tile_h=32, tile_w=128,
                   pairs_per_tri=2, max_per_tile=256, backend="auto",
                   win_h=32, window_budget=65536, eval_tris=None,
                   visible_budget=65536, cull_budget=None, deferred=False,
                   parallax_layers=8, occlusion_cull=False,
                   phase_budget=16384, material_fn=None):
    """The mesh pass system. plugin=None, or a plugin with backend="xla",
    builds the general route's pass (B7); any other backend the group
    route's (B1/B2, or B6 when sharded). See the module docstring. The
    general route ignores occlusion_cull, phase_budget and material_fn,
    as the JAX package's general branch does."""
    if backend not in ROUTE_OF_BACKEND:
        raise ValueError(f"make_mesh_pass: unknown backend {backend!r}")
    if plugin is None or ROUTE_OF_BACKEND[backend] == GENERAL_ROUTE:
        if deferred:
            raise RuntimeError("deferred lighting requires the pallas "
                               "backend")
        return _general_pass(width, height, plugin, tile_h=tile_h,
                             tile_w=tile_w, pairs_per_tri=pairs_per_tri,
                             max_per_tile=max_per_tile)
    return _group_pass(width, height, plugin, tile_h=tile_h, tile_w=tile_w,
                       max_per_tile=max_per_tile, win_h=win_h,
                       window_budget=window_budget, eval_tris=eval_tris,
                       visible_budget=visible_budget,
                       cull_budget=cull_budget, deferred=deferred,
                       parallax_layers=parallax_layers,
                       occlusion_cull=occlusion_cull,
                       phase_budget=phase_budget, material_fn=material_fn)


def _general_pass(width, height, plugin, *, tile_h, tile_w, pairs_per_tri,
                  max_per_tile):
    """JAX's general mesh branch (mesh3d.py:1465-1569) on B7, one pass a
    camera (a viewport maps and scissors it). Profiler spans
    mesh:setup_general, mesh:tri_bin, mesh:tris_B7."""
    from bevy_tpu_torch.transform import GlobalTransform

    @system(name="mesh_pass")
    def mesh_pass(q=Query(Read(Mesh3d), Read(MeshMaterial),
                          Read(GlobalTransform)),
                  cam=Query(Read(Camera3d), Read(GlobalTransform)),
                  light=Query(Read(DirectionalLight), Read(GlobalTransform)),
                  amb=Res(AmbientLight),
                  pool=Res(MeshPool.RESOURCE),
                  exp=Res(EXPANSION),
                  target=ResMut(RenderTarget.RESOURCE),
                  stats=ResMut("render_stats")):
        if plugin is not None and plugin._motion_vectors:
            # the JAX general branch writes no vector: every pixel falls
            # back to camera reprojection
            target.motion = torch.zeros_like(target.motion)
        lv = directional_light_vec(light, amb)
        gt = q.global_transform
        uni = plugin._uniform if plugin is not None else None
        for view in _views(q, cam, plugin, width, height):
            with span("mesh:setup_general"):
                vp = view.vp
                if uni is not None:
                    # uniform sub-branch: all instances share one mesh, so
                    # the vertex stage is (Ni,4,4) @ (VC,4) batched matmuls
                    rows = uni["rows"]
                    mats = trs_to_mat4(TRS(translation=gt.translation[rows],
                                           rotation=gt.rotation[rows],
                                           scale=gt.scale[rows]))
                    mvp = torch.einsum("ij,njk->nik", vp, mats)
                    clip = torch.einsum("nij,vj->nvi", mvp, uni["ph"]) \
                        .reshape(-1, 4)
                    nrm = quat_rotate_vec3(gt.rotation[rows][:, None, :],
                                           uni["normals"][None]) \
                        .reshape(-1, 3)
                    tri_verts, tri_rows = uni["tri_verts"], uni["tri_rows"]
                else:
                    # expanded sub-branch: per-vertex gathers (mixed meshes)
                    mats = trs_to_mat4(TRS(translation=gt.translation,
                                           rotation=gt.rotation,
                                           scale=gt.scale))
                    mvp = torch.einsum("ij,njk->nik", vp, mats)
                    vi = exp.vert_inst.long()
                    vpool = exp.vert_pool.long()
                    pos = pool.positions[vpool]
                    ph = torch.cat([pos, torch.ones_like(pos[:, :1])], 1)
                    clip = torch.einsum("vij,vj->vi", mvp[vi], ph)
                    # world-space normals (uniform-scale assumption, as in
                    # the reference)
                    nrm = quat_rotate_vec3(gt.rotation[vi],
                                           pool.normals[vpool])
                    tri_verts, tri_rows = exp.tri_verts.long(), \
                        exp.tri_inst.long()
                tri_active = q.mask[tri_rows] & view.visrow[tri_rows] & \
                    view.has_cam
                # near-plane clip before setup (the reference clipper's
                # role)
                clip_c, corner_n, tri_active, src = clip_near_corners(
                    clip[tri_verts], nrm[tri_verts], tri_active)
                src_rows = tri_rows[src.long()]
                setup = triangle_setup_corners(clip_c, tri_active, width,
                                               height,
                                               viewport=view.viewport)
                table = pack_tri_table(setup, corner_n,
                                       q.mesh_material.base_color[src_rows],
                                       q.mesh_material.emissive[src_rows])
            target.color, target.depth = _raster_tiled(
                target.color, target.depth, table, setup["valid"],
                setup["aabb"], lv, view.viewport, stats, width=width,
                height=height, tile_h=tile_h, tile_w=tile_w,
                pairs_per_tri=pairs_per_tri, max_per_tile=max_per_tile,
                layout="corners")

    return mesh_pass


def camera_ray_planes(fov, rotation, width, height, viewport=None,
                      aspect=None):
    """(3, 3) pixel-ray planes of a perspective camera: the world direction
    through absolute pixel (px, py) is ray[0] + px * ray[1] + py * ray[2]
    (it looks down -z in view space). fov and rotation are the camera's
    (device tensors); with a viewport (the (4,) pixel rect) and its
    aspect, the rays span that rect, as the JAX package's."""
    tf_r = torch.tan(fov * 0.5)
    zero = torch.zeros_like(tf_r)
    if viewport is None:
        ta_r = tf_r * (width / height)
        a_v = torch.stack([-ta_r, tf_r, -torch.ones_like(tf_r)])
        b_v = torch.stack([2.0 * ta_r / width, zero, zero])
        c_v = torch.stack([zero, -2.0 * tf_r / height, zero])
    else:
        ta_r = tf_r * aspect
        rvw = viewport[2] - viewport[0]
        rvh = viewport[3] - viewport[1]
        a_v = torch.stack([ta_r * (-2.0 * viewport[0] / rvw - 1.0),
                           tf_r * (1.0 + 2.0 * viewport[1] / rvh),
                           -torch.ones_like(tf_r)])
        b_v = torch.stack([2.0 * ta_r / rvw, zero, zero])
        c_v = torch.stack([zero, -2.0 * tf_r / rvh, zero])
    return torch.stack([quat_rotate_vec3(rotation, a_v),
                        quat_rotate_vec3(rotation, b_v),
                        quat_rotate_vec3(rotation, c_v)])


def _group_pass(width, height, plugin, *, tile_h, tile_w, max_per_tile,
                win_h, window_budget, eval_tris, visible_budget, cull_budget,
                deferred, parallax_layers, occlusion_cull, phase_budget,
                material_fn):
    """The group route's pass (uniform batches on B1/B2, B6 sharded): per
    camera, each group's opaque rows (per LOD level), then the
    transparent phase."""
    from bevy_tpu_torch.transform import GlobalTransform

    @system(name="mesh_pass")
    def mesh_pass(q=Query(Read(Mesh3d), Read(MeshMaterial),
                          Read(GlobalTransform)),
                  cam=Query(Read(Camera3d), Read(GlobalTransform)),
                  light=Query(Read(DirectionalLight), Read(GlobalTransform)),
                  amb=Res(AmbientLight),
                  matlas=Res(MESH_ATLAS),
                  target=ResMut(RenderTarget.RESOURCE),
                  mot=ResMut(MESH_MOTION),
                  vism=ResMut(MESH_VIS),
                  stats=ResMut("render_stats")):
        use_motion = plugin._motion_vectors
        if use_motion:
            # only the pixels won this frame carry a vector
            target.motion = torch.zeros_like(target.motion)
        lv = directional_light_vec(light, amb)
        mm = q.mesh_material
        spec = plugin._spec
        textured = plugin.atlas is not None

        def draw(gi, li, grp, batch, view, ray, motion):
            """One draw item: group gi's opaque rows at LOD level li."""
            rows = grp["rows_o"]
            visrow = view.visrow
            chain = grp.get("chain")
            if chain is not None:
                with span("mesh:lod"):
                    lvl = select_lod(view.distr, chain["errors"], view.fov,
                                     height, chain["threshold_px"])
                    visrow = visrow & (lvl == li)
            # two-phase occlusion: a persistent mask a (group, camera)
            vkey = f"g{gi}v{view.index}" if chain is None else \
                f"g{gi}l{li}v{view.index}"
            vs = {"mask": getattr(vism, vkey)} \
                if occlusion_cull and hasattr(vism, vkey) else None
            gt_t = q.global_transform.translation[rows]
            gt_r = q.global_transform.rotation[rows]
            gt_s = q.global_transform.scale[rows]
            inst_ok = q.mask[rows] & visrow[rows]
            if cull_budget is not None and vs is None and \
                    grp["n_o"] > cull_budget:
                with span("mesh:cull"):
                    ids, nvis = _frustum_cull(
                        batch, gt_t, gt_r, gt_s, inst_ok, view.view,
                        view.fov, view.near, view.aspect, cull_budget)
                stats.pair_overflow = stats.pair_overflow + \
                    torch.clamp(nvis - cull_budget, min=0)
                rows = rows[ids]
                gt_t, gt_r, gt_s = gt_t[ids], gt_r[ids], gt_s[ids]
                inst_ok = torch.arange(cull_budget, device=rows.device) < nvis
            inst_ok = inst_ok & view.has_cam
            with span("mesh:vertex"):
                mats = trs_to_mat4(TRS(translation=gt_t, rotation=gt_r,
                                       scale=gt_s))
                mvp = torch.einsum("ij,njk->nik", view.vp, mats)
                clip = torch.einsum("nij,vj->nvi", mvp, batch["ph"])
                nrm = quat_rotate_vec3(gt_r[:, None, :],
                                       batch["normals"][None])
            flat = batch["flat"] and not textured
            cols = [mm.base_color[rows], mm.emissive[rows],
                    mm.metallic[rows][:, None],
                    mm.perceptual_roughness[rows][:, None]]
            if deferred or not flat or material_fn is not None:
                cols += [getattr(mm, f)[rows][:, None] for f in (
                    "clearcoat", "clearcoat_roughness",
                    "anisotropy_strength", "anisotropy_rotation",
                    "parallax_depth_scale", "reflectance")]
                if deferred and target.gbuffer.shape[0] >= 22:
                    # the tint planes 19:22, where DeferredLightingPlugin
                    # made room for them (the forward resolve, as the JAX
                    # package's, reads no tint)
                    cols.append(mm.specular_tint[rows])
            if plugin.shard_mesh is not None and flat and not deferred \
                    and vs is None and view.viewport is None \
                    and material_fn is None:
                # multi-device: the flat-forward group rasters sharded over
                # instances (the padding instances are invalid); as in the
                # JAX package, occlusion, viewport and material_fn groups
                # draw unsharded
                shm = plugin.shard_mesh
                padn = (-clip.shape[0]) % shm.size
                clip, nrm, inst_ok, mat9 = (
                    torch.cat([x, x.new_zeros((padn,) + x.shape[1:])])
                    for x in (clip, nrm, inst_ok, torch.cat(cols, 1)))
                target.color, target.depth, ovf, nfb = \
                    par_raster.sharded_instance_raster(
                        shm, clip, nrm, batch["tris"], inst_ok, mat9, lv,
                        target.color, target.depth, width=width,
                        height=height, win_h=win_h,
                        window_budget=max(window_budget // shm.size, 1024),
                        eval_tris=eval_tris)
                stats.pair_overflow = stats.pair_overflow + ovf
                stats.fallback_clusters = stats.fallback_clusters + nfb
                return
            # the cluster-DAG cut and the BVH cull gate clusters upstream
            # of the raster (cl_extra)
            cl_extra = None
            dag = batch.get("dag")
            if dag is not None:
                with span("mesh:dag_cut"):
                    smax = torch.amax(gt_s, -1, keepdim=True)
                    cam_local = quat_rotate_vec3(
                        quat_conjugate(gt_r), view.translation[None] - gt_t) \
                        / torch.clamp(smax, min=1e-8)
                    cl_extra = select_dag_cut(cam_local, dag["info"],
                                              view.fov, height,
                                              dag["threshold_px"])
            if "bvh" in batch:
                with span("mesh:bvh"):
                    levels, order = batch["bvh"]
                    ok = bvh_cull(levels, order, mvp,
                                  batch["tris"].shape[0] // 12)
                cl_extra = ok if cl_extra is None else cl_extra & ok
            tex = {}
            if textured:
                def rect(c, _rows=rows):
                    return torch.cat([getattr(mm, f"{c}_min")[_rows],
                                      getattr(mm, f"{c}_max")[_rows]], 1)

                tex = dict(
                    corner_uv=batch["cuv"], uvr_i=rect("uv"),
                    nmr_i=rect("nm"), lmr_i=rect("lm"), dmr_i=rect("dm"),
                    # mesh-space triangle tangents turn with the instance
                    tan_i=quat_rotate_vec3(gt_r[:, None, :],
                                           batch["tan"][None]),
                    atlas=matlas.data, ray=ray,
                    parallax_layers=parallax_layers if spec["pom"] else 0,
                    **{f"{key}_i": rect(c) if spec[key] else None
                       for key, c in _CHANNEL_RECTS})
            elif deferred and spec["aniso"] and not batch["flat"]:
                # anisotropy needs the tangent frame without textures too
                # (the shade records carry it; flat meshes shade isotropic)
                tex = dict(tan_i=quat_rotate_vec3(gt_r[:, None, :],
                                                  batch["tan"][None]))
            if use_motion:
                motion["motd_i"] = motion_delta(
                    mot.t[rows], mot.r[rows], mot.s[rows], gt_t, gt_r, gt_s)
            raster_batched(
                clip, nrm, batch, inst_ok, torch.cat(cols, 1), lv, target,
                stats, width=width, height=height, tile_h=tile_h,
                tile_w=tile_w, max_per_tile=max_per_tile, win_h=win_h,
                window_budget=window_budget, eval_tris=eval_tris,
                visible_budget=visible_budget, deferred=deferred,
                flat_ok=batch["flat"],
                uvt_i=mm.uv_transform[rows] if spec["uvt"] else None,
                viewport=view.viewport, vis_state=vs,
                phase_budget=phase_budget, material_fn=material_fn,
                bias_i=mm.depth_bias[rows] if spec["bias"] else None,
                cl_extra=cl_extra,
                tri_mask=None if dag is None else dag["tri_mask"],
                **tex, **motion)
            if vs is not None:
                setattr(vism, vkey, vs["mask"])

        def transparent(view):
            """The transparent phase: weighted-blended OIT over the opaque
            result (forward only; ref: Transparent3d + oit/)."""
            with span("mesh:oit"):
                oit = torch.cat([target.color.new_zeros((4, height, width)),
                                 target.color.new_ones((1, height, width))])
                for grp in plugin._groups:
                    if not grp["n_t"]:
                        continue
                    rows = grp["rows_t"]
                    gt_r = q.global_transform.rotation[rows]
                    mats = trs_to_mat4(TRS(
                        translation=q.global_transform.translation[rows],
                        rotation=gt_r, scale=q.global_transform.scale[rows]))
                    mvp = torch.einsum("ij,njk->nik", view.vp, mats)
                    clip = torch.einsum("nij,vj->nvi", mvp, grp["ph"])
                    nrm = quat_rotate_vec3(gt_r[:, None, :],
                                           grp["normals"][None])
                    oit, ovf = raster_transparent(
                        clip, nrm, grp,
                        q.mask[rows] & view.has_cam & view.visrow[rows],
                        mm.base_color[rows], mm.emissive[rows], lv,
                        target.depth, oit, width=width, height=height,
                        win_h=win_h, viewport=view.viewport)
                    stats.pair_overflow = stats.pair_overflow + ovf
                target.color = oit_blend(target.color, oit)

        any_t = any(g["n_t"] for g in plugin._groups)
        for vi, view in enumerate(_views(q, cam, plugin, width, height)):
            view.index = vi
            motion = dict(prev_vp=mot.vp, cur_inv_vp=torch.linalg.inv_ex(
                view.vp).inverse) if use_motion else {}
            ray = camera_ray_planes(view.fov, view.rotation, width, height,
                                    view.viewport, view.aspect) \
                if spec["pom"] else None
            for gi, grp in enumerate(plugin._groups):
                if not grp["n_o"]:
                    continue
                for li, batch in enumerate(grp.get("lods") or [grp]):
                    draw(gi, li, grp, batch, view, ray, motion)
            if any_t and not deferred:
                transparent(view)
        if use_motion:
            # this frame's transforms and the primary camera's VP for the
            # next frame's deltas (ref: bevy_pbr's previous_transform)
            gt = q.global_transform
            mot.t = gt.translation.clone()
            mot.r = gt.rotation.clone()
            mot.s = gt.scale.clone()
            # (as the JAX package's: the first alive camera, full target)
            mot.vp = _camera_view(q, cam, *pick_camera(cam.mask), width,
                                  height, False).vp \
                if plugin._use_viewports else view.vp

    return mesh_pass


def raster_transparent(clip, nrm, batch, inst_ok, col_i, emi_i, light_vec,
                       depth, oit, *, width, height, win_h=32,
                       window_budget=8192, visible_budget=8192,
                       cluster_size=12, viewport=None, chunk=1024):
    """Weighted-blended OIT pass of one uniform batch's transparent
    instances (ref: the Transparent3d phase + bevy_core_pipeline/src/oit;
    order independent, so no per-pixel sort). Flat per-triangle Lambert
    (the first corner's normal); fragments test against, and never write,
    the opaque `depth`. Plain PyTorch (the JAX package's is XLA): the
    visible clusters compacted to visible_budget, windows as the opaque
    pass's, evaluated and merged `chunk` windows at a time
    (eval_oit_windows, accumulate_oit). Returns (oit (5, H, W), the
    dropped clusters and windows as a 0-d count).

    The window budget is min(window_budget, MAX_BLOCKS * k + 64), every
    window the clusters can take, where the JAX package's 4 k + 64 may
    drop the windows of large clusters (ROADMAP C3, as the opaque
    pass's); clusters of more than MAX_BLOCKS blocks are not drawn, as
    in the JAX package."""
    cs = cluster_size
    dev = clip.device
    ni = clip.shape[0]
    tri_idx = batch["tris"]
    cc_num = tri_idx.shape[0] // cs
    n_cl = ni * cc_num
    cc = clip[:, tri_idx].reshape(n_cl, cs, 3, 4)
    cn = nrm[:, tri_idx].reshape(n_cl, cs, 3, 3)
    cl_ok = inst_ok[:, None].expand(ni, cc_num).reshape(n_cl)
    aabb, cl_valid, _ = cluster_screen_aabbs(
        cc, cl_ok, torch.ones(n_cl * cs, dtype=torch.bool, device=dev), cs,
        width, height, viewport=viewport)
    k = min(visible_budget, n_cl)
    nvalid = torch.sum(cl_valid.to(torch.int32))
    pos = torch.cumsum(cl_valid.to(torch.int32), 0) - 1
    tgt = torch.where(cl_valid & (pos < k), pos, k)
    ids = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    ids[tgt.long()] = torch.arange(n_cl, device=dev)
    ids = ids[:k]
    v = torch.arange(k, device=dev) < nvalid
    overflow = torch.clamp(nvalid - k, min=0)
    mat = torch.cat([col_i, emi_i, col_i.new_zeros((ni, 2))], 1)
    mat_tri = mat[ids // cc_num][:, None, :].expand(k, cs, 9)
    cn_v = cn[ids]
    zrec, valid = pack_planes_h(cc[ids], cn_v, v[:, None].expand(k, cs),
                                width, height, viewport=viewport)
    frec = pack_flat_shade(cn_v, mat_tri, light_vec, valid)
    zrec, frec = zrec.reshape(k * cs, ZREC), frec.reshape(k * cs, 8)
    wb = (min(window_budget, MAX_BLOCKS * k + 64) + 7) // 8 * 8
    wins = build_windows(aabb[ids], v, win_h=win_h, width=width,
                         height=height, budget=wb, max_blocks=MAX_BLOCKS)
    for start in range(0, wb, chunk):
        part = [wins[key][start:start + chunk]
                for key in ("owner", "meta", "wvalid")]
        oit = accumulate_oit(oit, eval_oit_windows(
            zrec, frec, cs, *part, depth, win_h=win_h), part[1], part[2])
    return oit, overflow + wins["overflow"]


def extended_material(extension_fn):
    """ExtendedMaterial twin (ref: bevy_pbr/src/extended_material.rs:
    `ExtendedMaterial<StandardMaterial, E>` runs the standard fragment
    logic, then the extension's). Returns a `material_fn` for
    `Mesh3dPlugin(material_fn=...)`: the standard forward shade
    (resolve_forward's directional + ambient + emissive) first, then
    `extension_fn(base_rgba, n, mat, ok, light_vec)`. A pass-through
    extension reproduces the standard material."""

    def fn(n, mat, ok, light_vec):
        lam = torch.clamp(-(n[..., 0] * light_vec[0] +
                            n[..., 1] * light_vec[1] +
                            n[..., 2] * light_vec[2]), min=0.0)
        rgb = mat[..., 0:3] * (light_vec[6:9] +
                               light_vec[3:6] * lam[..., None]) + \
            mat[..., 4:7]
        return extension_fn(torch.cat([rgb, mat[..., 3:4]], -1), n, mat, ok,
                            light_vec)

    return fn


class Mesh3dPlugin(Plugin):
    """ref: MeshPlugin + PbrPlugin's pipeline half. Owns the MeshPool;
    add meshes with `add_mesh` (LOD chains: `lods`) or `add_mesh_dag`
    before the first frame.

    backend: "xla" takes the general route (B7); "auto", "pallas" and
    "pallas_interpret" the group route (B1/B2), whose kernels follow the
    tensors' device either way (see the module docstring). pairs_per_tri
    sizes the general route's pair budget (T * pairs_per_tri + tiles);
    the group route does not read it.

    shards: None, a device count (the first that many CUDA cards) or a
    ShardMesh: flat-forward groups then raster over those devices
    (parallel/raster.py). Clusters too large for windows are then counted
    into pair_overflow and fallback_clusters, not drawn, as in the JAX
    package. A deferred pass, any group the shade records draw, and
    viewport, occlusion and material_fn groups stay on one device, as in
    the JAX package; the general route takes no shards.

    atlas: None, an AtlasBuilder (built onto the world's device at
    prepare) or an (AH, AW, 4) tensor of the material textures, which
    MeshMaterial's *_min / *_max rects index (ref: the bindless material
    texture arrays of material_bind_groups.rs). With an atlas every group
    of the group route takes the shade records; smooth meshes take them
    without one. parallax_layers: the depth layers of the parallax
    occlusion march, for materials with a depth-map rect and a
    parallax_depth_scale above 0. The general route reads neither, as the
    JAX package's general branch.

    The group route's options (see the module docstring and
    raster_batched): visible_budget (clusters a frame, compacted below
    the cluster count), occlusion_cull with phase_budget (clusters a
    phase), material_fn (a custom material, or extended_material),
    bvh_cull, cull_budget (the instance frustum cull), motion_vectors
    (per-object motion vectors into the target's "motion" planes)."""

    def __init__(self, pool: MeshPool = None, tile_h=32, tile_w=128,
                 pairs_per_tri=2, max_per_tile=256, backend="auto",
                 deferred=False, win_h=32, window_budget=65536,
                 eval_tris=None, atlas=None, visible_budget=65536,
                 occlusion_cull=False, phase_budget=16384, material_fn=None,
                 cull_budget=None, shards=None, parallax_layers=8,
                 bvh_cull=False, motion_vectors=False):
        if backend not in ROUTE_OF_BACKEND:
            raise ValueError(f"Mesh3dPlugin: unknown backend {backend!r}")
        self.route = ROUTE_OF_BACKEND[backend]
        if shards is not None and self.route == GENERAL_ROUTE:
            raise ValueError("Mesh3dPlugin: shards need the group route "
                             "(backend 'auto' or 'pallas'), not 'xla'")
        # deferred=True writes the G-buffer that DeferredLightingPlugin
        # creates and shades (the group route only, as in JAX)
        self.pool = pool or MeshPool()
        self.atlas = atlas
        self._motion_vectors = bool(motion_vectors)
        self._bvh_cull = bool(bvh_cull)
        self._lod_chains = {}      # mesh id -> {ids, errors, threshold_px}
        self._dags = {}            # mesh id -> {info, threshold_px}
        self._groups = None
        self._uniform = None
        self._spec = None
        self._num_cameras = 1
        self._use_viewports = False
        self.shard_mesh = as_mesh(shards)
        self.cfg = dict(tile_h=tile_h, tile_w=tile_w,
                        pairs_per_tri=pairs_per_tri,
                        max_per_tile=max_per_tile, backend=backend,
                        win_h=win_h, window_budget=window_budget,
                        eval_tris=eval_tris, visible_budget=visible_budget,
                        cull_budget=cull_budget, deferred=deferred,
                        parallax_layers=parallax_layers,
                        occlusion_cull=occlusion_cull,
                        phase_budget=phase_budget, material_fn=material_fn)

    def add_mesh(self, mesh, lods: int = 1, lod_ratio: float = 0.35,
                 lod_threshold_px: float = 1.0) -> int:
        """Register a mesh. lods > 1 builds a QEM-simplified LOD chain
        (render/meshlet.py; ref: bevy_pbr/src/meshlet/from_mesh.rs): the
        group route then draws each instance at the coarsest level whose
        projected error stays under lod_threshold_px, a frame, a
        camera."""
        mid = self.pool.add(mesh)
        if lods > 1:
            meshes, errors = build_lod_chain(mesh, levels=lods,
                                             ratio=lod_ratio)
            ids = [mid] + [self.pool.add(m) for m in meshes[1:]]
            self._lod_chains[mid] = {"ids": ids, "errors": errors,
                                     "threshold_px": lod_threshold_px}
        return mid

    def add_mesh_dag(self, mesh, threshold_px: float = 1.0,
                     group_size: int = 4, max_levels: int = 16) -> int:
        """Register a dense mesh with cluster-DAG LOD (ref:
        bevy_pbr/src/meshlet/from_mesh.rs): the registered mesh holds every
        DAG level's clusters (about twice the source triangles); the
        group route draws, per instance, the mixed-level cut whose
        projected group errors bracket threshold_px."""
        dag_mesh, info = build_cluster_dag(mesh, cs=12, group_size=group_size,
                                           max_levels=max_levels)
        mid = self.pool.add(dag_mesh)
        self._dags[mid] = {"info": info, "threshold_px": threshold_px}
        return mid

    def build(self, app):
        from bevy_tpu_torch.render.plugin import RenderPlugin
        from bevy_tpu_torch.transform import GlobalTransform, Transform
        rp = next((p for p in app._plugins if isinstance(p, RenderPlugin)),
                  None)
        if rp is None:
            raise RuntimeError("Mesh3dPlugin requires RenderPlugin")
        for c in (Mesh3d, MeshMaterial, DirectionalLight, Camera3d,
                  Transform, GlobalTransform):
            app.world.register_component(c)
        app.init_resource(AmbientLight())
        add_render_stats(app, "pair_overflow", "tile_overflow",
                         "fallback_clusters")
        plugin = self

        def finish_pool(world):
            a = plugin.atlas
            if a is None:
                data = torch.zeros((1, 1, 4), device=world.device)
            elif hasattr(a, "build"):
                data = a.build(world.device)
            else:
                data = torch.as_tensor(a, dtype=torch.float32,
                                       device=world.device)
            world.state["res"][MESH_ATLAS] = {"data": data}
            _rebuild_expansion(world, plugin)
            res, dev = world.state["res"], world.device
            # the occlusion masks start all visible (frame 1 draws
            # everything; later frames converge to the visible set), one
            # a (group, camera), as the JAX package's
            vis = {}
            if plugin.cfg["occlusion_cull"] and plugin.route == GROUP_ROUTE:
                for gi, grp in enumerate(plugin._groups):
                    n_cl = max(1, grp["n_o"]) * (grp["tris"].shape[0] // 12)
                    for v in range(plugin._num_cameras):
                        vis[f"g{gi}v{v}"] = torch.ones(
                            n_cl, dtype=torch.bool, device=dev)
            res[MESH_VIS] = vis
            # the motion state restarts on a structural change, as the JAX
            # package's (the current transforms, an identity VP)
            if plugin._motion_vectors:
                gtf = world.state["comp"]["global_transform"]["f"]
                res[MESH_MOTION] = {
                    "t": gtf["translation"].clone(),
                    "r": gtf["rotation"].clone(),
                    "s": gtf["scale"].clone(),
                    "vp": torch.eye(4, device=dev)}
                res[RenderTarget.RESOURCE]["motion"] = torch.zeros(
                    (3, rp.height, rp.width), device=dev)
            else:
                res[MESH_MOTION] = {"vp": torch.eye(4, device=dev)}

        app.add_prepare_hook(finish_pool)
        app.add_systems(Render, make_mesh_pass(rp.width, rp.height,
                                               plugin=self, **self.cfg),
                        in_set=PASS_SET)
