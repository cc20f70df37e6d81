"""Skinned and morphed mesh rendering (port of bevy_tpu/render/skinned.py;
ref: bevy_pbr's GPU skinning — `src/render/skin.rs:28,176` joint buffers,
the `skinning.wesl` vertex stage — and morph targets,
`src/render/morph.rs`), with animation sampling in the same pass.

Vertex stage per instance n:  A(n,j) = VP · model(n) · global(n,j) · bindpose⁻¹
then per vertex v:            clip(n,v) = [Σ_j W(v,j) A(n,j)] · p(v)
W is the dense (VC, J) weight matrix (the reference's 4-influence
weighted sum, densified). The mesh then rasters through the group
route's `raster_batched` on its shade-record path (B1, then B2 for the
fallback clusters, then the per-pixel forward resolve).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function as span

from bevy_tpu_torch.animation import (
    AnimationPlayer, advance_players, bake_clips, compose_joints,
    sample_pose_blended, skin_matrices,
)
from bevy_tpu_torch.app.main_schedule import Render, Update
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Read, Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.affine import TRS, trs_to_mat4
from bevy_tpu_torch.render.camera import (
    Camera3d, perspective_infinite_reverse, pick_camera, view_matrix,
)
from bevy_tpu_torch.render.mesh3d import (
    AmbientLight, DirectionalLight, MeshMaterial, directional_light_vec,
    raster_batched, uniform_batch,
)
from bevy_tpu_torch.render.plugin import (
    PASS_SET, RenderTarget, add_render_stats,
)


@component
class SkinnedMesh3d:
    """Marker binding an entity to the plugin's skinned mesh (ref:
    SkinnedMesh; one skeleton + mesh per plugin)."""
    skin = field((), torch.int32)


MAX_MORPHS = 8


@component
class MorphWeights:
    """Per-instance morph target weights (ref: bevy_mesh MorphWeights):
    lane k scales the plugin's k-th position-delta target."""
    weights = field(MAX_MORPHS)


ANIM_CLIPS = "anim_clips"     # {"data", "counts", "rates"}: bake_clips


class SkinnedMeshPlugin(Plugin):
    """ref: the Mesh3d + SkinnedMesh + AnimationPlayer stack for one rig.
    `mesh` is a render.mesh.Mesh, `weights` a dense (VC, J) matrix, `clips`
    a list of animation.AnimationClip. With `graph` (an
    animation.graph.AnimationGraph) the entities carry an
    AnimationGraphPlayer instead of an AnimationPlayer. morph_targets:
    (K, VC, 3) position deltas, K <= MAX_MORPHS; entities opt in with a
    MorphWeights component.

    The kernels follow the device of the App's world (there is no
    interpret mode). Profiler spans: skin:sample, skin:joints,
    skin:vertex, then raster_batched's mesh:* spans."""

    def __init__(self, skeleton, mesh, weights, clips, tile_h=32, tile_w=128,
                 max_per_tile=256, graph=None, morph_targets=None):
        self.skeleton = skeleton
        self.mesh = mesh
        self.weights = np.asarray(weights, np.float32)
        self.clips = clips
        self.graph = graph
        self.morph_targets = (None if morph_targets is None else
                              np.asarray(morph_targets, np.float32))
        if self.morph_targets is not None and \
                self.morph_targets.shape[0] > MAX_MORPHS:
            raise ValueError(f"SkinnedMeshPlugin: at most {MAX_MORPHS} morph "
                             f"targets")
        self._rows = None
        self.cfg = dict(tile_h=tile_h, tile_w=tile_w,
                        max_per_tile=max_per_tile)

    @property
    def name(self):
        return f"SkinnedMeshPlugin<{id(self)}>"

    def build(self, app):
        from bevy_tpu_torch.render.plugin import RenderPlugin
        from bevy_tpu_torch.transform import GlobalTransform, Transform
        rp = next((p for p in app._plugins if isinstance(p, RenderPlugin)),
                  None)
        if rp is None:
            raise RuntimeError("SkinnedMeshPlugin requires RenderPlugin")
        for c in (SkinnedMesh3d, AnimationPlayer, MorphWeights, MeshMaterial,
                  DirectionalLight, Camera3d, Transform, GlobalTransform):
            app.world.register_component(c)
        app.init_resource(AmbientLight())
        add_render_stats(app, "pair_overflow", "tile_overflow",
                         "fallback_clusters")
        dev = app.device
        clip_data, counts, rates = bake_clips(self.clips, dev)
        app.insert_resource(ANIM_CLIPS, {
            "data": clip_data, "counts": counts, "rates": rates})
        durations = [c.duration for c in self.clips]
        graph = self.graph
        if graph is not None:
            from bevy_tpu_torch.animation.graph import (
                AnimationGraphPlayer, advance_graph_players)
            app.world.register_component(AnimationGraphPlayer)
            app.add_systems(Update, advance_graph_players(durations, graph))
            anim_comp = AnimationGraphPlayer
        else:
            app.add_systems(Update, advance_players(durations))
            anim_comp = AnimationPlayer

        plugin = self

        def rebuild(world):
            plugin._rows = torch.as_tensor(
                world.query_rows(SkinnedMesh3d).astype(np.int64),
                device=world.device)

        app.add_prepare_hook(rebuild)

        skeleton, mesh = self.skeleton, self.mesh
        # the mesh's static tables on the device, once: no quad pairing
        # (the geometry deforms), and the shade records always (flat_ok
        # is not given, as in the reference's skinned pass)
        batch = uniform_batch(mesh, dev, rigid=False)
        w_dense = torch.as_tensor(self.weights, device=dev)
        mesh_ph = batch["ph"]
        mesh_n = batch["normals"]
        morph_t = (None if self.morph_targets is None
                   else torch.as_tensor(self.morph_targets, device=dev))
        width, height = rp.width, rp.height
        cfg = self.cfg

        @system(name="skinned_pass")
        def skinned_pass(q=Query(Read(SkinnedMesh3d), Read(anim_comp),
                                 Read(MeshMaterial), Read(GlobalTransform)),
                         cam=Query(Read(Camera3d), Read(GlobalTransform)),
                         light=Query(Read(DirectionalLight),
                                     Read(GlobalTransform)),
                         morphs=Query(Read(MorphWeights)),
                         amb=Res(AmbientLight),
                         clips=Res(ANIM_CLIPS),
                         target=ResMut(RenderTarget.RESOURCE),
                         stats=ResMut("render_stats")):
            rows = plugin._rows
            if rows is None or rows.numel() == 0:
                return
            ci, has_cam = pick_camera(cam.mask)
            cam_gt = cam.global_transform
            view = view_matrix(cam_gt.translation[ci], cam_gt.rotation[ci],
                               cam_gt.scale[ci])
            proj = perspective_infinite_reverse(
                cam.camera3d.fov[ci], width / height, cam.camera3d.near[ci])
            vp = proj @ view
            with span("skin:sample"):
                # the graph's blend tree, or the two-clip crossfade
                if graph is not None:
                    local = graph.sample(clips.data, clips.counts,
                                         clips.rates,
                                         q.animation_graph_player, rows)
                else:
                    ap = q.animation_player
                    local = sample_pose_blended(
                        clips.data, clips.counts, clips.rates,
                        {"clip": ap.clip[rows], "time": ap.time[rows],
                         "prev_clip": ap.prev_clip[rows],
                         "prev_time": ap.prev_time[rows],
                         "blend": ap.blend[rows]})
            with span("skin:joints"):
                global_trs = compose_joints(skeleton, local)
                joints = skin_matrices(skeleton, global_trs)  # (Ni,J,4,4)
            with span("skin:vertex"):
                gt = q.global_transform
                model = trs_to_mat4(TRS(translation=gt.translation[rows],
                                        rotation=gt.rotation[rows],
                                        scale=gt.scale[rows]))
                mv = torch.einsum("ij,njk->nik", vp, model)      # (Ni,4,4)
                a = torch.einsum("nab,njbc->njac", mv, joints)
                # per-vertex skin matrices by the dense weight product
                m_v = torch.einsum("vj,njab->nvab", w_dense, a)  # (Ni,VC,4,4)
                if morph_t is not None:
                    # morph displacement before skinning (ref: morph.wesl
                    # runs before the joint deform in the vertex stage)
                    k = morph_t.shape[0]
                    wts = morphs.morph_weights.weights[rows][:, :k]
                    disp = torch.einsum("nk,kvc->nvc", wts, morph_t)
                    ph_n = torch.cat(
                        [mesh_ph[None, :, :3] + disp,
                         torch.ones(disp.shape[:2] + (1,), device=dev)], -1)
                    clip = torch.einsum("nvab,nvb->nva", m_v, ph_n)
                else:
                    clip = torch.einsum("nvab,vb->nva", m_v, mesh_ph)
                # normals through model and joint rotation (the reference's
                # uniform-scale approximation)
                b = torch.einsum("nab,njbc->njac", model, joints)[:, :, :3,
                                                                   :3]
                r_v = torch.einsum("vj,njab->nvab", w_dense, b)
                nrm = torch.einsum("nvab,vb->nva", r_v, mesh_n)
            mm = q.mesh_material
            ni = rows.shape[0]

            def const(v):
                return torch.full((ni, 1), v, device=dev)

            # reference defaults: metallic 0, roughness 0.5, clearcoat 0
            # (roughness 0.5), no anisotropy or parallax, reflectance 0.5
            mat_inst = torch.cat(
                [mm.base_color[rows], mm.emissive[rows], const(0.0),
                 const(0.5), const(0.0), const(0.5), const(0.0), const(0.0),
                 const(0.0), const(0.5)], 1)
            raster_batched(
                clip, nrm, batch, q.mask[rows] & has_cam, mat_inst,
                directional_light_vec(light, amb), target, stats,
                width=width, height=height, **cfg)

        app.add_systems(Render, skinned_pass, in_set=PASS_SET)
