"""Transforms & hierarchy propagation (port of bevy_tpu/transform/__init__.py;
ref: bevy_transform — `src/systems.rs:42-744`).

Propagation is level-synchronous: one gather + compose pass per depth
bucket, as masked whole-column ops. Flat worlds (no ChildOf row) take the
copy-only fast path.
"""

import numpy as np
import torch

from bevy_tpu_torch.app.main_schedule import PostUpdate
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.entity import NULL_ENTITY, Entity
from bevy_tpu_torch.ecs.query import Query, Read
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.affine import TRS, trs_compose


@component
class Transform:
    """Local-space TRS (ref: Transform component)."""
    translation = field(3)
    rotation = field(4, default=(0.0, 0.0, 0.0, 1.0))
    scale = field(3, default=(1.0, 1.0, 1.0))


@component
class GlobalTransform:
    """World-space TRS, written by propagation (ref: GlobalTransform)."""
    translation = field(3)
    rotation = field(4, default=(0.0, 0.0, 0.0, 1.0))
    scale = field(3, default=(1.0, 1.0, 1.0))


@component
class ChildOf:
    """Child→parent link (ref: ChildOf); `depth` is the propagation level
    bucket (1 = child of a root)."""
    parent = field((), torch.int32, default=NULL_ENTITY, entity_ref=True)
    depth = field((), torch.int32, default=0)


def transform_bundle(translation=(0.0, 0.0, 0.0),
                     rotation=(0.0, 0.0, 0.0, 1.0), scale=(1.0, 1.0, 1.0)):
    """Transform + GlobalTransform pair."""
    return [
        Transform(translation=translation, rotation=rotation, scale=scale),
        GlobalTransform(translation=translation, rotation=rotation,
                        scale=scale),
    ]


def set_parent(world, child, parent):
    """Host-tier reparenting: inserts ChildOf with the depth bucket one
    below the parent's (ref: ChildOf insertion + Children bookkeeping)."""
    child_row = child.index if isinstance(child, Entity) else int(child)
    parent_row = parent.index if isinstance(parent, Entity) else int(parent)
    depth = 1
    if world.has(parent_row, ChildOf):
        depth = int(world.get(parent_row, ChildOf).depth) + 1
    world.insert(child_row, ChildOf(parent=parent_row, depth=depth))


def children_of(world, parent) -> list:
    """The rows whose ChildOf points at `parent` (ref: Children, the
    derived inverse relationship); a host read."""
    parent_row = parent.index if isinstance(parent, Entity) else int(parent)
    rows = world.query_rows(ChildOf)
    if len(rows) == 0:
        return []
    parents = world.column(ChildOf, "parent").cpu().numpy()[rows]
    return [int(r) for r in rows[np.flatnonzero(parents == parent_row)]]


def despawn_recursive(world, entity):
    """Despawn an entity and all its descendants (ref: despawn with
    Children cleanup)."""
    for c in children_of(world, entity):
        despawn_recursive(world, c)
    world.despawn(entity)


def make_propagate_system(max_depth: int = 8, world=None):
    """`world` (the owning App's) enables the flat fast path: with no
    ChildOf row, globals are a masked copy of locals."""

    @system(name="propagate_transforms")
    def propagate_transforms(q=Query(Read(Transform), GlobalTransform),
                             rel=Query(Read(ChildOf))):
        lt, lr, ls = (q.transform.translation, q.transform.rotation,
                      q.transform.scale)
        gtv = q.global_transform
        if world is not None and world.component_rows(ChildOf) == 0:
            m = q.mask[:, None]
            gtv.translation = torch.where(m, lt, gtv.translation)
            gtv.rotation = torch.where(m, lr, gtv.rotation)
            gtv.scale = torch.where(m, ls, gtv.scale)
            return
        child_mask = rel.mask
        depth = rel.child_of.depth
        safe_parent = torch.clamp(rel.child_of.parent, 0,
                                  rel.child_of.parent.shape[0] - 1)
        # roots copy local → global (ref: sync_simple_transforms)
        root = (q.mask & ~child_mask)[:, None]
        gt = torch.where(root, lt, gtv.translation)
        gr = torch.where(root, lr, gtv.rotation)
        gs = torch.where(root, ls, gtv.scale)
        # level-synchronous composition (ref: propagate_parent_transforms)
        local = TRS(translation=lt, rotation=lr, scale=ls)
        for d in range(1, max_depth + 1):
            m = (q.mask & child_mask & (depth == d))[:, None]
            comp = trs_compose(TRS(translation=gt[safe_parent],
                                   rotation=gr[safe_parent],
                                   scale=gs[safe_parent]), local)
            gt = torch.where(m, comp["translation"], gt)
            gr = torch.where(m, comp["rotation"], gr)
            gs = torch.where(m, comp["scale"], gs)
        gtv.translation = gt
        gtv.rotation = gr
        gtv.scale = gs

    return propagate_transforms


class TransformPlugin(Plugin):
    """ref: TransformPlugin — registers propagation in PostUpdate."""

    def __init__(self, max_depth: int = 8):
        self.max_depth = max_depth

    def build(self, app):
        for c in (Transform, GlobalTransform, ChildOf):
            app.world.register_component(c)
        app.add_systems(PostUpdate,
                        make_propagate_system(self.max_depth, app.world))
