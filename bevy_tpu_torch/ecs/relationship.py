"""Generic relationships (port of bevy_tpu/ecs/relationship.py; ref:
bevy_ecs relationship/ — Relationship / RelationshipTarget, despawn
policies).

A relationship is a component with one `target` entity row and the
target's generation, so a stale link never matches a recycled row. The
reverse lookup is a vectorized compare over the relation column; cleanup
when targets despawn is an ordinary device system over masks.
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ecs.commands import Commands
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Read
from bevy_tpu_torch.ecs.system import system


def relationship(name: str):
    """Declare a relationship component (ref: #[derive(Relationship)]): a
    component class with `target` (entity row) and `target_gen` fields;
    `rel_to(Rel, entity)` makes one."""
    cls = type(name, (), {
        "target": field((), torch.int32, default=-1, entity_ref=True),
        "target_gen": field((), torch.int32, default=-1),
    })
    return component(cls)


def rel_to(rel_cls, entity):
    """A relationship instance pointing at `entity` (ref: ChildOf(entity)):
    an Entity stamps its generation; a raw row leaves it unchecked."""
    if hasattr(entity, "index"):
        return rel_cls(target=int(entity.index),
                       target_gen=int(entity.generation))
    return rel_cls(target=int(entity), target_gen=-1)


def related_mask(state, rel_cls, entity):
    """Device reverse lookup (ref: RelationshipTarget iteration): bool
    (capacity,) mask of live rows whose relation points at `entity`."""
    store = state["comp"][rel_cls.__component_spec__.name]
    row = entity.index if hasattr(entity, "index") else entity
    tgt = store["f"]["target"]
    m = state["ent"]["alive"] & store["has"] & (tgt == row)
    if hasattr(entity, "generation"):
        m = m & ((store["f"]["target_gen"] < 0) |
                 (store["f"]["target_gen"] == state["ent"]["generation"][row]))
    return m


def make_relationship_cleanup_system(rel_cls, policy: str = "remove"):
    """A system removing dangling relations (ref: the relationship
    on_despawn hooks): "remove" drops the relation from orphans,
    "despawn" despawns them (one generation of orphans a frame)."""
    spec = rel_cls.__component_spec__

    @system(name=f"cleanup_{spec.name}_{policy}")
    def cleanup(q=Query(Read(rel_cls)), cmd=Commands()):
        rel = getattr(q, spec.name)
        tgt = torch.clamp(rel.target, 0, q.mask.shape[0] - 1).long()
        alive = q._state["ent"]["alive"][tgt]
        gen_ok = (rel.target_gen < 0) | \
            (rel.target_gen == q._state["ent"]["generation"][tgt])
        dangling = q.mask & ((rel.target < 0) | ~alive | ~gen_ok)
        if policy == "despawn":
            cmd.despawn(dangling)
        else:
            cmd.remove(dangling, rel_cls)

    return cleanup
