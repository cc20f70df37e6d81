"""Entity handles (port of bevy_tpu/ecs/entity.py): a host-side index +
generation; inside the state, entities are int32 row indices."""

from typing import NamedTuple

NULL_ENTITY = -1


class Entity(NamedTuple):
    index: int
    generation: int = 0

    def __repr__(self):
        return f"{self.index}v{self.generation}"
