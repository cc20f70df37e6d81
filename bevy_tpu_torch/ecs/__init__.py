"""bevy_tpu_torch.ecs — the core runtime (port of bevy_tpu.ecs): global dense
SoA pools on the device, systems as eager functions over them."""

from bevy_tpu_torch.ecs.component import (  # noqa: F401
    component, define_component, field, resource, ComponentSpec,
    ComponentInstance, get_spec,
)
from bevy_tpu_torch.ecs.entity import Entity, NULL_ENTITY  # noqa: F401
from bevy_tpu_torch.ecs.world import Disabled, World  # noqa: F401
from bevy_tpu_torch.ecs.query import (  # noqa: F401
    Added, Changed, Local, Query, QueryBuilder, Read, Removed, Res, ResMut,
    Single, With, Without, pair_combinations,
)
from bevy_tpu_torch.ecs.system import system, host_system, System  # noqa: F401
from bevy_tpu_torch.ecs.commands import Commands  # noqa: F401
from bevy_tpu_torch.ecs.message import (  # noqa: F401
    message, MessageReader, MessageWriter, swap_message_buffers,
)
from bevy_tpu_torch.ecs.schedule import Schedule  # noqa: F401
