"""bevy_tpu_torch — the PyTorch + CUDA port of bevy_tpu (same module layout
and public names as `bevy_tpu/`, which stays the reference every part of
this package is checked against).

Frames run eagerly on the device that the App was built with: no jit, no
global default device. `App(...)` and `World(...)` take the CUDA card
unless the caller passes `device="cpu"` (they raise where there is no
card). The raster kernels are hand-written CUDA for Hopper
(`csrc/`), built at first CUDA use (`ops/_cuda.py`); on CPU tensors each
kernel wrapper runs its plain PyTorch version.
"""

import torch

# The clip-space transform is an f32 matmul and the reference is f32:
# never let cuBLAS / cuDNN drop to TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from bevy_tpu_torch.app import App, Plugin  # noqa: E402,F401
from bevy_tpu_torch.app.app import AppExit  # noqa: E402,F401
from bevy_tpu_torch.app.main_schedule import (  # noqa: E402,F401
    First, PreUpdate, StateTransition, RunFixedMainLoop, Update, SpawnScene,
    PostUpdate, Last, Startup, PreStartup, PostStartup, FixedUpdate,
    FixedFirst, FixedPreUpdate, FixedPostUpdate, FixedLast,
)
from bevy_tpu_torch.ecs import (  # noqa: E402,F401
    component, field, resource, World, system, host_system, Schedule, Query,
    QueryBuilder, Read, Res, ResMut, Local, With, Without, Changed, Added,
    Removed, Entity, Commands, message, MessageReader, MessageWriter,
)
from bevy_tpu_torch.ecs.observer import (  # noqa: E402,F401
    LifecycleMask, On, OnAdd, OnInsert, OnRemove, Trigger, event,
)
from bevy_tpu_torch.state import (  # noqa: E402,F401
    CurrentState, NextState, OnEnter, OnExit, add_state, in_state,
)
