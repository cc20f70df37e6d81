"""Carrying a world across from the JAX package.

`state_from_numpy(tree, device)` turns a host copy of a bevy_tpu world
state (`jax.device_get(app.world.state)`: nested dicts of numpy arrays)
into this package's state: the same keys, the same dtypes (bool, int32,
float32), tensors on `device`. Both packages name component pools and
resources alike, so the result holds the same columns and resources.
This module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32}


def state_from_numpy(tree, device):
    """Map nested dicts/lists of numpy arrays (or numpy scalars) to the
    same structure of tensors on `device`; raises on any dtype other than
    bool, int32 or float32."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"state_from_numpy: unsupported dtype {arr.dtype}")
    return torch.tensor(arr, dtype=_DTYPES[arr.dtype], device=device)
