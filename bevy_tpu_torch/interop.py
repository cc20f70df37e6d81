"""Carrying a world across from the JAX package.

`state_from_numpy(tree, device)` turns a host copy of a bevy_tpu world
state (`jax.device_get(app.world.state)`: nested dicts of numpy arrays)
into this package's state: the same keys, the same dtypes (bool, int32,
float32), tensors on `device`. Both packages name component pools,
resources and messages alike, so the result holds the same columns.
`load_world(world, tree)` installs such a copy into a port World, so both
packages can run on from the same state. This module imports nothing of
JAX.
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


def load_world(world, tree):
    """Install a host copy of a bevy_tpu world state into `world` (a port
    World of the same capacity whose app registered the same components
    and messages): liveness and generations, every column of the
    components `world` registers, every resource both worlds hold (field
    by field: port-only fields such as extra counters stay) and the
    texture atlas, the message buffers of the messages `world` registers,
    the tick and frame counters, and each system's last run, matched by
    system name. The host mirrors are refreshed."""
    cap = np.asarray(tree["ent"]["alive"]).shape[0]
    if cap != world.capacity:
        raise ValueError(f"load_world: capacity {cap} != {world.capacity}")
    dev = world.device
    state = dict(world.state)
    state["ent"] = state_from_numpy(tree["ent"], dev)
    state["comp"] = {name: state_from_numpy(tree["comp"][name], dev)
                     for name in world.state["comp"]}
    res = dict(world.state["res"])
    for name, store in tree["res"].items():
        if name in res or name == "texture_atlas":
            res[name] = dict(res.get(name, {}),
                             **state_from_numpy(store, dev))
    state["res"] = res
    state["msg"] = {name: state_from_numpy(tree["msg"][name], dev)
                    for name in world.state["msg"]}
    state["obs"] = {name: state_from_numpy(tree["obs"][name], dev)
                    for name in world.state["obs"]}
    for key in ("tick", "frame"):
        state[key] = state_from_numpy(tree[key], dev)
    jsys = _by_name(tree["sys"])
    sys_ = {}
    for name, sids in _by_name(world.state["sys"]).items():
        match = jsys.get(name, [])
        for k, sid in enumerate(sids):
            store = world.state["sys"][sid]
            if len(match) == len(sids):
                jst = tree["sys"][match[k]]
                store = dict(store, last_run=state_from_numpy(
                    jst["last_run"], dev))
                if store.get("local"):
                    store["local"] = state_from_numpy(jst["local"], dev)
            sys_[sid] = store
    state["sys"] = sys_
    world.state = state
    world.mark_device_dirty()
    world._sync()
    world.structure_version += 1


def _by_name(sys_states):
    """System ids ('name#counter') grouped by name, in counter order."""
    out = {}
    for sid in sorted(sys_states, key=lambda s: int(s.rsplit("#", 1)[1])):
        out.setdefault(sid.rsplit("#", 1)[0], []).append(sid)
    return out
