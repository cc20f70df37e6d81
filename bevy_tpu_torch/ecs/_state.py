"""Copy-on-write helper for the nested-dict world state: systems build a
new state dict along one path; tensors are shared, never copied."""

import torch


def set_in(d, path, value):
    out = dict(d)
    out[path[0]] = value if len(path) == 1 else set_in(d[path[0]], path[1:],
                                                        value)
    return out


def select_tree(pred, new, old):
    """`new` where the device bool `pred` holds, else `old`, leaf by leaf
    over two state dicts: the predicated form of `lax.cond(pred, run,
    identity)`. Leaves `new` shares with `old` stay as they are; leaves
    only one side holds are kept."""
    if new is old:
        return old
    if isinstance(new, dict) and isinstance(old, dict):
        out = dict(old)
        for k, v in new.items():
            out[k] = select_tree(pred, v, old[k]) if k in old else v
        return out
    if isinstance(new, torch.Tensor) and isinstance(old, torch.Tensor):
        return torch.where(pred, new, old)
    return new
