"""Multi-device scaling (port of bevy_tpu/parallel/__init__.py's
`make_mesh`).

The JAX package shards with `shard_map` over a device mesh inside one
process; the port keeps that single-controller shape: one App, one World,
and the shard work placed on a list of `torch.device`s by
parallel/raster.py. A `ShardMesh` is that list. A device may repeat (the
CPU tests use eight `cpu` entries; one card can stand for several shards),
and the shards' work then runs one after another on it.

Not ported yet (ROADMAP A10): the GSPMD world layout (`world_shardings`,
`shard_world`), the HLO collective accounting (`collective_inventory`,
`cross_host_ops`) and multi-host meshes.
"""

from __future__ import annotations

import torch


class ShardMesh:
    """One axis of devices, shard d on `devices[d]`."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a ShardMesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"ShardMesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None) -> ShardMesh:
    """The first `n_devices` CUDA cards (all of them by default), or the
    first `n_devices` of an explicit `devices` list. Raises when fewer
    exist: nothing falls back to fewer devices or to the CPU."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        where = "CUDA cards"
    else:
        devs = [torch.device(d) for d in devices]
        where = "devices given"
    n = n_devices or len(devs)
    if n < 1 or len(devs) < n:
        raise ValueError(f"mesh wants {n} devices, {len(devs)} {where}")
    return ShardMesh(devs[:n])


def as_mesh(shards) -> ShardMesh | None:
    """A plugin's `shards` option as a ShardMesh: None stays None, a
    ShardMesh is kept, a count takes the first that many CUDA cards
    (`make_mesh`)."""
    if shards is None or isinstance(shards, ShardMesh):
        return shards
    return make_mesh(int(shards))
