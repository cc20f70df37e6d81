"""Buffered messages (port of bevy_tpu/ecs/message.py; ref: bevy_ecs
message/ — `Message` `message/mod.rs:100`, `Messages<M>` two-frame ring
`message/messages.rs:95`, `MessageReader`/`MessageWriter` params).

Device layout per message type (World.add_message): each field is a
`(2, capacity, *shape)` tensor plus `count` (2,), a per-slot write tick
`t` (2, capacity) and the current buffer index `cur`. Writers append into
the current buffer with masked writes; readers see both frames (previous
first), filtered to what was written since the reader's last run. The App
swaps the buffers at the end of every frame (ref: message_update_system).
"""

from __future__ import annotations

import torch

from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.component import component, get_spec


def message(cls=None, **kw):
    """Decorator registering a message struct (same field machinery as
    components)."""
    return component(cls, **kw) if cls is not None else component(**kw)


class MessageWriter:
    def __init__(self, msg, budget: int = 64):
        self.spec = get_spec(msg)
        self.budget = budget

    def reads(self):
        return set()

    def writes(self):
        return {f"msg:{self.spec.name}"}

    def build(self, state, world, sysctx):
        return MessageWriterView(self)


class MessageWriterView:
    def __init__(self, param):
        self._param = param
        self._sends = []

    def send(self, count=None, **fields):
        """Queue up to `budget` messages, `count` (an int or a device
        scalar) of them real. Field values: (budget, *shape) or
        broadcastable."""
        self._sends.append((count, fields))

    def send_one(self, **fields):
        self.send(count=1, **fields)

    def merge(self, state, tick):
        if not self._sends:
            return state
        name = self._param.spec.name
        budget = self._param.budget
        store = dict(state["msg"][name])
        fields = dict(store["f"])
        cap = store["t"].shape[1]
        dev = store["t"].device
        lane = torch.arange(budget, device=dev)
        for count, vals in self._sends:
            count = budget if count is None else count
            cur = store["cur"]
            # the current buffer's count by a (1,) gather: indexing with
            # the 0-d `cur` would read it back to the host
            rows = store["count"].index_select(0, cur.long().reshape(1)) \
                + lane
            valid = (lane < count) & (rows < cap)
            # flat slot in the (2 * cap) buffer; 2 * cap drops the write
            flat = torch.where(valid, cur * cap + rows, 2 * cap).long()
            for fname, fld in self._param.spec.fields.items():
                val = torch.as_tensor(vals.get(fname, fld.default),
                                      dtype=fld.dtype, device=dev)
                fields[fname] = _put(fields[fname], flat,
                                     val.expand((budget,) + fld.shape))
            store["t"] = _put(store["t"], flat, tick)
            added = valid.to(torch.int32).sum()
            store["count"] = torch.where(
                torch.arange(2, device=dev) == cur, store["count"] + added,
                store["count"])
        store["f"] = fields
        return set_in(state, ("msg", name), store)


def _put(buf, flat, val):
    """`buf` (2, cap, ...) with flat slots `flat` set to `val`."""
    two, cap = buf.shape[:2]
    ext = torch.cat([buf.reshape((two * cap,) + buf.shape[2:]),
                     buf[0, :1]])
    ext[flat] = val
    return ext[:two * cap].reshape(buf.shape)


class MessageReader:
    def __init__(self, msg):
        self.spec = get_spec(msg)

    def reads(self):
        return {f"msg:{self.spec.name}"}

    def writes(self):
        return set()

    def build(self, state, world, sysctx):
        return MessageReaderView(state["msg"][self.spec.name],
                                 state["sys"][sysctx["id"]]["last_run"])


class MessageReaderView:
    def __init__(self, store, last_run):
        self._store = store
        self._last_run = last_run

    def read(self):
        """(fields, mask): each field flattened to (2 * capacity, ...) with
        the previous frame's rows first, and a validity mask filtered to
        messages written since this system's last run (ref:
        MessageCursor — each reader sees each message once)."""
        store = self._store
        cur = store["cur"].long()
        order = torch.stack([1 - cur, cur])
        fields = {}
        cap = store["t"].shape[1]
        for fname, arr in store["f"].items():
            arr = arr[order]
            fields[fname] = arr.reshape((2 * cap,) + arr.shape[2:])
        lane = torch.arange(cap, device=cur.device)
        counts = store["count"][order]
        mask = torch.cat([lane < counts[0], lane < counts[1]])
        ticks = store["t"][order].reshape(2 * cap)
        return fields, mask & (ticks > self._last_run)

    def count(self):
        return self._store["count"].sum()

    def merge(self, state, tick):
        return state


def swap_message_buffers(state):
    """Frame-final swap: flip `cur`, clear the buffer that becomes current
    (ref: Messages::update)."""
    msgs = {}
    for name, store in state["msg"].items():
        cur = 1 - store["cur"]
        msgs[name] = dict(store, cur=cur, count=torch.where(
            torch.arange(2, device=cur.device) == cur, 0, store["count"]))
    return set_in(state, ("msg",), msgs)
