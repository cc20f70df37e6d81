"""Device-tier Commands and buffered messages of bevy_tpu_torch against
the JAX package's, on the same seeded world.

Both packages start from the same host spawns (values from a numpy seed)
and run the same systems; after every system the two states must be
exactly equal: alive bits, generations, each component's membership and
its added / changed / removed ticks, every field, the world tick and the
message buffers. The port's spawn claims rows without a host read; its
World copies the liveness mirrors back only when a host call asks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bevy_tpu.ecs as J
from bevy_tpu.ecs.commands import Commands as JCommands
from bevy_tpu.ecs.message import (
    MessageReader as JReader, MessageWriter as JWriter, message as jmessage,
    swap_message_buffers as jswap,
)
import bevy_tpu_torch.ecs as T
from bevy_tpu_torch.ecs.message import swap_message_buffers as tswap
from bevy_tpu_torch.interop import load_world

CAP = 16


@J.component(name="cmd_pos")
class JPos:
    value = J.field(2)


@J.component(name="cmd_vel")
class JVel:
    value = J.field(2)
    tag = J.field((), jnp.int32, default=3)


@jmessage(name="cmd_hit")
class JHit:
    n = J.field((), jnp.int32)


@T.component(name="cmd_pos")
class TPos:
    value = T.field(2)


@T.component(name="cmd_vel")
class TVel:
    value = T.field(2)
    tag = T.field((), torch.int32, default=3)


@T.message(name="cmd_hit")
class THit:
    n = T.field((), torch.int32)


def _worlds():
    rng = np.random.RandomState(7)
    pos = rng.uniform(-5, 5, (10, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (4, 2)).astype(np.float32)
    jw, tw = J.World(CAP), T.World(CAP, device="cpu")
    for w, P, V, H in ((jw, JPos, JVel, JHit), (tw, TPos, TVel, THit)):
        w.spawn_batch([P(value=pos[:4]), V(value=vel)], 4)
        w.spawn_batch([P(value=pos[4:])], 6)
        w.add_message(H, capacity=4)
    return jw, tw


def _same(jstate, tstate):
    jh = jax.device_get(jstate)

    def walk(j, t, path):
        if isinstance(t, dict):
            for k in t:
                walk(j[k], t[k], path + (k,))
            return
        a = np.asarray(j)
        b = t.cpu().numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (path, a, b)

    for key in ("ent", "tick"):
        walk(jh[key], tstate[key], (key,))
    walk({k: jh["comp"][k] for k in ("cmd_pos", "cmd_vel")},
         {k: tstate["comp"][k] for k in ("cmd_pos", "cmd_vel")}, ("comp",))
    walk(jh["msg"]["cmd_hit"], tstate["msg"]["cmd_hit"], ("msg",))


def _run(jw, tw, jfn, tfn):
    """One system in each package, run once against its world."""
    for w, fn in ((jw, jfn), (tw, tfn)):
        fn.init_state(w)
        w.state = fn.run(w.state, w)
    _same(jw.state, tw.state)


def _mask(rows):
    m = np.zeros(CAP, bool)
    m[list(rows)] = True
    return m


def _spawn_pair(count, budget, rows_to_despawn=()):
    vals = np.arange(2 * budget, dtype=np.float32).reshape(budget, 2) + 0.5
    dm = _mask(rows_to_despawn)

    @J.system(name="cmd_spawn")
    def jsys(c=JCommands(budget=budget)):
        c.despawn(jnp.asarray(dm))
        c.spawn(JPos(value=jnp.asarray(vals)), JVel(value=(1.0, 2.0)),
                count=jnp.int32(count))

    @T.system(name="cmd_spawn")
    def tsys(c=T.Commands(budget=budget)):
        c.despawn(torch.from_numpy(dm))
        c.spawn(TPos(value=torch.from_numpy(vals)), TVel(value=(1.0, 2.0)),
                count=torch.tensor(count, dtype=torch.int32))

    return jsys, tsys


@pytest.mark.parametrize("count,budget,despawned", [
    (3, 5, (1, 4, 7)),       # count < budget: the lowest freed rows
    (8, 8, ()),              # past capacity: 6 free rows, 2 dropped
    (0, 4, (0, 9)),          # despawn only
], ids=["count_lt_budget", "past_capacity", "despawn_only"])
def test_spawn_and_despawn_match_jax(count, budget, despawned):
    jw, tw = _worlds()
    _run(jw, tw, *_spawn_pair(count, budget, despawned))
    # the host mirrors copy back on the next host read
    assert tw._device_dirty
    assert list(tw.query_rows(TPos)) == list(jw.query_rows(JPos))
    assert tw.entity_count(TVel) == jw.entity_count(JVel)
    assert not tw._device_dirty


def test_insert_remove_and_despawn_entities_match_jax():
    jw, tw = _worlds()
    _run(jw, tw, *_spawn_pair(3, 4, (2,)))
    ins = _mask((0, 5, 6, 11))
    rem = _mask((1, 5, 8))
    rows = np.array([3, 12, 6, 0], np.int32)
    valid = np.array([True, True, False, False])
    vel = np.full((CAP, 2), 9.0, np.float32)

    @J.system(name="cmd_edit")
    def jsys(c=JCommands()):
        c.insert(jnp.asarray(ins), JVel(value=jnp.asarray(vel), tag=7))
        c.remove(jnp.asarray(rem), JPos)
        c.despawn_entities(jnp.asarray(rows), jnp.asarray(valid))

    @T.system(name="cmd_edit")
    def tsys(c=T.Commands()):
        c.insert(torch.from_numpy(ins), TVel(value=torch.from_numpy(vel),
                                             tag=7))
        c.remove(torch.from_numpy(rem), TPos)
        c.despawn_entities(torch.from_numpy(rows), torch.from_numpy(valid))

    _run(jw, tw, jsys, tsys)
    assert list(tw.query_rows(TVel)) == list(jw.query_rows(JVel))


def test_messages_match_jax():
    """Two writes a frame (the second at capacity), a swap, a read: the same
    buffers, counts, write ticks and reader mask."""
    jw, tw = _worlds()

    @J.system(name="cmd_write")
    def jwrite(w=JWriter(JHit, budget=3)):
        w.send(count=jnp.int32(3), n=jnp.arange(3, dtype=jnp.int32) + 1)
        w.send_one(n=9)

    @T.system(name="cmd_write")
    def twrite(w=T.MessageWriter(THit, budget=3)):
        w.send(count=torch.tensor(3, dtype=torch.int32),
               n=torch.arange(3, dtype=torch.int32) + 1)
        w.send_one(n=9)

    _run(jw, tw, jwrite, twrite)
    jw.state, tw.state = jswap(jw.state), tswap(tw.state)
    _same(jw.state, tw.state)
    _run(jw, tw, jwrite, twrite)
    seen = {}

    @J.system(name="cmd_read")
    def jread(r=JReader(JHit)):
        seen["j"] = jax.device_get(r.read())

    @T.system(name="cmd_read")
    def tread(r=T.MessageReader(THit)):
        seen["t"] = r.read()

    _run(jw, tw, jread, tread)
    (jf, jm), (tf, tm) = seen["j"], seen["t"]
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(jf["n"]), tf["n"].numpy())
    assert int(tm.sum()) == 8          # 4 a frame, capacity 4


def test_load_world_carries_commands_and_messages():
    """A JAX world after device spawns, despawns and message writes,
    loaded into the port's World (interop.load_world): the same state,
    and the host mirrors follow it."""
    jw, tw = _worlds()
    jsys, _ = _spawn_pair(3, 5, (1, 4, 7))
    jsys.init_state(jw)
    jw.state = jsys.run(jw.state, jw)

    @J.system(name="cmd_write")
    def jwrite(w=JWriter(JHit, budget=3)):
        w.send(count=jnp.int32(2), n=jnp.arange(3, dtype=jnp.int32) + 5)

    jwrite.init_state(jw)
    jw.state = jwrite.run(jw.state, jw)
    load_world(tw, jax.device_get(jw.state))
    _same(jw.state, tw.state)
    jw.mark_device_dirty()
    assert list(tw.query_rows(TPos)) == list(jw.query_rows(JPos))


def test_spawn_reads_nothing_back(monkeypatch):
    """The device spawn path makes no host read: Tensor.item, .cpu and
    .numpy are refused while the system runs."""
    jw, tw = _worlds()
    _, tsys = _spawn_pair(3, 5, (1, 4))
    tsys.init_state(tw)

    def refuse(*a, **k):
        raise AssertionError("host read during the frame")

    for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    state = tsys.run(tw.state, tw)
    monkeypatch.undo()
    assert int(state["ent"]["alive"].sum()) == 11
