"""bevy_tpu_torch's ECS core against the JAX package: the host-tier World,
query filters, Single, Local, pair combinations, required components,
Disabled, fallible systems, one-shot systems, run conditions (a false
condition leaves tick, last_run and the change stamps as `lax.cond`'s
false branch does), ambiguity detection and the ECS example twins.

Each world is built once per package from the same numbers
(torch_ecs_parity.packages) and the whole state is held equal after every
frame or run: ints and bools exactly, floats within rtol / atol 1e-6.
The JAX examples one_shot_systems, message_events and startup_systems
fail in whole JAX test runs (state leaks between JAX examples, ROADMAP
A0), so their JAX states are stored (tests/make_torch_goldens.py).
"""

import numpy as np
import pytest
import torch

from torch_ecs_parity import (
    assert_same_state, host_state, load_states, packages, run_both, run_jax,
    run_port,
)

J, T = packages()
_DEFS = {}


def defs(P):
    """The components and resources of these tests, once per package
    (explicit storage names: the registries are process-wide)."""
    if P.name in _DEFS:
        return _DEFS[P.name]
    c, f = P.comp.component, P.comp.field

    @c(name="tecs_pos")
    class Pos:
        value = f(2)

    @c(name="tecs_vel")
    class Vel:
        value = f(2)

    @c(name="tecs_marker")
    class Marker:
        pass

    @c(name="tecs_shield")
    class Shield:
        hp = f((), P.float32, default=10.0)

    @c(name="tecs_armor", requires=[Shield])
    class Armor:
        thickness = f((), P.float32, default=2.0)

    @c(name="tecs_knight", requires=[Armor])
    class Knight:
        pass

    @c(name="tecs_body")
    class Body:
        pos = f(3)
        vel = f(3)
        mass = f((), P.float32, default=1.0)

    @c(name="tecs_rare")
    class Rare:
        v = f(())

    @P.comp.resource(name="tecs_tally")
    class Tally:
        n = f((), P.int32)
        m = f((), P.int32)
        x = f(())

    out = dict(Pos=Pos, Vel=Vel, Marker=Marker, Shield=Shield, Armor=Armor,
               Knight=Knight, Body=Body, Rare=Rare, Tally=Tally)
    _DEFS[P.name] = out
    return out


def _worlds(cap=16):
    return J.world.World(cap), T.world.World(cap, **T.kw)


def test_host_tier_world_matches_jax():
    """spawn / spawn_batch / insert / remove / despawn (the removed tick,
    row reuse with a generation bump) / set_field / clone_entity, growth,
    and the host reads (is_alive, has, num_alive, get, resource)."""
    jw, tw = _worlds(4)
    out = []
    for P, w in ((J, jw), (T, tw)):
        d = defs(P)
        e = w.spawn(d["Pos"](value=(1.0, 2.0)), d["Vel"](value=(0.5, 0.0)))
        rows = w.spawn_batch([d["Pos"](value=np.arange(12, dtype=np.float32)
                                       .reshape(6, 2)), d["Marker"]()], 6)
        w.insert(int(rows[1]), d["Vel"](value=(3.0, 3.0)))
        w.remove(int(rows[2]), d["Marker"])
        w.set_field(e, d["Pos"], "value", (9.0, 8.0))
        c = w.clone_entity(e, without=[d["Vel"]])
        assert w.despawn(e) and not w.despawn(e)
        e2 = w.spawn(d["Pos"]())
        w.insert_resource(d["Tally"](n=3, x=1.5))
        w.set_resource_field(d["Tally"], "m", 7)
        out.append((e, e2, c, w.is_alive(e), w.is_alive(e2), w.is_alive(c),
                    w.has(c, d["Vel"]), w.has(int(rows[2]), d["Marker"]),
                    w.num_alive, w.capacity, w.get(c, d["Pos"]).value.tolist(),
                    int(w.resource(d["Tally"]).m), w.has_resource(d["Tally"]),
                    np.asarray(w.mask_of(d["Pos"], d["Marker"])).tolist()))
    assert out[0] == out[1]
    assert out[1][1].index == out[1][0].index and out[1][1].generation == 1
    for w, got in ((jw, out[0]), (tw, out[1])):
        w.despawn(got[1])
        with pytest.raises(ValueError):
            w.clone_entity(got[1])               # despawned
    assert_same_state(host_state(jw), host_state(tw))


def test_same_class_name_gets_distinct_storage():
    """Two different classes of one class name never alias onto one pool:
    the second is qualified by its module, as in the JAX package, and
    bare_name strips it."""
    import types
    names = []
    for P in (J, T):
        classes = []
        for mod in ("tecs_mod_a", "tecs_mod_b", "tecs_mod_b"):
            cls = type("TecsDup", (), {"v": P.comp.field(())})
            cls.__module__ = types.ModuleType(mod).__name__
            classes.append(P.comp.component(cls))
        w = P.world.World(4, **P.kw)
        for k, c in enumerate(classes):
            w.spawn(c(v=float(k)))
        got = [P.comp.get_spec(c).name for c in classes]
        names.append((got, [P.comp.bare_name(n) for n in got],
                      sorted(w.specs)))
    assert names[0] == names[1]
    assert names[1][0][1:] == ["tecs_mod_b.tecs_dup", "tecs_mod_b.tecs_dup#2"]


def _schedule_run(P, w, systems, runs, **cfg):
    sched = P.sched.Schedule("t")
    for s in systems:
        sched.add_systems(s, **cfg)
    sched.init_systems(w)
    run = sched.run_traced if P is J else sched.run
    states = []
    for _ in range(runs):
        w.state = run(w.state, w)
        states.append(host_state(w))
    return states


def _filter_systems(P):
    d = defs(P)
    Pos, Vel, Marker, Tally = d["Pos"], d["Vel"], d["Marker"], d["Tally"]
    Q = P.query

    @P.system.system(name="move_some")
    def move_some(q=Q.Query(Pos, with_=[Vel])):
        q.tecs_pos.value = q.tecs_pos.value + 1.0

    qb = Q.QueryBuilder().data(Pos).ref_(Vel).without(Marker).build()

    @P.system.system(name="built")
    def built(q=qb):
        q.tecs_pos.value = q.tecs_pos.value * 2.0

    @P.system.system(name="count")
    def count(ch=Q.Query(Q.Read(Pos), changed=[Pos]),
              ad=Q.Query(Pos, P.ecs.Added(Pos)),
              rm=Q.Query(P.ecs.Removed(Marker)),
              wo=Q.Query(Pos, P.ecs.Without(Marker)),
              t=Q.ResMut(Tally)):
        t.n = t.n + ch.count() * 100 + ad.count() * 10 + rm.count()
        t.m = t.m + wo.count()

    return [move_some, built, count]


def test_query_filters_match_jax():
    """Changed / Added / Removed (per-row ticks against the system's
    last_run), With / Without positional and keyword, QueryBuilder: the
    same states after each of five runs, with host edits between."""
    jw, tw = _worlds()
    for P, w in ((J, jw), (T, tw)):
        d = defs(P)
        w.insert_resource(d["Tally"]())
        w.spawn(d["Pos"](value=(1.0, 1.0)), d["Vel"](value=(1.0, 1.0)))
        w.spawn(d["Pos"](value=(2.0, 2.0)), d["Marker"]())
        w.spawn(d["Pos"](value=(3.0, 3.0)), d["Vel"](), d["Marker"]())
    js = _schedule_run(J, jw, _filter_systems(J), 2, chain=False)
    ts = _schedule_run(T, tw, _filter_systems(T), 2, chain=False)
    for P, w in ((J, jw), (T, tw)):
        d = defs(P)
        w.remove(2, d["Marker"])
        w.despawn(1)
        w.spawn(d["Pos"](value=(5.0, 5.0)))
    js += _schedule_run(J, jw, _filter_systems(J), 3)
    ts += _schedule_run(T, tw, _filter_systems(T), 3)
    for a, b in zip(js, ts):
        assert_same_state(a, b)
    assert int(tw.resource(defs(T)["Tally"]).n) > 0


def test_single_local_and_pairs_match_jax():
    """Single reads / writes one row and gates on `exists`; Local keeps a
    count across frames; pair_combinations drives the n-body pull."""
    def build(P):
        d = defs(P)
        Q = P.query
        app = P.root.App(capacity=8, **P.kw)
        app.world.register_component(d["Rare"])
        app.world.spawn(d["Body"](pos=(1.0, 0.0, 0.0), vel=(0.0, 0.0, 0.0)))
        app.world.spawn(d["Body"](pos=(-1.0, 0.0, 0.0)))
        app.world.spawn(d["Body"](pos=(0.0, 2.0, 0.0), mass=2.0))
        app.world.spawn(d["Shield"](hp=3.0))

        @P.system.system(name="boost")
        def boost(s=Q.Single(d["Shield"]), r=Q.Single(d["Rare"]),
                  loc=Q.Local(P.i32(0))):
            s.tecs_shield.hp = P.where(r.exists, s.tecs_shield.hp,
                                       s.tecs_shield.hp * 2.0 + 1.0)
            loc.value = loc.value + 1

        @P.system.system(name="gravity")
        def gravity(q=Q.Query(d["Body"])):
            i, j, ok = Q.pair_combinations(q.mask)
            b = q.tecs_body
            dd = b.pos[j] - b.pos[i]
            r2 = (dd * dd).sum(-1)
            r2 = P.where(r2 > 1e-4, r2, 1e-4)
            f = P.where(ok, 1.0 / r2, 0.0)[:, None] * dd
            acc = P.zeros(b.vel.shape)
            if P is J:
                acc = acc.at[i].add(f * b.mass[j, None])
                acc = acc.at[j].add(-f * b.mass[i, None])
            else:
                acc = acc.index_add(0, i, f * b.mass[j, None])
                acc = acc.index_add(0, j, -f * b.mass[i, None])
            b.vel = b.vel + acc * (1 / 60)

        app.add_systems(P.root.Update, [boost, gravity])
        return app

    japp, tapp = run_both(build, frames=3)
    m = np.asarray([1.0, 1.0, 2.0])[:, None]
    v = tapp.world.column(defs(T)["Body"], "vel").numpy()[:3]
    assert np.allclose((m * v).sum(0), 0.0, atol=1e-6)
    i, j, ok = T.query.pair_combinations(torch.tensor([True, False, True,
                                                       True]))
    assert {(int(a), int(b)) for a, b, o in zip(i, j, ok) if o} == \
        {(0, 2), (0, 3), (2, 3)}


def test_required_components_match_jax():
    """#[require]: transitive, explicit values win, insert keeps existing
    values, device spawns bring them too."""
    def build(P):
        d = defs(P)
        app = P.root.App(capacity=16, **P.kw)
        app.world.register_component(d["Knight"])
        app.world.spawn(d["Knight"]())
        app.world.spawn(d["Knight"](), d["Shield"](hp=99.0))
        e3 = app.world.spawn(d["Shield"](hp=55.0))
        app.world.insert(e3, d["Armor"]())

        @P.system.system(name="launcher")
        def launcher(cmd=P.ecs.Commands(spawn_comps=[d["Knight"]], budget=2)):
            cmd.spawn(d["Knight"](), count=1)

        @P.system.system(name="armor_all")
        def armor_all(q=P.query.Query(d["Pos"]), cmd=P.ecs.Commands()):
            cmd.insert(q.mask, d["Armor"](thickness=4.0))

        app.world.spawn(d["Pos"]())
        app.world.spawn(d["Pos"](), d["Shield"](hp=7.0))
        app.add_systems(P.root.Update, [launcher, armor_all], chain=True)
        return app

    japp, tapp = run_both(build, frames=2)
    w, d = tapp.world, defs(T)
    assert w.entity_count(d["Knight"]) == 4
    assert w.entity_count(d["Shield"]) == 7
    assert float(w.get(1, d["Shield"]).hp) == 99.0
    assert float(w.get(2, d["Shield"]).hp) == 55.0


def test_disabled_is_skipped_by_default():
    def build(P):
        d = defs(P)
        Dis = P.world.Disabled
        app = P.root.App(capacity=8, **P.kw)
        app.world.register_component(Dis)
        app.insert_resource(d["Tally"]())
        app.world.spawn(d["Shield"]())
        app._e = app.world.spawn(d["Shield"]())

        @P.system.system(name="count_alive")
        def count_alive(q=P.query.Query(d["Shield"]),
                        dq=P.query.Query(d["Shield"], P.ecs.With(Dis)),
                        t=P.query.ResMut(d["Tally"])):
            t.n = q.count()
            t.m = dq.count()

        app.add_systems(P.root.Update, count_alive)
        return app

    def script(P, app, k):
        if k == 1:
            app.world.insert(app._e, P.world.Disabled())
        elif k == 3:
            app.world.remove(app._e, P.world.Disabled)

    run_both(build, frames=4, script=script)


def _fallible(P, handler, soft=False):
    d = defs(P)
    app = P.root.App(capacity=4, **P.kw)
    app.add_plugins(P.time.TimePlugin())
    app.insert_resource(d["Tally"]())

    @P.system.system(name="broken")
    def broken(c=P.query.ResMut(d["Tally"])):
        c.m = c.m + 100          # staged write, dropped
        if soft:
            return ValueError("nope")
        raise RuntimeError("boom")

    @P.system.system(name="healthy")
    def healthy(c=P.query.ResMut(d["Tally"])):
        c.n = c.n + 1

    app.add_systems(P.root.Update, broken, healthy)
    if handler is not None:
        app.set_error_handler(handler)
    return app


@pytest.mark.parametrize("handler", ["warn", "ignore", "soft"])
def test_fallible_systems_match_jax(handler):
    """Errors raised (or returned) by a body go to the error handler, and
    that system's staged writes are dropped; without a handler they
    raise."""
    seen = {J.name: [], T.name: []}

    def build(P):
        if handler == "soft":
            return _fallible(P, lambda e, s: seen[P.name].append(
                (str(e), s.name)), soft=True)
        return _fallible(P, handler)

    run_both(build, frames=2)
    if handler == "soft":
        # the port runs bodies eagerly: its handler hears each frame; a JAX
        # device system fails at trace time, once
        assert seen[T.name] == [("nope", "broken")] * 2
        assert seen[J.name] == [("nope", "broken")]
    with pytest.raises(RuntimeError, match="boom"):
        _fallible(T, None).update(dt=1 / 60)


def test_run_if_false_leaves_tick_and_stamps_as_lax_cond():
    """A conditioned system whose condition is false leaves the state as
    the false branch of `lax.cond`: no tick advance, no last_run stamp,
    no changed stamp and no staged write; true runs it whole. Conditions
    AND together; a Python-bool condition picks on the host."""
    def build(P):
        d = defs(P)
        app = P.root.App(capacity=8, **P.kw)
        app.add_plugins(P.time.TimePlugin())
        app.insert_resource(d["Tally"]())
        app.world.spawn(d["Pos"](value=(1.0, 1.0)))
        FC = P.time.FrameCount

        @P.system.system(name="odd")
        def odd(f=P.query.Res(FC)):
            return f.count % 2 == 1

        @P.system.system(name="below_four")
        def below_four(f=P.query.Res(FC)):
            return f.count < 4

        @P.system.system(name="always")
        def always():
            return True

        @P.system.system(name="write")
        def write(q=P.query.Query(d["Pos"]), t=P.query.ResMut(d["Tally"]),
                  cmd=P.ecs.Commands(spawn_comps=[d["Vel"]], budget=1)):
            q.tecs_pos.value = q.tecs_pos.value + 1.0
            t.n = t.n + 1
            cmd.spawn(d["Vel"](value=(2.0, 2.0)), count=1)

        @P.system.system(name="seen")
        def seen(q=P.query.Query(d["Pos"], P.ecs.Changed(d["Pos"])),
                 t=P.query.ResMut(d["Tally"])):
            t.m = t.m + q.count()

        app.add_systems(P.root.Update, write, run_if=[odd, below_four])
        app.add_systems(P.root.Update, seen, after="write", run_if=always)
        return app

    japp, tapp = run_both(build, frames=6)
    assert int(tapp.world.resource(defs(T)["Tally"]).n) == 2


def test_run_if_frame_makes_no_host_read(monkeypatch):
    """A frame of the run_conditions, states and message_events twins reads
    nothing back: Tensor.item, __bool__ and friends, and indexing with a
    0-d tensor (which reads the index), are refused while it runs."""
    import torch_message_events
    import torch_run_conditions
    import torch_states

    def refuse(*a, **k):
        raise AssertionError("host read during the frame")

    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def zero_d(idx):
        return any(isinstance(i, torch.Tensor) and i.dim() == 0
                   for i in (idx if isinstance(idx, tuple) else (idx,)))

    def guarded_get(self, idx):
        if zero_d(idx):
            raise AssertionError("0-d tensor index: a host read")
        return get(self, idx)

    def guarded_put(self, idx, v):
        if zero_d(idx):
            raise AssertionError("0-d tensor index: a host read")
        return put(self, idx, v)

    for mod in (torch_run_conditions, torch_states, torch_message_events):
        app = mod.build_app(device="cpu")
        for k in range(5):
            mod.script(app, k)
            with monkeypatch.context() as mp:
                for name in ("item", "cpu", "numpy", "tolist", "__bool__",
                             "__int__", "__float__", "__index__"):
                    mp.setattr(torch.Tensor, name, refuse)
                mp.setattr(torch.Tensor, "__getitem__", guarded_get)
                mp.setattr(torch.Tensor, "__setitem__", guarded_put)
                app.update(dt=mod.DT)
        assert app.frame == 5


def test_ambiguity_detection_matches_jax():
    """Unordered systems with conflicting access are listed; ordering
    them, or read-only access, clears it."""
    found = []
    for P in (J, T):
        d = defs(P)
        Q = P.query

        @P.system.system(name="a")
        def a(q=Q.Query(d["Pos"]), t=Q.Res(d["Tally"])):
            pass

        @P.system.system(name="b")
        def b(q=Q.Query(d["Pos"]), t=Q.ResMut(d["Tally"])):
            pass

        @P.system.system(name="c")
        def c(q=Q.Query(Q.Read(d["Pos"])), cmd=P.ecs.Commands()):
            pass

        s1 = P.sched.Schedule("t")
        s1.add_systems([a, b, c])
        s1.build_order()
        s2 = P.sched.Schedule("t2")
        s2.add_systems([a, b, c], chain=True)
        s2.build_order()
        found.append(([(x, y, sorted(z)) for x, y, z in s1.ambiguities],
                      s2.ambiguities,
                      sorted(a.conflicts_with(b)), sorted(c.reads)))
    assert found[0] == found[1]
    assert len(found[1][0]) == 3 and found[1][1] == []


@pytest.mark.parametrize("name", ["run_conditions", "change_detection",
                                  "removal_detection", "many_components"])
def test_ecs_twin_matches_jax(name):
    """The twin's world against the JAX example's, after each of five
    scripted frames."""
    jstates, _ = run_jax(name)
    tstates, _ = run_port(name)
    for a, b in zip(jstates, tstates):
        assert_same_state(a, b)


@pytest.mark.parametrize("name", ["one_shot_systems", "message_events",
                                  "startup_systems"])
def test_ecs_twin_matches_stored_jax(name):
    """As above, against the JAX example's stored states (these JAX
    examples fail in whole JAX test runs)."""
    tstates, _ = run_port(name)
    for a, b in zip(load_states(name), tstates):
        assert_same_state(a, b)
