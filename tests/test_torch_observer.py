"""bevy_tpu_torch's observers, lifecycle triggers, relationships and
hierarchy against the JAX package: the same worlds built with either
package (torch_ecs_parity.packages), the whole state held equal after
every frame (ints and bools exactly, floats within 1e-6); the
component_hooks, observer_propagation and ecs_hierarchy twins against
their JAX examples; a JAX observer_propagation world carried into the
port mid-run (interop.load_world), after which both run on alike.
"""

import jax
import numpy as np
import pytest

from torch_ecs_parity import (
    assert_same_state, host_state, packages, run_both, run_jax, run_port,
    twin,
)

J, T = packages()
_DEFS = {}


def defs(P):
    if P.name in _DEFS:
        return _DEFS[P.name]
    c, f = P.comp.component, P.comp.field

    @P.obs.event(name="tobs_damaged")
    class Damaged:
        amount = f(())

    @P.obs.event(name="tobs_poked")
    class Poked:
        row = f((), P.int32)

    @c(name="tobs_enemy")
    class Enemy:
        hp = f((), P.float32, default=3.0)

    @c(name="tobs_npc")
    class Npc:
        charisma = f((), P.float32, default=1.0)

    @P.comp.resource(name="tobs_tally")
    class Tally:
        total = f(())
        frames_seen = f((), P.int32)
        added = f((), P.int32)
        removed = f((), P.int32)
        inserted = f((), P.int32)
        hits = f(16)

    out = dict(Damaged=Damaged, Poked=Poked, Enemy=Enemy, Npc=Npc,
               Tally=Tally, Likes=P.rel.relationship("TobsLikes"),
               Guarding=P.rel.relationship("TobsGuarding"))
    _DEFS[P.name] = out
    return out


def _app(P, cap=16):
    app = P.root.App(capacity=cap, **P.kw)
    app.add_plugins(P.time.TimePlugin())
    app.insert_resource(defs(P)["Tally"]())
    return app


def test_observer_sees_events_the_same_frame():
    """A Trigger's events reach the observer in the frame they fire and
    the buffer clears at frame end."""
    def build(P):
        d = defs(P)
        app = _app(P)

        @P.system.system(name="attack")
        def attack(t=P.obs.Trigger(d["Damaged"], budget=4)):
            t.trigger(count=2, amount=5.0)

        @P.system.system(name="on_damaged")
        def on_damaged(ev=P.obs.On(d["Damaged"]),
                       t=P.query.ResMut(d["Tally"])):
            fields, mask = ev.read()
            t.total = t.total + P.where(mask, fields["amount"], 0.0).sum()
            t.frames_seen = t.frames_seen + P.i32(ev.count() > 0)

        app.add_systems(P.root.Update, attack)
        app.add_observer(d["Damaged"], on_damaged)
        return app

    _, tapp = run_both(build, frames=3)
    t = tapp.world.resource(defs(T)["Tally"])
    assert float(t.total) == 30.0 and int(t.frames_seen) == 3


def test_lifecycle_observers_match_jax():
    """OnAdd from device spawns (same frame) and host spawns (next frame
    start), OnRemove from device and host despawns, OnInsert from query
    writes; no re-fire, no retroactive fire for rows older than the
    observer."""
    def build(P):
        d = defs(P)
        app = _app(P)
        app.world.register_component(d["Enemy"])
        app.world.spawn(d["Enemy"](hp=1.0))       # before the observers
        LM, Q = P.obs.LifecycleMask, P.query

        @P.system.system(name="spawner")
        def spawner(cmd=P.ecs.Commands(spawn_comps=[d["Enemy"]], budget=2)):
            cmd.spawn(d["Enemy"](hp=5.0), count=1)

        @P.system.system(name="reaper")
        def reaper(q=Q.Query(d["Enemy"]), cmd=P.ecs.Commands()):
            cmd.despawn(q.mask & (q.tobs_enemy.hp <= 0.0))
            q.tobs_enemy.hp = q.tobs_enemy.hp - 2.0

        @P.system.system(name="on_added")
        def on_added(life=LM(P.obs.OnAdd(d["Enemy"])),
                     t=Q.ResMut(d["Tally"])):
            t.added = t.added + life.count()

        @P.system.system(name="on_removed")
        def on_removed(life=LM(P.obs.OnRemove(d["Enemy"])),
                       t=Q.ResMut(d["Tally"])):
            t.removed = t.removed + life.count()

        @P.system.system(name="on_inserted")
        def on_inserted(life=LM(P.obs.OnInsert(d["Enemy"])),
                        t=Q.ResMut(d["Tally"])):
            t.inserted = t.inserted + life.count()

        app.add_systems(P.root.Update, [spawner, reaper], chain=True)
        app.add_observer(P.obs.OnAdd(d["Enemy"]), on_added)
        app.add_observer(P.obs.OnRemove(d["Enemy"]), on_removed)
        app.add_observer(P.obs.OnInsert(d["Enemy"]), on_inserted)
        return app

    def script(P, app, k):
        if k == 1:
            app.world.spawn(defs(P)["Enemy"](hp=0.0))
        elif k == 3:
            app.world.despawn(0)

    _, tapp = run_both(build, frames=5, script=script)
    t = tapp.world.resource(defs(T)["Tally"])
    assert int(t.added) == 6 and int(t.removed) > 0


def test_bubble_mask_walks_the_childof_chain():
    def build(P):
        d = defs(P)
        app = _app(P)
        app.add_plugins(P.tf.TransformPlugin())
        tb = P.tf.transform_bundle
        gp, pa, ch = (app.world.spawn(*tb()) for _ in range(3))
        app.world.spawn(*tb())                    # unrelated
        P.tf.set_parent(app.world, pa, gp)
        P.tf.set_parent(app.world, ch, pa)
        target = ch.index

        @P.system.system(name="poke")
        def poke(t=P.obs.Trigger(d["Poked"], budget=2)):
            t.trigger(count=1, row=target)

        @P.system.system(name="on_poked")
        def on_poked(ev=P.obs.On(d["Poked"], bubble=True),
                     t=P.query.ResMut(d["Tally"])):
            t.hits = t.hits + P.f32(ev.bubble_mask())

        app.add_systems(P.root.Update, poke)
        app.add_observer(d["Poked"], on_poked)
        return app

    _, tapp = run_both(build, frames=2)
    hits = tapp.world.resource(defs(T)["Tally"]).hits
    assert hits[:4].tolist() == [2.0, 2.0, 2.0, 0.0]


def test_relationships_match_jax():
    """rel_to / related_mask (stale generations never match a recycled
    row) and both cleanup policies."""
    for P in (J, T):
        d = defs(P)
        w = P.world.World(16, **P.kw)
        star = w.spawn(d["Npc"](charisma=9.0))
        fans = [w.spawn(d["Npc"](), P.rel.rel_to(d["Likes"], star))
                for _ in range(3)]
        other = w.spawn(d["Npc"]())
        w.spawn(d["Npc"](), P.rel.rel_to(d["Likes"], other))
        m = np.asarray(P.rel.related_mask(w.state, d["Likes"], star))
        assert m.sum() == 3 and all(m[f.index] for f in fans)
        w.despawn(star)
        reborn = w.spawn(d["Npc"]())
        assert reborn.index == star.index
        assert np.asarray(P.rel.related_mask(w.state, d["Likes"],
                                             reborn)).sum() == 0

    def build(P):
        d = defs(P)
        app = _app(P)
        for c in ("Npc", "Likes", "Guarding"):
            app.world.register_component(d[c])
        app._vip = app.world.spawn(d["Npc"]())
        app.world.spawn(d["Npc"](), P.rel.rel_to(d["Likes"], app._vip))
        app.world.spawn(d["Npc"](), P.rel.rel_to(d["Guarding"], app._vip))
        mk = P.rel.make_relationship_cleanup_system
        app.add_systems(P.root.Update, mk(d["Likes"], "remove"))
        app.add_systems(P.root.Update, mk(d["Guarding"], "despawn"))
        return app

    def script(P, app, k):
        if k == 1:
            app.world.despawn(app._vip)

    _, tapp = run_both(build, frames=3, script=script)
    assert tapp.world.is_alive(T.ecs.Entity(1, 0))
    assert not tapp.world.has(1, defs(T)["Likes"])
    assert not tapp.world.is_alive(T.ecs.Entity(2, 0))


def test_hierarchy_matches_jax():
    """set_parent's depth buckets, propagation through three levels,
    children_of and despawn_recursive."""
    def build(P):
        app = P.root.App(capacity=16, **P.kw)
        app.add_plugins(P.tf.TransformPlugin())
        tb = P.tf.transform_bundle
        app._e = [app.world.spawn(*tb(translation=(10.0 * (i + 1), 0.0,
                                                   float(i)),
                                      rotation=(0.0, 0.0, 0.38268343,
                                                0.9238795)))
                  for i in range(5)]
        e = app._e
        P.tf.set_parent(app.world, e[1], e[0])
        P.tf.set_parent(app.world, e[2], e[1])
        P.tf.set_parent(app.world, e[3], e[0])
        return app

    def script(P, app, k):
        if k == 2:
            assert P.tf.children_of(app.world, app._e[0]) == [1, 3]
            P.tf.despawn_recursive(app.world, app._e[1])

    _, tapp = run_both(build, frames=4, script=script)
    assert tapp.world.num_alive == 3


@pytest.mark.parametrize("name", ["component_hooks", "observer_propagation",
                                  "ecs_hierarchy"])
def test_observer_twin_matches_jax(name):
    jstates, _ = run_jax(name)
    tstates, _ = run_port(name)
    for a, b in zip(jstates, tstates):
        assert_same_state(a, b)


def test_load_world_carries_observer_propagation_mid_run():
    """A JAX observer_propagation world after three frames, loaded into
    the port's twin (event buffers, ChildOf columns, ticks, last runs):
    both packages then run on to the same state."""
    from bevy_tpu_torch.interop import load_world
    jstates, japp = run_jax("observer_propagation", frames=3)
    mod = twin("observer_propagation")
    tapp = mod.build_app(device="cpu")
    tapp.update(dt=mod.DT)
    load_world(tapp.world, jax.device_get(japp.world.state))
    assert_same_state(jstates[-1], host_state(tapp))
    for _ in range(2):
        japp.update(dt=mod.DT)
        tapp.update(dt=mod.DT)
        assert_same_state(jax.tree.map(np.array,
                                       jax.device_get(japp.world.state)),
                          host_state(tapp))
    hp = tapp.world.column(mod.HitPoints, "value")
    assert hp[:2].tolist() == [5.0, -10.0]


def test_math_helpers_match_jax():
    """The affine and quaternion helpers ported with the hierarchy:
    identities, rotation about z, matrix -> quaternion, points and vectors
    through a TRS, TRS <-> (3, 4) affine, affine and 4x4 products and the
    perspective divide, on seeded inputs (within 1e-5)."""
    import importlib

    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(3)
    q = rng.normal(size=(6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.uniform(-3, 3, (6, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, (6, 3)).astype(np.float32)
    p = rng.uniform(-2, 2, (6, 3)).astype(np.float32)
    m4 = rng.normal(size=(6, 4, 4)).astype(np.float32)
    m4[:, 3, 3] += 4.0
    ang = rng.uniform(-3, 3, 6).astype(np.float32)

    def run(P, arr):
        M = P.math
        aff = importlib.import_module(P.math.__name__ + ".affine")
        quat = importlib.import_module(P.math.__name__ + ".quat")
        x = aff.trs(arr(t), arr(q), arr(s))
        a = aff.trs_to_affine(x)
        back = aff.affine_to_trs(a)
        return [quat.quat_identity((2,)), quat.quat_from_rotation_z(arr(ang)),
                quat.quat_from_mat3(quat.quat_to_mat3(arr(q))),
                aff.trs_identity((2,))["scale"],
                aff.trs_transform_point(x, arr(p)),
                aff.trs_transform_vector(x, arr(p)), a,
                aff.affine_mul(a, a[arr(np.arange(5, -1, -1))]),
                back["translation"],
                back["scale"], back["rotation"],
                aff.mat4_mul(arr(m4), arr(m4)),
                aff.mat4_transform_point(arr(m4), arr(p)),
                M.trs_to_mat4(x)]

    got_j = run(J, jnp.asarray)
    got_t = run(T, torch.from_numpy)
    for a, b in zip(got_j, got_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)
