"""bevy_tpu_torch's states, sub-states, computed states, StateScoped and
stepping against the JAX package: the same worlds built with either
package (torch_ecs_parity.packages), the whole state held equal after
every frame (ints and bools exactly, floats within 1e-6); the states,
sub_states, computed_states (stored: the JAX example fails in whole JAX
runs) and system_stepping twins; a JAX states world carried into the
port mid-run, after which both run on alike.
"""

import jax
import numpy as np
import pytest

from torch_ecs_parity import (
    assert_same_state, host_state, load_states, packages, run_both, run_jax,
    run_port, twin,
)

J, T = packages()
_DEFS = {}
MENU, PLAYING, PAUSED = 0, 1, 2


def defs(P):
    if P.name in _DEFS:
        return _DEFS[P.name]
    f = P.comp.field

    @P.comp.resource(name="tst_log")
    class Log:
        enters = f((), P.int32)
        exits = f((), P.int32)
        updates = f((), P.int32)

    @P.comp.component(name="tst_menu_item")
    class MenuItem:
        pass

    _DEFS[P.name] = out = dict(Log=Log, MenuItem=MenuItem)
    return out


def _app(P, name):
    app = P.root.App(capacity=16, **P.kw)
    app.add_plugins(P.time.TimePlugin())
    app.insert_resource(defs(P)["Log"]())
    P.state.add_state(app, name, MENU, [MENU, PLAYING, PAUSED])
    return app


def _counter(P, field, name):
    Log = defs(P)["Log"]

    @P.system.system(name=name)
    def bump(log=P.query.ResMut(Log)):
        setattr(log, field, getattr(log, field) + 1)

    return bump


def _goto(P, state_name, value, name="goto"):
    @P.system.system(name=name)
    def goto(ns=P.state.NextState(state_name)):
        ns.set(value)

    return goto


def test_transitions_and_in_state_match_jax():
    """OnExit then OnEnter at StateTransition, once (a self-transition
    does not refire), in_state gating, StateScoped cleanup on exit."""
    def build(P):
        S = P.state
        app = _app(P, "tst_game")
        app.add_systems(S.OnExit("tst_game", MENU),
                        _counter(P, "exits", "on_exit_menu"))
        app.add_systems(S.OnEnter("tst_game", PLAYING),
                        _counter(P, "enters", "on_enter_playing"))
        app.add_systems(P.root.Update, _counter(P, "updates", "count"),
                        run_if=S.in_state("tst_game", PLAYING))
        app.add_systems(P.root.Update, _goto(P, "tst_game", PLAYING))
        mi = defs(P)["MenuItem"]
        app.world.spawn(mi(), S.state_scoped("tst_game", MENU))
        app.world.spawn(mi())
        return app

    # StateScoped stores the machine's id in a process-wide registry whose
    # order differs between the packages' test runs: give the port's
    # machine the id JAX gives it (as add_state would)
    ids = J.state._STATE_IDS
    T.state._STATE_IDS["tst_game"] = ids.setdefault("tst_game", len(ids))
    japp, tapp = run_both(build, frames=4)
    w, d = tapp.world, defs(T)
    assert w.entity_count(d["MenuItem"]) == 1
    log = w.resource(d["Log"])
    assert (int(log.exits), int(log.enters), int(log.updates)) == (1, 1, 3)


def test_sub_and_computed_states_match_jax():
    """A sub-state (initialised on parent entry, OnEnter / OnExit on its
    own transitions, `exists`) and a computed overlay state."""
    def build(P):
        S = P.state
        app = _app(P, "tst_game2")
        S.add_sub_state(app, "tst_battle", 0, [0, 1], parent="tst_game2",
                        parent_value=PLAYING)
        S.add_computed_state(
            app, "tst_overlay", values=[0, 1], sources=["tst_game2"],
            compute=lambda s: P.where(s["tst_game2"] == PLAYING, 0, 1),
            initial=1)
        app.add_systems(S.OnEnter("tst_battle", 0),
                        _counter(P, "enters", "on_enter_select"))
        app.add_systems(S.OnExit("tst_battle", 0),
                        _counter(P, "exits", "on_exit_select"))
        app.add_systems(S.OnExit("tst_overlay", 1),
                        _counter(P, "updates", "on_overlay_off"))
        app.add_systems(P.root.Update, _counter(P, "updates", "in_select"),
                        run_if=S.in_state("tst_battle", 0))
        return app

    def script(P, app, k):
        if k == 1:
            app.world.set_resource_field("state_tst_game2", "next", PLAYING)
        elif k == 3:
            app.world.set_resource_field("state_tst_battle", "next", 1)
        elif k == 5:
            app.world.set_resource_field("state_tst_game2", "next", PAUSED)

    _, tapp = run_both(build, frames=7, script=script)
    assert not bool(tapp.world.resource("state_tst_battle").exists)
    assert int(tapp.world.resource("state_tst_overlay").current) == 1


def test_stepping_matches_jax():
    """Stepping pulls the schedule out of the frame; step() runs one
    system, continue_() the rest; disable() puts it back."""
    names = {}

    def build(P):
        app = P.root.App(capacity=4, **P.kw)
        app.add_plugins(P.time.TimePlugin())
        app.insert_resource(defs(P)["Log"]())
        app.add_systems(P.root.Update, _counter(P, "enters", "sys_a"),
                        _counter(P, "exits", "sys_b"), chain=True)
        app._st = P.stepping.Stepping(app).add_schedule(P.root.Update)
        names[P.name] = []
        return app

    def script(P, app, k):
        got = names[P.name]
        if k == 1:
            app._st.enable()
        elif k == 2:
            got += [app._st.step(), app._st.continue_(), app._st.step()]
        elif k == 3:
            app._st.disable()

    run_both(build, frames=5, script=script)
    assert names[J.name] == names[T.name] == ["sys_a", ["sys_b"], "sys_a"]


@pytest.mark.parametrize("name", ["states", "sub_states", "system_stepping"])
def test_state_twin_matches_jax(name):
    jstates, _ = run_jax(name)
    tstates, _ = run_port(name)
    for a, b in zip(jstates, tstates):
        assert_same_state(a, b)


def test_computed_states_twin_matches_stored_jax():
    tstates, _ = run_port("computed_states")
    for a, b in zip(load_states("computed_states"), tstates):
        assert_same_state(a, b)


def test_load_world_carries_states_mid_run():
    """A JAX states world after three frames (its state resource's
    current / next / prev, the ticks, each system's last run) loaded into
    the port's twin: the transition of the next frames runs alike."""
    from bevy_tpu_torch.interop import load_world
    jstates, japp = run_jax("states", frames=3)
    mod = twin("states")
    tapp = mod.build_app(device="cpu")
    tapp.update(dt=mod.DT)
    load_world(tapp.world, jax.device_get(japp.world.state))
    assert_same_state(jstates[-1], host_state(tapp))
    for _ in range(3):
        japp.update(dt=mod.DT)
        tapp.update(dt=mod.DT)
        assert_same_state(jax.tree.map(np.array,
                                       jax.device_get(japp.world.state)),
                          host_state(tapp))
    assert int(tapp.world.resource("state_game").current) == 1
