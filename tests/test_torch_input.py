"""bevy_tpu_torch's input, frame inputs, timers, the App's host systems,
startup, exit and one-shot runs, and alien_cake_addict against the JAX
package: the same worlds built with either package
(torch_ecs_parity.packages), the whole state held equal after every frame
(ints and bools exactly, floats within 1e-6). alien_cake_addict's JAX
outputs are stored (tests/make_torch_goldens.py: a JAX 128x80 frame takes
minutes in interpret mode): its trajectory over 240 frames of the
scripted chase, exact, and its 128x80 frame after 190 frames on the
group route (JAX in pallas_interpret) and the general route, within the
golden rule (under 1% of pixels drift by more than 8).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_scenes
from torch_ecs_parity import packages, run_both

J, T = packages()
GOLD = Path(__file__).resolve().parent / "goldens"
_DEFS = {}


def defs(P):
    if P.name in _DEFS:
        return _DEFS[P.name]
    f = P.comp.field

    @P.comp.component(name="tin_paddle")
    class Paddle:
        x = f(())

    @P.comp.component(name="tin_p")
    class Pp:
        value = f(2)

    @P.comp.resource(name="tin_hits")
    class Hits:
        n = f((), P.int32)
        t = f(())

    _DEFS[P.name] = out = dict(Paddle=Paddle, P=Pp, Hits=Hits)
    return out


def _input_app(P):
    app = P.root.App(capacity=8, **P.kw)
    app.add_plugins(P.time.TimePlugin(), P.input.InputPlugin())
    return app


def test_keyboard_mouse_gamepad_match_jax():
    """pressed / just_pressed / just_released, mouse position, delta and
    wheel, gamepad axes and buttons, and a game system reading them."""
    K = T.input.KeyCode

    def build(P):
        app = _input_app(P)
        d = defs(P)

        @P.system.system(name="move")
        def move(q=P.query.Query(d["Paddle"]), kb=P.query.Res("keyboard")):
            right = P.where(kb.pressed[K.ArrowRight], 1.0, 0.0)
            left = P.where(kb.pressed[K.ArrowLeft], 1.0, 0.0)
            q.tin_paddle.x = q.tin_paddle.x + right - left

        app.add_systems(P.root.Update, move)
        app.world.spawn(d["Paddle"]())
        return app

    def script(P, app, k):
        i = app.input
        if k == 1:
            i.press(K.Space)
            i.press(K.ArrowRight)
            i.move_to(100.0, 50.0)
            i.press_mouse(T.input.MouseButton.Left)
        elif k == 3:
            i.release(K.Space)
            i.release(K.ArrowRight)
            i.press(K.ArrowLeft)
            i.move_to(110.0, 45.0)
            i.wheel(0.0, -2.0)
            i.set_axis(1, 0.5)
            i.set_gamepad_button(3)
            i.release_mouse(T.input.MouseButton.Left)

    _, tapp = run_both(build, frames=5, script=script)
    kb = tapp.world.resource("keyboard")
    assert not kb.pressed[K.Space] and kb.pressed[K.ArrowLeft]
    assert np.allclose(tapp.world.resource("mouse").position, [110, 45])


def test_touch_and_gestures_match_jax():
    def script(P, app, k):
        i = app.input
        if k == 1:
            i.touch(0, 0.0, 0.0)
            i.touch(1, 100.0, 0.0)
        elif k == 3:
            i.touch(1, 150.0, 0.0)
        elif k == 4:
            i.touch(1, 0.0, 150.0)
        elif k == 5:
            i.touch_end(1)

    _, tapp = run_both(_input_app, frames=6, script=script)
    t = tapp.world.resource("touches")
    assert bool(t.just_released[1]) and float(t.pinch_delta) == 0.0


def test_frame_inputs_are_copied_in_each_frame():
    """register_frame_input channels (bool, float, int) reach frame_input
    each frame; a frame's inputs are one host-to-device copy."""
    def build(P):
        app = P.root.App(capacity=4, **P.kw)
        app.add_plugins(P.time.TimePlugin())
        src = {"n": 0}
        app._src = src
        app.register_frame_input("flags", np.zeros(3, bool),
                                 lambda: np.arange(3) < src["n"] % 4)
        app.register_frame_input("level", np.zeros((2, 2), np.float32),
                                 lambda: np.full((2, 2), src["n"] * 0.5))
        app.register_frame_input("count", np.zeros((), np.int32),
                                 lambda: np.int32(src["n"] * 3))
        d = defs(P)
        app.insert_resource(d["Hits"]())

        @P.system.system(name="read_inputs")
        def read_inputs(fin=P.query.Res("frame_input"),
                        h=P.query.ResMut(d["Hits"])):
            h.n = h.n + fin.count + P.i32(fin.flags).sum()
            h.t = h.t + fin.level.sum() + fin.dt

        app.add_systems(P.root.Update, read_inputs)
        return app

    def script(P, app, k):
        app._src["n"] = k

    _, tapp = run_both(build, frames=5, script=script)
    assert int(tapp.world.resource(defs(T)["Hits"]).n) == 36


def test_timers_match_jax():
    """timer_new / timer_tick over a column of one-shot and repeating
    timers: the same elapsed, finished and just-finished values."""
    dur = np.asarray([0.5, 0.25, 1.0, 0.3], np.float32)
    rep = np.asarray([False, True, False, True])
    jt = J.time.timer_new(dur, rep, shape=(4,))
    tt = T.time.timer_new(torch.from_numpy(dur), torch.from_numpy(rep),
                          shape=(4,))
    for dt in (0.1, 0.2, 0.3, 0.05, 0.6):
        jt, jj = J.time.timer_tick(jt, dt)
        tt, tj = T.time.timer_tick(tt, dt)
        assert np.array_equal(np.asarray(jj), tj.numpy())
        for k in jt:
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                       rtol=1e-6, atol=1e-6)


def test_app_startup_host_systems_exit_and_one_shot_match_jax():
    """Startup runs once; a host system edits structure mid-frame (spawns
    seen by a later device system); run_if on FrameCount; FixedUpdate
    steps; an AppExit message ends run(); a registered system runs on
    demand."""
    def build(P):
        d = defs(P)
        app = P.root.App(capacity=16, **P.kw)
        app.add_plugins(P.time.TimePlugin())
        app.insert_resource(d["Hits"]())
        app.insert_resource(P.time.TimeFixed(timestep=0.1))
        Hits, Pp = d["Hits"], d["P"]

        @P.system.system(name="init")
        def init(h=P.query.ResMut(Hits)):
            h.n = h.n + 1000

        @P.system.system(host=True, name="spawner")
        def spawner(world):
            if world.entity_count(Pp) < 3:
                world.spawn(Pp(value=(9.0, 9.0)))

        @P.system.system(name="count")
        def count(q=P.query.Query(Pp), h=P.query.ResMut(Hits)):
            h.n = h.n + q.count()

        @P.system.system(name="after_two")
        def after_two(f=P.query.Res(P.time.FrameCount)):
            return f.count > 2

        @P.system.system(name="tick")
        def tick(h=P.query.ResMut(Hits), t=P.query.Res(P.time.Time)):
            h.t = h.t + t.delta

        @P.system.system(name="quit_now")
        def quit_now(w=P.ecs.MessageWriter(P.app.AppExit, budget=1)):
            w.send_one(code=0)

        app.add_systems(P.root.Startup, init)
        app.add_systems(P.root.Update, spawner)
        app.add_systems(P.root.PostUpdate, count)
        app.add_systems(P.root.FixedUpdate, tick)
        app.add_systems(P.root.Last, quit_now, run_if=after_two)
        app._oneshot = app.register_system(count)
        return app

    def script(P, app, k):
        if k == 2:
            app.run_system(app._oneshot)

    japp, tapp = run_both(build, frames=4, script=script, dt=0.24)
    assert tapp.should_exit() and japp.should_exit()
    for app in (japp, tapp):
        app.run(max_frames=10, dt=0.01)
    assert tapp.frame == japp.frame == 5


def _golden_ok(name):
    keys = json.loads((GOLD / "torch_goldens.json").read_text())
    assert keys.get(name) == torch_scenes.golden_key(name), \
        f"stored {name} is stale: python tests/make_torch_goldens.py {name}"


def test_alien_cake_addict_trajectory_matches_stored_jax():
    """240 frames of the scripted chase at 128x80 on the group route: the
    player's and the cake's cells and the score a frame equal the JAX
    example's, and a cake is eaten."""
    import torch_alien_cake_addict as mod
    _golden_ok("alien_trajectory")
    want = np.load(GOLD / "alien_trajectory.npz")["rows"]
    _, rows = torch_scenes.alien_world(mod, {"device": "cpu"}, 128, 80,
                                       "auto", len(want))
    assert np.array_equal(np.asarray(rows, np.int32), want)
    assert rows[-1][4] > 0


@pytest.mark.parametrize("name,backend", [("alien_f190", "auto"),
                                          ("alien_f190_xla", "xla")])
def test_alien_cake_addict_frame_matches_stored_jax(name, backend):
    """The 128x80 frame after 190 frames of the chase (the cake live,
    the player on its way) against the JAX image: the group route (B1 /
    B2's plain versions here) and the general route."""
    import torch_alien_cake_addict as mod
    from PIL import Image
    _golden_ok(name)
    img, rows = torch_scenes.alien_world(mod, {"device": "cpu"}, 128, 80,
                                         backend, 190)
    want = np.asarray(Image.open(GOLD / f"{name}.png")).astype(int)
    diff = np.abs(img - want).max(-1)
    assert float((diff > 8).mean()) < 0.01, (diff > 8).mean()
    assert rows[-1][2] >= 0
