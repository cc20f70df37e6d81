"""bevy_tpu_torch ECS, App, Time and Transform vs the JAX package.

Both packages get the same worlds (numpy-made data) and the same systems,
written once per package; every comparison is exact unless it says
otherwise (float clocks: the same f32 operations in the same order).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bevy_tpu as jb
from bevy_tpu.time import TimePlugin as JTimePlugin
from bevy_tpu.transform import ChildOf as JChildOf
from bevy_tpu.transform import GlobalTransform as JGlobalTransform
from bevy_tpu.transform import Transform as JTransform
from bevy_tpu.transform import TransformPlugin as JTransformPlugin

import bevy_tpu_torch as tb
from bevy_tpu_torch.interop import state_from_numpy
from bevy_tpu_torch.time import TimePlugin as TTimePlugin
from bevy_tpu_torch.transform import ChildOf as TChildOf
from bevy_tpu_torch.transform import GlobalTransform as TGlobalTransform
from bevy_tpu_torch.transform import Transform as TTransform
from bevy_tpu_torch.transform import TransformPlugin as TTransformPlugin

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))


# distinct names: the JAX registry is process-wide, and other test
# modules own the plain "hp" / "tag" storage names
@jb.component
class PortHp:
    value = jb.field(())


@jb.component
class PortTag:
    pass


@tb.component(name="port_hp")
class THp:
    value = tb.field(())


@tb.component(name="port_tag")
class TTag:
    pass


def _rng_trs(n, seed):
    rng = np.random.RandomState(seed)
    t = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    r = rng.normal(size=(n, 4)).astype(np.float32)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    s = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
    return t, r, s


def test_spawn_batch_and_query_masks():
    hp = np.arange(10, dtype=np.float32) * 1.5
    jw, tw = jb.World(capacity=16), tb.World(capacity=16, device="cpu")
    jw.spawn_batch([PortHp(value=hp)], 10)
    tw.spawn_batch([THp(value=hp)], 10)
    jw.spawn_batch([PortHp(value=7.0), PortTag()], 3)
    tw.spawn_batch([THp(value=7.0), TTag()], 3)
    assert np.array_equal(np.asarray(jw.column(PortHp, "value")),
                          tw.column(THp, "value").numpy())
    assert np.array_equal(jw.query_rows(PortHp, PortTag),
                          tw.query_rows(THp, TTag))
    # past capacity: both pools grow to 32 rows
    jw.spawn_batch([PortHp(value=1.0)], 10)
    tw.spawn_batch([THp(value=1.0)], 10)
    assert jw.capacity == tw.capacity == 32
    assert np.array_equal(np.asarray(jw.column(PortHp, "value")),
                          tw.column(THp, "value").numpy())

    jmasks, tmasks = {}, {}

    @jb.system
    def jsys(a=jb.Query(PortHp), b=jb.Query(PortHp, jb.With(PortTag)),
             c=jb.Query(PortHp, jb.Without(PortTag))):
        jmasks.update(a=a.mask, b=b.mask, c=c.mask)

    @tb.system
    def tsys(a=tb.Query(THp), b=tb.Query(THp, tb.With(TTag)),
             c=tb.Query(THp, tb.Without(TTag))):
        tmasks.update(a=a.mask, b=b.mask, c=c.mask)

    jsys.init_state(jw)
    tsys.init_state(tw)
    jsys.run(jw.state, jw)
    tsys.run(tw.state, tw)
    for k in "abc":
        assert np.array_equal(np.asarray(jmasks[k]), tmasks[k].numpy()), k


def _ordered_app(pkg):
    """Three systems added in reverse of their required order: set
    ordering must run `seed` (set A), then `double` (set B), then `inc`."""
    H = {"j": PortHp, "t": THp}[pkg]
    m = {"j": jb, "t": tb}[pkg]
    app = jb.App(capacity=8) if pkg == "j" else tb.App(capacity=8,
                                                        device="cpu")
    app.world.spawn_batch([H(value=1.0)], 4)

    @m.system
    def inc(q=m.Query(H)):
        q.port_hp.value = q.port_hp.value + 1.0

    @m.system
    def double(q=m.Query(H)):
        q.port_hp.value = q.port_hp.value * 2.0

    @m.system
    def seed(q=m.Query(H)):
        q.port_hp.value = q.port_hp.value * 0.0 + 3.0

    app.configure_set(m.Update, "B", after="A")
    app.add_systems(m.Update, inc, after="B")
    app.add_systems(m.Update, double, in_set="B")
    app.add_systems(m.Update, seed, in_set="A")
    return app


def test_system_order_by_sets():
    japp = _ordered_app("j")
    tapp = _ordered_app("t")
    jorder = [e.system.name for e in japp.schedule(jb.Update).build_order()]
    torder = [e.system.name for e in tapp.schedule(tb.Update).build_order()]
    assert jorder == torder == ["seed", "double", "inc"]
    japp.update(dt=1 / 60)
    tapp.update(dt=1 / 60)
    jv = np.asarray(japp.world.column(PortHp, "value"))
    tv = tapp.world.column(THp, "value").numpy()
    assert np.array_equal(jv, tv)
    assert tv[0] == 7.0


def test_time_after_frames_at_fixed_dt():
    japp = jb.App(capacity=8).add_plugins(JTimePlugin())
    tapp = tb.App(capacity=8, device="cpu").add_plugins(TTimePlugin())
    for dt in [1 / 60] * 5 + [0.3, 1 / 30]:   # 0.3 > max_delta: clamped
        japp.update(dt=dt)
        tapp.update(dt=dt)
    jres, tres = jax.device_get(japp.world.state["res"]), tapp.world.state["res"]
    for name in ("time", "time_real", "time_virtual", "time_fixed",
                 "frame_count"):
        for f, v in jres[name].items():
            assert np.array_equal(np.asarray(v), tres[name][f].numpy()), \
                (name, f)
    assert int(tres["frame_count"]["count"]) == 7 == tapp.frame


def test_fixed_update_steps_match():
    """With a FixedUpdate system registered the fixed loop runs it once
    per whole timestep of accumulated time, at most 8 times a frame."""
    apps = {}
    for pkg, m, TP, H, kw in (("j", jb, JTimePlugin, PortHp, {}),
                              ("t", tb, TTimePlugin, THp, {"device": "cpu"})):
        app = m.App(capacity=4, **kw).add_plugins(TP())
        app.world.spawn(H(value=0.0))

        @m.system
        def count(q=m.Query(H)):
            q.port_hp.value = q.port_hp.value + 1.0

        app.add_systems(m.FixedUpdate, count)
        for dt in (0.01, 0.02, 0.05, 0.2):
            app.update(dt=dt)
        apps[pkg] = app
    jv = np.asarray(apps["j"].world.column(PortHp, "value"))
    tv = apps["t"].world.column(THp, "value").numpy()
    assert np.array_equal(jv, tv) and tv[0] > 0
    jf = jax.device_get(apps["j"].world.state["res"]["time_fixed"])
    tf = apps["t"].world.state["res"]["time_fixed"]
    for f in ("overstep", "elapsed"):
        assert np.array_equal(np.asarray(jf[f]), tf[f].numpy()), f


def test_flat_propagation():
    t, r, s = _rng_trs(20, 0)
    japp = jb.App(capacity=32).add_plugins(JTransformPlugin())
    tapp = tb.App(capacity=32, device="cpu").add_plugins(TTransformPlugin())
    japp.world.spawn_batch([JTransform(translation=t, rotation=r, scale=s),
                            JGlobalTransform()], 20)
    tapp.world.spawn_batch([TTransform(translation=t, rotation=r, scale=s),
                            TGlobalTransform()], 20)
    japp.update(dt=1 / 60)
    tapp.update(dt=1 / 60)
    for f in ("translation", "rotation", "scale"):
        jv = np.asarray(japp.world.column(JGlobalTransform, f))
        tv = tapp.world.column(TGlobalTransform, f).numpy()
        assert np.array_equal(jv, tv), f
        assert np.array_equal(tv[:20], {"translation": t, "rotation": r,
                                        "scale": s}[f])


def test_level_synchronous_propagation():
    """Roots, then three levels of children (ChildOf depth 1..3), composed
    level by level: f32 TRS composition in the same operation order in
    both packages; XLA fuses multiply-adds that eager PyTorch rounds
    twice, and three levels compound that to a few ulp (rtol 1e-5)."""
    t, r, s = _rng_trs(10, 1)
    levels = ((slice(0, 3), None, 0), (slice(3, 6), [0, 1, 2], 1),
              (slice(6, 9), [3, 4, 3], 2), (slice(9, 10), [6], 3))
    apps = {}
    for pkg, m, TP, Tr, GT, CO, kw in (
            ("j", jb, JTransformPlugin, JTransform, JGlobalTransform, JChildOf,
             {}),
            ("t", tb, TTransformPlugin, TTransform, TGlobalTransform, TChildOf,
             {"device": "cpu"})):
        app = m.App(capacity=16, **kw).add_plugins(TP())
        for sl, parent, depth in levels:
            comps = [Tr(translation=t[sl], rotation=r[sl], scale=s[sl]), GT()]
            if parent is not None:
                comps.append(CO(parent=np.asarray(parent, np.int32),
                                depth=depth))
            app.world.spawn_batch(comps, sl.stop - sl.start)
        app.update(dt=1 / 60)
        apps[pkg] = app
    for f in ("translation", "rotation", "scale"):
        np.testing.assert_allclose(
            apps["t"].world.column(TGlobalTransform, f).numpy(),
            np.asarray(apps["j"].world.column(JGlobalTransform, f)),
            rtol=1e-5, atol=1e-5)


def test_state_from_numpy_carries_the_many_cubes_world():
    """The JAX many_cubes world (build_app renders nothing) converted with
    state_from_numpy holds every column and resource of the torch twin's
    world, with the same dtypes."""
    import many_cubes
    import torch_many_cubes

    kw = dict(n_cubes=300, width=320, height=180, capacity=512,
              window_budget=4096)
    japp = many_cubes.build_app(backend="pallas_interpret", **kw)
    tapp = torch_many_cubes.build_app(device="cpu", **kw)
    state = state_from_numpy(jax.device_get(japp.world.state), "cpu")
    tstate = tapp.world.state
    assert set(tstate["comp"]) <= set(state["comp"])
    ncols = 0
    for name, store in tstate["comp"].items():
        for key in ("has", "added", "changed", "removed"):
            assert torch.equal(state["comp"][name][key] > 0,
                               store[key] > 0), (name, key)
        for f, col in store["f"].items():
            got = state["comp"][name]["f"][f]
            assert got.dtype == col.dtype, (name, f)
            assert torch.equal(got, col), (name, f)
            ncols += 1
    assert ncols >= 40
    missing = []
    for name, store in tstate["res"].items():
        for f, v in store.items():
            if f not in state["res"][name]:
                missing.append((name, f))
                continue
            got = state["res"][name][f]
            assert got.dtype == v.dtype and torch.equal(got, v), (name, f)
    # the port's one extra counter: clusters routed to the B2 fallback
    assert missing == [("render_stats", "fallback_clusters")]
    assert torch.equal(state["ent"]["alive"], tstate["ent"]["alive"])


def test_app_and_world_default_to_the_card():
    """App() and World() take the CUDA card unless the caller asks for the
    CPU; where there is no card they raise rather than fall back."""
    tapp = tb.App(capacity=8, device="cpu").add_plugins(TTimePlugin())
    tapp.update(dt=1 / 60)
    assert tapp.device.type == "cpu" and tapp.frame == 1
    if torch.cuda.is_available():
        assert tb.App(capacity=8).device.type == "cuda"
        assert tb.World(capacity=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.App(capacity=8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tb.World(capacity=8)
