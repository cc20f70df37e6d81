"""Holding a bevy_tpu_torch world against a bevy_tpu world, state for state.

`host_state(app)` takes a host copy of either package's world state
(nested dicts of numpy arrays); `assert_same_state(jax_tree, port_tree)`
compares two: liveness and generations, every component store (`has`,
`added`, `changed`, `removed` ticks, every field), every resource, message
and observer buffer, each system's `last_run` and Local stores (systems
matched by name, several of one name by their order), `tick` and `frame`.
Component and resource names are matched by their bare storage names,
since a class name two modules share is qualified by its module in either
package. Integer and bool values must be equal; float values within
rtol / atol (default 1e-6 / 1e-6).

`run_jax(name)` / `run_port(name)` drive the JAX example
examples/<name>.py and its twin examples/torch_<name>.py through the
twin's script and return the host states after each frame; `run_both`
does the same for a world a test builds with either package
(`packages()`).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
GOLDENS = ROOT / "tests" / "goldens"

def bare(name):
    return name.rsplit(".", 1)[-1].split("#", 1)[0]


def _np(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def host_state(app_or_world):
    """A host copy (nested dicts of numpy arrays) of a world's state."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return np.array(_np(t))
    return walk(getattr(app_or_world, "world", app_or_world).state)


def _by_bare(d):
    out = {}
    for k, v in d.items():
        if bare(k) in out:
            raise AssertionError(f"two stores of bare name {bare(k)!r}")
        out[bare(k)] = v
    return out


def _sys_groups(sys_state):
    out = {}
    for sid in sorted(sys_state, key=lambda s: int(s.rsplit("#", 1)[1])):
        out.setdefault(sid.rsplit("#", 1)[0], []).append(sys_state[sid])
    return out


def _cmp(a, b, path, rtol, atol):
    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict), path
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _cmp(a[k], b[k], path + (k,), rtol, atol)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=rtol, atol=atol, err_msg=str(path))
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b), (path, a, b)


def assert_same_state(jtree, ttree, rtol=1e-6, atol=1e-6, skip_res=()):
    """The whole world state of both packages (see the module doc)."""
    for key in ("ent", "tick", "frame"):
        _cmp(jtree[key], ttree[key], (key,), rtol, atol)
    for key in ("comp", "msg", "obs"):
        _cmp(_by_bare(jtree.get(key, {})), _by_bare(ttree.get(key, {})),
             (key,), rtol, atol)
    jres = {k: v for k, v in _by_bare(jtree["res"]).items()
            if k not in skip_res}
    tres = {k: v for k, v in _by_bare(ttree["res"]).items()
            if k not in skip_res}
    _cmp(jres, tres, ("res",), rtol, atol)
    js, ts = _sys_groups(jtree["sys"]), _sys_groups(ttree["sys"])
    assert {k: len(v) for k, v in js.items()} == \
        {k: len(v) for k, v in ts.items()}, (sorted(js), sorted(ts))
    for name in js:
        for k, (a, b) in enumerate(zip(js[name], ts[name])):
            _cmp(a, b, ("sys", name, k), rtol, atol)


def twin(name):
    return importlib.import_module(f"torch_{name}")


def run_port(name, frames=5):
    """The port's twin on the CPU: its host state after each frame."""
    mod = twin(name)
    app = mod.build_app(device="cpu")
    out = []
    for k in range(frames):
        mod.script(app, k)
        app.update(dt=mod.DT)
        out.append(host_state(app))
    return out, app


@contextlib.contextmanager
def jax_example(name):
    """The JAX example module `name`, leaving the JAX package's storage-name
    registry and sys.modules as they were: several JAX examples share
    class names (Score, Trace, Stats, ...), and the first module imported
    in a process takes the plain storage name, which the JAX example
    tests read. A later import then sees the process as if this one had
    not happened."""
    jcomp = importlib.import_module("bevy_tpu.ecs.component")
    names = dict(jcomp._NAMES)
    fresh = name not in sys.modules
    try:
        yield importlib.import_module(name)
    finally:
        jcomp._NAMES.clear()
        jcomp._NAMES.update(names)
        if fresh:
            sys.modules.pop(name, None)


def run_jax(name, frames=5):
    """The JAX example driven by the twin's script: its host state after
    each frame."""
    import jax

    mod = twin(name)
    with jax_example(name) as jmod:
        app = jmod.build_app()
    if isinstance(app, tuple):      # observer_propagation's (app, ...)
        app = app[0]
    out = []
    for k in range(frames):
        mod.script(app, k)
        app.update(dt=mod.DT)
        out.append(jax.tree.map(np.array, jax.device_get(app.world.state)))
    return out, app


# -- stored JAX states (the examples that fail in whole JAX runs) ---------

def golden_key(name):
    """A hash of what makes the stored states of `name`: the JAX example's
    source and the twin's script and dt."""
    import hashlib
    import inspect
    mod = twin(name)
    text = "\n".join([name, (ROOT / "examples" / f"{name}.py").read_text(),
                      inspect.getsource(mod.script), repr(mod.DT)])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            if not v:
                out[key + "/"] = np.zeros(0)
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        if parts[-1]:
            d[parts[-1]] = v
    return tree


def save_states(name, states):
    """Store JAX states as tests/goldens/ecs_<name>.npz, keyed in
    torch_goldens.json."""
    flat = {}
    for i, s in enumerate(states):
        flat.update({f"{i}/{k}": v for k, v in _flatten(s).items()})
    np.savez_compressed(GOLDENS / f"ecs_{name}.npz", **flat)
    keys_path = GOLDENS / "torch_goldens.json"
    keys = json.loads(keys_path.read_text())
    keys[f"ecs_{name}"] = golden_key(name)
    keys_path.write_text(json.dumps(keys, indent=1, sort_keys=True) + "\n")


def load_states(name):
    keys = json.loads((GOLDENS / "torch_goldens.json").read_text())
    assert keys.get(f"ecs_{name}") == golden_key(name), \
        f"stored JAX states of {name} are stale: python " \
        f"tests/make_torch_goldens.py ecs_{name}"
    with np.load(GOLDENS / f"ecs_{name}.npz") as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return [tree[str(i)] for i in range(len(tree))]


# -- both packages behind one namespace each ----------------------------

@functools.lru_cache(maxsize=None)
def packages():
    """(J, T): the JAX package and the port, each as a namespace of the
    modules the tests build worlds with, the array helpers that differ
    (where, i32, f32, arange, zeros), `kw` for App / World (the port's
    device) and `name`. A system body written against a namespace runs
    under either package."""
    from types import SimpleNamespace

    import jax.numpy as jnp
    import torch

    def mods(pkg):
        names = {"root": "", "ecs": ".ecs", "comp": ".ecs.component",
                 "query": ".ecs.query", "system": ".ecs.system",
                 "sched": ".ecs.schedule", "world": ".ecs.world",
                 "obs": ".ecs.observer", "rel": ".ecs.relationship",
                 "state": ".state", "stepping": ".stepping",
                 "input": ".input", "time": ".time", "tf": ".transform",
                 "math": ".math", "app": ".app.app"}
        return {k: importlib.import_module(pkg + v) for k, v in names.items()}

    J = SimpleNamespace(
        **mods("bevy_tpu"), name="jax", kw={}, where=jnp.where,
        i32=lambda x: jnp.asarray(x, jnp.int32),
        f32=lambda x: jnp.asarray(x, jnp.float32),
        arange=lambda n: jnp.arange(n, dtype=jnp.int32),
        zeros=lambda shape, dt="f": jnp.zeros(
            shape, {"f": jnp.float32, "i": jnp.int32, "b": jnp.bool_}[dt]),
        int32=jnp.int32, float32=jnp.float32, bool_=jnp.bool_)
    T = SimpleNamespace(
        **mods("bevy_tpu_torch"), name="torch", kw={"device": "cpu"},
        where=torch.where,
        i32=lambda x: torch.as_tensor(x).to(torch.int32),
        f32=lambda x: torch.as_tensor(x).to(torch.float32),
        arange=lambda n: torch.arange(n, dtype=torch.int32),
        zeros=lambda shape, dt="f": torch.zeros(
            shape, dtype={"f": torch.float32, "i": torch.int32,
                          "b": torch.bool}[dt]),
        int32=torch.int32, float32=torch.float32, bool_=torch.bool)
    return J, T


def run_both(build, frames=5, script=None, dt=1 / 60, rtol=1e-6, atol=1e-6,
             skip_res=()):
    """build(P) -> App for each package; `frames` frames, `script(P, app,
    k)` before frame k; the whole states held equal after every frame.
    Returns the two apps."""
    J, T = packages()
    japp, tapp = build(J), build(T)
    for k in range(frames):
        for P, app in ((J, japp), (T, tapp)):
            if script is not None:
                script(P, app, k)
            app.update(dt=dt)
        assert_same_state(host_state(japp), host_state(tapp), rtol, atol,
                          skip_res)
    return japp, tapp
