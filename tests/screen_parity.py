"""Helpers of the screen-pass parity tests (tests/test_torch_post.py,
test_torch_screen_passes.py, test_torch_motion_ssaa.py): each package's
system of a plugin, the JAX one run under jax.jit on namespace views (as
the JAX package's jitted frame runs it), the same seeded inputs for both,
and the comparisons."""

import sys
from pathlib import Path
from types import SimpleNamespace as ns

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_scenes as ts  # noqa: E402

H, W = ts.SCREEN_H, ts.SCREEN_W
TOL = dict(rtol=1e-5, atol=1e-5)


def modules():
    """(JAX scene modules, port scene modules): torch_scenes.SCENE_MODULES
    of each package, imported."""
    import importlib
    return ({k: importlib.import_module(f"bevy_tpu{v}")
             for k, v in ts.SCENE_MODULES.items()},
            ts.port_scene_modules())


def T(a):
    return torch.tensor(np.asarray(a))


def systems(name, make_plugin, h=H, w=W, module="post", label=None):
    """(JAX system, port system) named `name`, as each package's plugin
    (`make_plugin(m[module])`, m the scene modules) adds it to an App of
    an h x w target, in the Render schedule (or `label`, a main_schedule
    name)."""
    out = []
    for m, kw in zip(modules(), ({}, {"device": "cpu"})):
        app = m["root"].App(capacity=4, **kw)
        app.add_plugins(m["render"].RenderPlugin(width=w, height=h),
                        make_plugin(m[module]))
        sched = app.schedule(m["plug"].Render if label is None
                             else getattr(m["root"], label))
        out.append(next(e.system for e in sched.entries
                        if e.system.name == name))
    return out


def _tree(n):
    return {k: _tree(v) if isinstance(v, ns) else v
            for k, v in vars(n).items()}


def _update(n, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            _update(getattr(n, k), v)
        else:
            setattr(n, k, v)


_JITTED = {}


def call_jax(sys_j, jit=True, **views):
    """Run a JAX system's body on namespace views, under jax.jit (as the
    JAX package's frame runs it) or, for the long unrolled marches whose
    compile would dominate a test, op by op (jit=False), writing what it
    assigns back into the namespaces."""
    if not jit:
        sys_j.fn(**views)
        return
    def body(tree):
        views_ = {k: ns(**{a: ns(**b) if isinstance(b, dict) else b
                           for a, b in v.items()}) for k, v in tree.items()}
        sys_j.fn(**views_)
        return {k: _tree(v) for k, v in views_.items()}

    if sys_j not in _JITTED:
        _JITTED[sys_j] = jax.jit(body)
    out = _JITTED[sys_j]({k: _tree(v) for k, v in views.items()})
    for k, v in views.items():
        _update(v, out[k])


def targets(seed=0, gplanes=19, **extra):
    """(JAX target, port target) namespaces over screen_planes(seed,
    gplanes=gplanes), with `extra` numpy planes beside them."""
    color, depth, g = ts.screen_planes(seed, gplanes=gplanes)
    tj = ns(color=jnp.asarray(color), depth=jnp.asarray(depth),
            gbuffer=jnp.asarray(g), **{k: jnp.asarray(v)
                                       for k, v in extra.items()})
    tt = ns(color=T(color), depth=T(depth), gbuffer=T(g),
            **{k: T(v) for k, v in extra.items()})
    return tj, tt


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               **(tol or TOL))


def srgb(c):
    x = np.clip(np.asarray(c, np.float64)[:3], 0, 1)
    s = np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)
    return np.round(s * 255).astype(int)


def flips(port, ref, label):
    """Pixels past the tolerance and the golden rule, printed and held
    under 1% of the pixels."""
    p, r = np.asarray(port), np.asarray(ref)
    bad = ~np.isclose(p, r, **TOL).all(0)
    drift = np.abs(srgb(p) - srgb(r)).max(0) > 8
    print(f"{label}: {int(bad.sum())} of {bad.size} pixels differ past "
          f"rtol/atol 1e-5, {int(drift.sum())} drift > 8 in sRGB")
    assert bad.mean() < 0.01 and drift.mean() < 0.01
    return int(bad.sum())
