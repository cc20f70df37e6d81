"""bevy_tpu_torch's post-processing passes (render/post.py) against the
JAX package's, on the CPU.

Each pass's system, as each package's plugin builds it, is called on the
same inputs: numpy planes made from a seed (tests/torch_scenes.py
screen_planes: an HDR colour (4, 50, 66), a reverse-z depth with ids in
its low mantissa bits, a 19-plane G-buffer) and the camera rows of
screen_camera (a masked row first). Tolerance: rtol / atol 1e-5. The
passes that make threshold decisions (FXAA, SMAA) may flip a pixel where
an ulp of luminance lands on the other side: the test prints how many
pixels differ past the tolerance and holds them, and the sRGB images,
under the golden rule of tests/test_goldens.py (under 1% of pixels). TAA,
motion blur and auto exposure run 3 frames with a moving camera and a
new colour each frame, their state carried in each package's form.
"""

import sys
from pathlib import Path
from types import SimpleNamespace as ns

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

import torch_scenes as ts  # noqa: E402
from screen_parity import (  # noqa: E402
    T, call_jax, close, flips, systems, targets,
)

H, W = ts.SCREEN_H, ts.SCREEN_W


@pytest.mark.parametrize("mode,exposure", [(0, 1.0), (1, 1.0), (2, 0.7),
                                           (3, 1.0), (3, 1.6), (4, 1.3)],
                         ids=["none", "reinhard", "reinhard_lum", "aces",
                              "aces_exposed", "lut"])
def test_tonemap_matches_jax(mode, exposure):
    sj, st = systems("tonemap_pass", lambda p: p.TonemappingPlugin(
        mode=mode, exposure=exposure))
    tj, tt = targets(1)
    call_jax(sj, target=tj)
    st.fn(target=tt)
    close(tt.color, tj.color)


def test_neutral_lut_is_the_same_table():
    from bevy_tpu.render import post as pj
    from bevy_tpu_torch.render import post as pt
    np.testing.assert_array_equal(pt.neutral_lut(), np.asarray(
        pj.neutral_lut()))


@pytest.mark.parametrize("name,make", [
    ("bloom_pass", lambda p: p.BloomPlugin(threshold=0.8, intensity=0.35)),
    ("bloom_pass", lambda p: p.BloomPlugin(sigma=3.0, downsample=3)),
    ("ssao_pass", lambda p: p.SsaoPlugin(intensity=1.5)),
    ("ssao_pass", lambda p: p.SsaoPlugin(radius=0.5, samples=12)),
    ("dof_pass", lambda p: p.DepthOfFieldPlugin(focal_distance=3.0,
                                                focal_range=1.5)),
    ("chromatic_aberration_pass",
     lambda p: p.ChromaticAberrationPlugin(strength=3.0)),
    ("cas_pass", lambda p: p.CasPlugin(strength=0.5)),
], ids=["bloom", "bloom_ds3", "ssao", "ssao_12", "dof", "chromatic", "cas"])
def test_image_pass_matches_jax(name, make):
    sj, st = systems(name, make)
    tj, tt = targets(2)
    call_jax(sj, target=tj)
    st.fn(target=tt)
    close(tt.color, tj.color)


@pytest.mark.parametrize("name,make", [
    ("fxaa_pass", lambda p: p.FxaaPlugin()),
    ("smaa_pass", lambda p: p.SmaaPlugin()),
    ("smaa_pass", lambda p: p.SmaaPlugin(edge_threshold=0.1, max_search=4)),
], ids=["fxaa", "smaa", "smaa_short"])
def test_edge_filter_matches_jax(name, make):
    sj, st = systems(name, make)
    tj, tt = targets(3)
    call_jax(sj, target=tj)
    st.fn(target=tt)
    flips(tt.color, tj.color, name)
    assert not torch.equal(tt.color, T(ts.screen_planes(3)[0])), \
        "the filter changed nothing"


def test_shift_is_edge_clamped_copy():
    from bevy_tpu.render.post import _shift as shift_j
    from bevy_tpu_torch.render.post import _shift as shift_t
    x = np.random.RandomState(4).normal(size=(3, 7, 9)).astype(np.float32)
    for dy, dx in ((0, 1), (2, 0), (-3, 1), (1, -2), (-6, 8), (0, -1)):
        np.testing.assert_array_equal(shift_t(T(x), dy, dx).numpy(),
                                      np.asarray(shift_j(jnp.asarray(x), dy,
                                                         dx)))


def _motion_planes(seed):
    rng = np.random.RandomState(seed)
    depth = ts.screen_planes(0)[1]
    m = rng.uniform(-2.5, 2.5, (3, H, W)).astype(np.float32)
    m[2] = ((rng.uniform(size=(H, W)) < 0.5) & (depth > 0)).astype(
        np.float32)
    return m


@pytest.mark.parametrize("motion", [False, True],
                         ids=["reprojection", "motion_vectors"])
def test_taa_three_frames_matches_jax(motion):
    sj, st = systems("taa_pass", lambda p: p.TaaPlugin(blend=0.2))
    sj_state = ns(history=jnp.zeros((4, H, W)), prev_vp=jnp.eye(4),
                  valid=jnp.zeros((), bool))
    st_state = ns(history=torch.zeros((4, H, W)), prev_vp=torch.eye(4),
                  valid=torch.zeros((), dtype=torch.bool))
    for frame in range(3):
        extra = {"motion": _motion_planes(frame)} if motion else {}
        tj, tt = targets(10 + frame, **extra)
        cj, _ = ts.screen_views(jnp.asarray, frame)
        ct, _ = ts.screen_views(T, frame)
        call_jax(sj, target=tj, cam=cj, taa=sj_state)
        st.fn(target=tt, cam=ct, taa=st_state)
        close(tt.color, tj.color)
    close(st_state.history, sj_state.history)
    close(st_state.prev_vp, sj_state.prev_vp)
    assert bool(st_state.valid)


@pytest.mark.parametrize("motion", [False, True],
                         ids=["reprojection", "motion_vectors"])
def test_motion_blur_three_frames_matches_jax(motion):
    sj, st = systems("motion_blur_pass",
                     lambda p: p.MotionBlurPlugin(strength=0.8, taps=4))
    sj_state = ns(prev_vp=jnp.eye(4), valid=jnp.zeros((), bool))
    st_state = ns(prev_vp=torch.eye(4),
                  valid=torch.zeros((), dtype=torch.bool))
    for frame in range(3):
        extra = {"motion": _motion_planes(20 + frame)} if motion else {}
        tj, tt = targets(20 + frame, **extra)
        cj, _ = ts.screen_views(jnp.asarray, frame)
        ct, _ = ts.screen_views(T, frame)
        call_jax(sj, target=tj, cam=cj, mb=sj_state)
        st.fn(target=tt, cam=ct, mb=st_state)
        close(tt.color, tj.color)
    close(st_state.prev_vp, sj_state.prev_vp)


def test_auto_exposure_three_frames_matches_jax():
    sj, st = systems("auto_exposure_pass",
                     lambda p: p.AutoExposurePlugin())
    sj_state = ns(ev=jnp.zeros(()), valid=jnp.zeros((), bool))
    st_state = ns(ev=torch.zeros(()), valid=torch.zeros((), dtype=torch.bool))
    for frame, (gain, dt) in enumerate(((0.2, 1 / 60), (3.0, 1 / 30),
                                        (1.0, 0.25))):
        tj, tt = targets(30 + frame)
        tj.color = tj.color * gain
        tt.color = tt.color * gain
        call_jax(sj, target=tj, st=sj_state, time=ns(delta=jnp.float32(dt)))
        st.fn(target=tt, st=st_state,
              time=ns(delta=torch.tensor(dt, dtype=torch.float32)))
        close(tt.color, tj.color)
        close(st_state.ev, sj_state.ev)


def test_post_passes_order_before_tonemap():
    """The port's POST_SET order equals the JAX package's for the
    post_processing stack (before="tonemap_pass" edges, insertion order
    otherwise)."""
    import bevy_tpu
    import bevy_tpu_torch
    from bevy_tpu.app.main_schedule import Render as RenderJ
    from bevy_tpu.render import RenderPlugin as RPJ
    from bevy_tpu.render import post as pj
    from bevy_tpu_torch.app.main_schedule import Render as RenderT
    from bevy_tpu_torch.render import RenderPlugin as RPT
    from bevy_tpu_torch.render import post as pt
    orders = []
    for app, rp, p, render in ((bevy_tpu.App(capacity=4), RPJ, pj, RenderJ),
                               (bevy_tpu_torch.App(capacity=4, device="cpu"),
                                RPT, pt, RenderT)):
        app.add_plugins(rp(width=W, height=H), p.TonemappingPlugin(),
                        p.FxaaPlugin(), p.SsaoPlugin(), p.BloomPlugin(),
                        p.SmaaPlugin(), p.TaaPlugin(), p.CasPlugin(),
                        p.AutoExposurePlugin())
        orders.append([e.system.name
                       for e in app.schedule(render).build_order()])
    assert orders[0] == orders[1]
    names = orders[1]
    assert names.index("tonemap_pass") > max(
        names.index(n) for n in ("ssao_pass", "bloom_pass", "taa_pass",
                                 "cas_pass", "auto_exposure_pass"))
