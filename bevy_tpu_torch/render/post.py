"""Post-processing (port of bevy_tpu/render/post.py; ref:
bevy_core_pipeline/tonemapping, bevy_post_process — bloom, depth of field
`src/dof/`, motion blur `src/motion_blur/`, chromatic aberration;
bevy_pbr/ssao; bevy_anti_alias — FXAA, SMAA, TAA, CAS).

Each effect is a plain function on (C, H, W) tensors, and a plugin whose
system (named as in the JAX package) runs it in POST_SET, most of them
`before="tonemap_pass"`. Depth-consuming effects reconstruct view-space
position from the reverse-z buffer, whose low mantissa bits carry the
visibility-buffer ids (noise below 2^-19, far under any gradient
tolerance). TAA and motion blur read the mesh pass's per-object motion
vectors where it wrote them (Mesh3dPlugin(motion_vectors=True), the
target's "motion" planes) and reproject by the camera matrices elsewhere.
Their history, previous view-projection and `valid` flag stay device
tensors (`valid` enters a torch.where, never a Python `if`), and the
camera's inverse comes from `torch.linalg.inv_ex`: no effect reads the
device back on the frame path. The default tonemapping is the ACES fit;
Tonemapping.LUT samples a 3D LUT (a procedural neutral one by default).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from bevy_tpu_torch.app.main_schedule import Render
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs.query import Query, Read, Res, ResMut
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.render.camera import (
    Camera3d, camera_row, perspective_infinite_reverse, pick_camera,
    view_matrix,
)
from bevy_tpu_torch.render.plugin import POST_SET, RenderPlugin, RenderTarget
from bevy_tpu_torch.transform import GlobalTransform


class Tonemapping:
    NONE = 0
    REINHARD = 1
    REINHARD_LUMINANCE = 2
    ACES = 3
    LUT = 4            # 3D LUT (ref: the LUT-based modes of tonemapping_luts)


def _luminance(rgb):
    return 0.2126 * rgb[0] + 0.7152 * rgb[1] + 0.0722 * rgb[2]


def neutral_lut(n=33, shoulder=4.0):
    """Procedural neutral filmic 3D LUT (n, n, n, 3) as numpy: the grid is
    indexed by sqrt-shaped linear rgb in [0, shoulder] and stores a
    Reinhard-luminance response with a mild crosstalk near white."""
    ax = np.linspace(0.0, 1.0, n, dtype=np.float32)
    r, g, b = np.meshgrid(ax, ax, ax, indexing="ij")
    rgb = np.stack([r, g, b], -1) ** 2 * shoulder       # decode
    lum = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] +
           0.0722 * rgb[..., 2])
    out = rgb * (1.0 / (1.0 + lum))[..., None]
    m = out.mean(-1, keepdims=True)
    t = np.clip(lum / shoulder, 0.0, 1.0)[..., None] ** 2
    return (out * (1 - 0.3 * t) + m * (0.3 * t)).astype(np.float32)


@lru_cache(maxsize=None)
def _neutral_lut_on(device):
    """neutral_lut() on `device`, made once."""
    return torch.from_numpy(neutral_lut()).to(device)


def sample_lut3d(rgb, lut, shoulder=4.0):
    """Trilinear 3D-LUT lookup. rgb (3, H, W) linear; lut (n, n, n, 3) on
    rgb's device. Grid coordinates use neutral_lut's sqrt shaper."""
    n = lut.shape[0]
    co = torch.sqrt(torch.clamp(rgb / shoulder, 0.0, 1.0)) * (n - 1)
    i0 = torch.clamp(torch.floor(co).to(torch.int32), 0, n - 2)
    f = co - i0
    i0 = i0.long()
    out = 0.0
    for dr in (0, 1):
        for dg in (0, 1):
            for db in (0, 1):
                w = (torch.abs(1 - dr - f[0]) * torch.abs(1 - dg - f[1]) *
                     torch.abs(1 - db - f[2]))
                tex = lut[i0[0] + dr, i0[1] + dg, i0[2] + db]
                out = out + w[..., None] * tex
    return out.permute(2, 0, 1)


def tonemap(rgb, mode: int, exposure: float, lut=None):
    """rgb: (3, H, W) linear planes; lut (n, n, n, 3) for Tonemapping.LUT
    (None: the neutral LUT)."""
    rgb = rgb * exposure
    if mode == Tonemapping.NONE:
        return rgb
    if mode == Tonemapping.REINHARD:
        return rgb / (1.0 + rgb)
    if mode == Tonemapping.REINHARD_LUMINANCE:
        lum = _luminance(rgb)
        return rgb * (1.0 / (1.0 + lum))[None]
    if mode == Tonemapping.ACES:
        # Narkowicz ACES fit (public constants)
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        return torch.clamp((rgb * (a * rgb + b)) /
                           (rgb * (c * rgb + d) + e), 0.0, 1.0)
    if mode == Tonemapping.LUT:
        return sample_lut3d(rgb, _neutral_lut_on(rgb.device)
                            if lut is None else lut)
    raise ValueError(mode)


def _gauss_kernel(sigma, k=9, device=None):
    """(k,) normalised gaussian taps, f32."""
    x = torch.arange(k, dtype=torch.float32, device=device) - (k - 1) / 2
    w = torch.exp(-0.5 * (x / sigma) ** 2)
    return w / torch.sum(w)


def _blur_sep(x, kern):
    """Separable blur of (C, 1, H, W) by the (k,) taps: zero padding
    (conv "SAME"), rows then columns, as two depthwise conv2d calls."""
    k = kern.shape[0]
    x = F.conv2d(x, kern.reshape(1, 1, k, 1), padding=(k // 2, 0))
    return F.conv2d(x, kern.reshape(1, 1, 1, k), padding=(0, k // 2))


def _rgb_over(rgb, c):
    """(4, H, W): rgb planes over the alpha plane of `c`."""
    return torch.cat([rgb, c[3:4]], 0)


def bloom(c, threshold, intensity, kern, downsample):
    """Bright-pass, box-downsample, separable gaussian blur and nearest
    upsample added to the colour (4, H, W)."""
    rgb = c[:3]
    _, h, w = rgb.shape
    ds = downsample
    hd, wd = h // ds, w // ds
    bright = torch.clamp(rgb - threshold, min=0.0)
    down = bright[:, :hd * ds, :wd * ds].reshape(3, hd, ds, wd, ds) \
        .mean((2, 4))
    blur = _blur_sep(down[:, None], kern)[:, 0]
    up = blur.repeat_interleave(ds, 1).repeat_interleave(ds, 2)
    up = F.pad(up, (0, w - wd * ds, 0, h - hd * ds))
    return _rgb_over(rgb + up * intensity, c)


class BloomPlugin(Plugin):
    """ref: bevy_post_process bloom/ — bright-pass, downsampled separable
    gaussian blur, additive upsample. Runs before tonemapping."""

    def __init__(self, threshold: float = 1.0, intensity: float = 0.2,
                 sigma: float = 2.0, downsample: int = 4):
        self.threshold = threshold
        self.intensity = intensity
        self.sigma = sigma
        self.downsample = downsample

    def build(self, app):
        thr, inten, ds = self.threshold, self.intensity, self.downsample
        kern = _gauss_kernel(self.sigma, device=app.device)

        @system(name="bloom_pass")
        def bloom_pass(target=ResMut(RenderTarget.RESOURCE)):
            target.color = bloom(target.color, thr, inten, kern, ds)

        app.add_systems(Render, bloom_pass, in_set=POST_SET,
                        before="tonemap_pass")


def _pixel_axes(h, w, device):
    """NDC x (w,) and y (h,) of the pixel centres (+y up)."""
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) \
        / w * 2.0 - 1.0
    ys = 1.0 - (torch.arange(h, dtype=torch.float32, device=device) + 0.5) \
        / h * 2.0
    return xs, ys


def view_pos_from_depth(depth, fov, aspect, near):
    """Reverse-z infinite-projection depth (H, W) -> view-space position
    planes (3, H, W), fov an f32 tensor. Background (depth == 0) maps to a
    far dummy point."""
    h, w = depth.shape
    zv = near / torch.clamp(depth, min=1e-7)
    zv = torch.where(depth > 0, zv, torch.full_like(zv, 1e6))
    f = 1.0 / torch.tan(fov * 0.5)
    xs, ys = _pixel_axes(h, w, depth.device)
    vx = xs[None, :] * zv * aspect / f
    vy = ys[:, None] * zv / f
    return torch.stack([vx, vy, -zv])


def _shift(x, dy, dx):
    """Edge-clamped 2D shift of (..., H, W): out[i, j] = x[clamp(i - dy),
    clamp(j - dx)] (a copy, so bit-exact)."""
    if dy:
        h = x.shape[-2]
        d = min(abs(dy), h)
        if dy > 0:
            x = torch.cat([x[..., :1, :].expand(*x.shape[:-2], d, x.shape[-1]),
                           x[..., :h - d, :]], -2)
        else:
            x = torch.cat([x[..., d:, :],
                           x[..., h - 1:, :].expand(*x.shape[:-2], d,
                                                    x.shape[-1])], -2)
    if dx:
        w = x.shape[-1]
        d = min(abs(dx), w)
        if dx > 0:
            x = torch.cat([x[..., :1].expand(*x.shape[:-1], d),
                           x[..., :w - d]], -1)
        else:
            x = torch.cat([x[..., d:],
                           x[..., w - 1:].expand(*x.shape[:-1], d)], -1)
    return x


def normals_from_depth(vpos):
    """Screen-space normals (3, H, W): the cross of the view-position
    gradients (ref: the depth-only normal path of ssao's prepass
    fallback)."""
    a = _shift(vpos, 0, -1) - vpos
    b = _shift(vpos, -1, 0) - vpos
    n = torch.stack([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])
    nn = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    return n * torch.rsqrt(torch.clamp(nn, min=1e-12))


def ssao_taps(samples):
    """The golden-angle spiral of (dy, dx) pixel taps."""
    ang = np.arange(samples) * 2.39996
    return [(int(round(np.sin(a) * (2 + 3 * i / max(samples - 1, 1)))),
             int(round(np.cos(a) * (2 + 3 * i / max(samples - 1, 1)))))
            for i, a in enumerate(ang)]


def ssao(c, depth, taps, radius, intensity, fov, near):
    """Spiral-tap horizon occlusion over reconstructed view positions,
    blurred once and multiplied into the colour (4, H, W)."""
    h, w = depth.shape
    vpos = view_pos_from_depth(depth, fov, w / h, near)
    nrm = normals_from_depth(vpos)
    occ = torch.zeros((h, w), dtype=torch.float32, device=depth.device)
    rr = radius * radius
    for dy, dx in taps:
        d = _shift(vpos, dy, dx) - vpos
        dist2 = torch.sum(d * d, 0)
        ndl = torch.sum(nrm * d, 0) * torch.rsqrt(
            torch.clamp(dist2, min=1e-8))
        occ = occ + torch.clamp(ndl - 0.1, min=0.0) * \
            (rr / torch.clamp(dist2 + rr, min=1e-8))
    ao = torch.clamp(1.0 - occ * (intensity / len(taps)) * 2.0, 0.0, 1.0)
    # the reference's denoise pass, collapsed to one 5-tap blur
    ao = (ao + _shift(ao, 0, 1) + _shift(ao, 0, -1) + _shift(ao, 1, 0) +
          _shift(ao, -1, 0)) / 5.0
    ao = torch.where(depth > 0, ao, torch.ones_like(ao))
    return _rgb_over(c[:3] * ao[None], c)


class SsaoPlugin(Plugin):
    """Screen-space ambient occlusion (ref: bevy_pbr/src/ssao — GTAO;
    here a spiral-tap horizon estimator over reconstructed view
    positions, multiplied into colour before tonemapping)."""

    def __init__(self, radius=1.0, intensity=1.0, samples=8,
                 fov=0.7853982, near=0.1):
        self.radius = radius
        self.intensity = intensity
        self.samples = samples
        self.fov = fov
        self.near = near

    def build(self, app):
        rad, inten, near = self.radius, self.intensity, self.near
        fov = torch.tensor(self.fov, dtype=torch.float32, device=app.device)
        taps = ssao_taps(self.samples)

        @system(name="ssao_pass")
        def ssao_pass(target=ResMut(RenderTarget.RESOURCE)):
            target.color = ssao(target.color, target.depth, taps, rad, inten,
                                fov, near)

        app.add_systems(Render, ssao_pass, in_set=POST_SET,
                        before="tonemap_pass")


def camera_vp(cam, width, height):
    """The first camera's view-projection (4, 4), translation (3,), fov,
    near and whether one exists, its rows gathered on the device
    (camera.camera_row: no host read)."""
    ci, has_cam = pick_camera(cam.mask)
    gt = cam.global_transform
    t = camera_row(gt.translation, ci)
    fov = camera_row(cam.camera3d.fov, ci)
    near = camera_row(cam.camera3d.near, ci)
    view = view_matrix(t, camera_row(gt.rotation, ci),
                       camera_row(gt.scale, ci))
    proj = perspective_infinite_reverse(fov, width / height, near)
    return proj @ view, t, fov, near, has_cam


def inverse(m):
    """Inverse of a (4, 4) device matrix without a host sync (inv_ex's
    error flag is never read)."""
    return torch.linalg.inv_ex(m).inverse


def _reproject_uv(depth, vp_prev, inv_vp, near):
    """Per-pixel previous-frame pixel coordinates by world reprojection
    (clip-space reconstruction, inv(VP), then the previous VP). Returns
    (py_prev, px_prev) float planes (H, W)."""
    h, w = depth.shape
    wclip = near / torch.clamp(depth, min=1e-7)
    wclip = torch.where(depth > 0, wclip, torch.full_like(wclip, 1e6))
    xs, ys = _pixel_axes(h, w, depth.device)
    clip = torch.stack([xs[None, :] * wclip, ys[:, None] * wclip,
                        near.expand(h, w), wclip])
    world = torch.einsum("ij,jhw->ihw", inv_vp, clip)
    prev = torch.einsum("ij,jhw->ihw", vp_prev, world)
    pw = torch.where(torch.abs(prev[3]) > 1e-8, prev[3],
                     torch.ones_like(prev[3]))
    ndc_x = prev[0] / pw
    ndc_y = prev[1] / pw
    px = (ndc_x * 0.5 + 0.5) * w - 0.5
    py = (0.5 - ndc_y * 0.5) * h - 0.5
    return py, px


def _with_motion(py, px, motion):
    """Per-object motion vectors (motion planes [dy, dx, valid]) in place
    of the camera reprojection where the mesh pass wrote them."""
    if motion is None:
        return py, px
    h, w = py.shape
    yy = torch.arange(h, dtype=torch.float32, device=py.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=py.device)[None, :]
    mv = motion[2] > 0.5
    return (torch.where(mv, yy + motion[0], py),
            torch.where(mv, xx + motion[1], px))


def taa_resolve(c, history, py, px, valid, blend):
    """History reprojection at (py, px) with a 3x3 neighbourhood clamp,
    blended into the colour (4, H, W) where `valid` (a 0-d bool tensor)
    and the history pixel is on screen."""
    _, h, w = c.shape
    y0 = torch.clamp(torch.round(py).to(torch.int32), 0, h - 1).long()
    x0 = torch.clamp(torch.round(px).to(torch.int32), 0, w - 1).long()
    hist = history[:, y0, x0]
    lo = c
    hi = c
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(c, dy, dx)
            lo = torch.minimum(lo, s)
            hi = torch.maximum(hi, s)
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    offscreen = (px < 0) | (px > w - 1) | (py < 0) | (py > h - 1)
    a = torch.where(valid & ~offscreen, 1.0 - blend, 0.0)[None]
    return c * (1.0 - a) + hist * a


class TaaPlugin(Plugin):
    """Temporal anti-aliasing (ref: bevy_anti_alias/src/taa — history
    reprojection + neighbourhood clamp). Uses the mesh pass's per-object
    motion vectors where present, camera-matrix reprojection elsewhere.
    (fov and near are kept for the reference's signature; the pass reads
    the camera's.)"""

    def __init__(self, blend=0.125, fov=0.7853982, near=0.1):
        self.blend = blend
        self.fov = fov
        self.near = near

    def build(self, app):
        blend = self.blend

        @system(name="taa_pass")
        def taa_pass(target=ResMut(RenderTarget.RESOURCE),
                     cam=Query(Read(Camera3d), Read(GlobalTransform)),
                     taa=ResMut("taa_state")):
            c = target.color
            _, h, w = c.shape
            vp, _, _, near, _ = camera_vp(cam, w, h)
            py, px = _reproject_uv(target.depth, taa.prev_vp, inverse(vp),
                                   near)
            py, px = _with_motion(py, px, getattr(target, "motion", None))
            out = taa_resolve(c, taa.history, py, px, taa.valid, blend)
            target.color = out
            taa.history = out
            taa.prev_vp = vp
            taa.valid = torch.ones_like(taa.valid)

        def init_state(world):
            rp = next(p for p in app._plugins if isinstance(p, RenderPlugin))
            if "taa_state" not in world.state["res"]:
                dev = world.device
                world.state["res"]["taa_state"] = {
                    "history": torch.zeros((4, rp.height, rp.width),
                                           device=dev),
                    "prev_vp": torch.eye(4, device=dev),
                    "valid": torch.zeros((), dtype=torch.bool, device=dev),
                }

        app.add_prepare_hook(init_state)
        app.add_systems(Render, taa_pass, in_set=POST_SET,
                        before="tonemap_pass")


def motion_blur(c, py, px, valid, strength, taps):
    """`taps` nearest samples along the per-pixel motion (py, px) scaled by
    `strength`, averaged with the pixel, where `valid` (0-d bool)."""
    _, h, w = c.shape
    yy = torch.arange(h, dtype=torch.float32, device=c.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=c.device)[None, :]
    vy = (py - yy) * strength
    vx = (px - xx) * strength
    acc = c[:3]
    for k in range(1, taps + 1):
        t = k / taps
        sy = torch.clamp(torch.round(yy + vy * t).to(torch.int32), 0, h - 1)
        sx = torch.clamp(torch.round(xx + vx * t).to(torch.int32), 0, w - 1)
        acc = acc + c[:3, sy.long(), sx.long()]
    out = acc / (taps + 1)
    return _rgb_over(torch.where(valid, out, c[:3]), c)


class MotionBlurPlugin(Plugin):
    """Motion blur (ref: bevy_post_process/src/motion_blur — velocity
    from reprojection or per-object motion vectors, N taps along it)."""

    def __init__(self, strength=0.5, taps=4, fov=0.7853982, near=0.1):
        self.strength = strength
        self.taps = taps
        self.fov = fov
        self.near = near

    def build(self, app):
        strength, ntap = self.strength, self.taps

        @system(name="motion_blur_pass")
        def motion_blur_pass(target=ResMut(RenderTarget.RESOURCE),
                             cam=Query(Read(Camera3d), Read(GlobalTransform)),
                             mb=ResMut("motion_blur_state")):
            c = target.color
            _, h, w = c.shape
            vp, _, _, near, _ = camera_vp(cam, w, h)
            py, px = _reproject_uv(target.depth, mb.prev_vp, inverse(vp),
                                   near)
            py, px = _with_motion(py, px, getattr(target, "motion", None))
            target.color = motion_blur(c, py, px, mb.valid, strength, ntap)
            mb.prev_vp = vp
            mb.valid = torch.ones_like(mb.valid)

        def init_state(world):
            if "motion_blur_state" not in world.state["res"]:
                dev = world.device
                world.state["res"]["motion_blur_state"] = {
                    "prev_vp": torch.eye(4, device=dev),
                    "valid": torch.zeros((), dtype=torch.bool, device=dev),
                }

        app.add_prepare_hook(init_state)
        app.add_systems(Render, motion_blur_pass, in_set=POST_SET,
                        before="tonemap_pass")


def depth_of_field(c, depth, kern, focal_distance, focal_range, near):
    """Circle of confusion from the view depth, blended between the
    colour, one blur and two blurs (4, H, W)."""
    rgb = c[:3]
    fd = focal_distance
    zv = near / torch.clamp(depth, min=1e-7)
    zv = torch.where(depth > 0, zv, torch.full_like(zv, fd))
    coc = torch.clamp(torch.abs(zv - fd) / focal_range, 0.0, 1.0)
    x = _blur_sep(rgb[:, None], kern)
    blur1 = x[:, 0]
    blur2 = _blur_sep(x, kern)[:, 0]
    t = coc[None]
    out = torch.where(t < 0.5, rgb * (1 - 2 * t) + blur1 * 2 * t,
                      blur1 * (2 - 2 * t) + blur2 * (2 * t - 1))
    return _rgb_over(out, c)


class DepthOfFieldPlugin(Plugin):
    """Depth of field (ref: bevy_post_process/src/dof — circle of
    confusion from focal distance, blended blur levels)."""

    def __init__(self, focal_distance=10.0, focal_range=4.0,
                 max_blur=2, fov=0.7853982, near=0.1):
        self.focal_distance = focal_distance
        self.focal_range = focal_range
        self.max_blur = max_blur
        self.fov = fov
        self.near = near

    def build(self, app):
        fd, fr, near = self.focal_distance, self.focal_range, self.near
        kern = _gauss_kernel(1.5, 7, device=app.device)

        @system(name="dof_pass")
        def dof_pass(target=ResMut(RenderTarget.RESOURCE)):
            target.color = depth_of_field(target.color, target.depth, kern,
                                          fd, fr, near)

        app.add_systems(Render, dof_pass, in_set=POST_SET,
                        before="tonemap_pass")


def chromatic_aberration(c, strength):
    """Radial red / blue channel offsets (4, H, W)."""
    _, h, w = c.shape
    dev = c.device
    ay = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    ax = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    yy = (ay - h / 2) / h
    xx = (ax - w / 2) / h
    oy = torch.clamp(torch.round(ay + yy * strength).to(torch.int32), 0,
                     h - 1)
    ox = torch.clamp(torch.round(ax + xx * strength).to(torch.int32), 0,
                     w - 1)
    iy = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    ix = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    r = c[0][oy.long(), ox.long()]
    b = c[2][torch.clamp(2 * iy - oy, 0, h - 1).long(),
             torch.clamp(2 * ix - ox, 0, w - 1).long()]
    return torch.stack([r, c[1], b, c[3]], 0)


class ChromaticAberrationPlugin(Plugin):
    """Radial RGB channel offset (ref: bevy_post_process effect stack's
    chromatic aberration)."""

    def __init__(self, strength=2.0):
        self.strength = strength

    def build(self, app):
        s = self.strength

        @system(name="chromatic_aberration_pass")
        def ca_pass(target=ResMut(RenderTarget.RESOURCE)):
            target.color = chromatic_aberration(target.color, s)

        app.add_systems(Render, ca_pass, in_set=POST_SET,
                        before="tonemap_pass")


def cas_filter(rgb, strength):
    """AMD CAS on (3, H, W) linear planes: sharpens low-contrast detail,
    leaves high-contrast edges alone (ref: bevy_anti_alias/src/
    contrast_adaptive_sharpening)."""
    n = _shift(rgb, -1, 0)
    so = _shift(rgb, 1, 0)
    e = _shift(rgb, 0, 1)
    w_ = _shift(rgb, 0, -1)
    mn = torch.minimum(torch.minimum(torch.minimum(n, so),
                                     torch.minimum(e, w_)), rgb)
    mx = torch.maximum(torch.maximum(torch.maximum(n, so),
                                     torch.maximum(e, w_)), rgb)
    amp = torch.sqrt(torch.clamp(
        torch.minimum(mn, 2.0 - mx) / torch.clamp(mx, min=1e-5), 0.0, 1.0))
    wgt = -amp * (strength * 0.125 + (1 - strength) * 0.2)
    out = (rgb + (n + so + e + w_) * wgt) / (1.0 + 4.0 * wgt)
    return torch.clamp(out, 0.0, 1e9)


def fxaa_filter(rgb, threshold=0.0625):
    """FXAA-style luminance edge anti-aliasing on (3, H, W) planes (ref:
    bevy_anti_alias/src/fxaa — a simplified directional blend)."""
    luma = _luminance(rgb)
    ln = _shift(luma, -1, 0)
    ls = _shift(luma, 1, 0)
    le = _shift(luma, 0, 1)
    lw = _shift(luma, 0, -1)
    lmin = torch.minimum(luma, torch.minimum(torch.minimum(ln, ls),
                                             torch.minimum(le, lw)))
    lmax = torch.maximum(luma, torch.maximum(torch.maximum(ln, ls),
                                             torch.maximum(le, lw)))
    edge = (lmax - lmin) > torch.clamp(lmax * 0.125, min=threshold)
    horiz = torch.abs(ln + ls - 2 * luma) >= torch.abs(le + lw - 2 * luma)
    blur_h = (rgb + _shift(rgb, -1, 0) + _shift(rgb, 1, 0)) / 3.0
    blur_v = (rgb + _shift(rgb, 0, -1) + _shift(rgb, 0, 1)) / 3.0
    aa = torch.where(horiz[None], blur_h, blur_v)
    return torch.where(edge[None], aa, rgb)


def smaa_filter(rgb, threshold=0.05, max_search=8):
    """SMAA-class morphological anti-aliasing (ref: bevy_anti_alias/src/
    smaa — Jimenez SMAA 1x), the JAX package's vectorised MLAA core:
    luma edges (top / left), span search unrolled `max_search` steps,
    crossing-edge classification at the span ends into revectorised line
    heights with analytic trapezoid coverage, and one weighted blend with
    the neighbours across each edge."""
    luma = _luminance(rgb)
    sh = _shift
    e_top = torch.abs(luma - sh(luma, -1, 0)) > threshold
    e_left = torch.abs(luma - sh(luma, 0, -1)) > threshold

    def along(a, d, axis):
        return sh(a, 0, d) if axis == 1 else sh(a, d, 0)

    def spans(edge, axis):
        """Run lengths (dl, dr) of consecutive edge pixels along axis."""
        dl = torch.zeros_like(luma)
        dr = torch.zeros_like(luma)
        ef = edge.to(torch.float32)
        runl = ef
        runr = ef
        for i in range(1, max_search + 1):
            runl = runl * along(ef, -i, axis)
            runr = runr * along(ef, i, axis)
            dl = dl + runl
            dr = dr + runr
        return dl, dr

    def coverage(edge, axis, cross_a, cross_b):
        """Revectorised-line coverage per edge pixel, from the crossing
        edges cross_a / cross_b at both span ends."""
        dl, dr = spans(edge, axis)
        ln = dl + dr + 1.0

        def at_end(cross, dist, sign):
            d = dist * sign if sign < 0 else (dist + 1.0) * sign
            di = d.to(torch.int32)
            out = torch.zeros_like(luma)
            cf = cross.to(torch.float32)
            for i in range(0 if sign < 0 else 1, max_search + 2):
                off = i * sign
                out = torch.where(di == off, along(cf, off, axis), out)
            return out

        hl = 0.5 * (at_end(cross_a, dl, -1) - at_end(cross_b, dl, -1))
        hr = 0.5 * (at_end(cross_a, dr, 1) - at_end(cross_b, dr, 1))
        t = (dl + 0.5) / torch.clamp(ln, min=1.0)
        a = hl * torch.clamp(1.0 - 2.0 * t, min=0.0) + \
            hr * torch.clamp(2.0 * t - 1.0, min=0.0)
        return torch.where(edge, a, torch.zeros_like(a))

    a_h = coverage(e_top, 1, sh(e_left, -1, 0), e_left)
    a_v = coverage(e_left, 0, sh(e_top, 0, -1), e_top)
    wt = torch.abs(a_h)
    wb = torch.abs(sh(a_h, 1, 0))
    wl = torch.abs(a_v)
    wr = torch.abs(sh(a_v, 0, 1))
    s = wt + wb + wl + wr
    scale = torch.clamp(0.75 / torch.clamp(s, min=1e-6), max=1.0)
    wt, wb, wl, wr = wt * scale, wb * scale, wl * scale, wr * scale
    s = wt + wb + wl + wr
    return rgb * (1 - s[None]) + sh(rgb, -1, 0) * wt[None] + \
        sh(rgb, 1, 0) * wb[None] + sh(rgb, 0, -1) * wl[None] + \
        sh(rgb, 0, 1) * wr[None]


class SmaaPlugin(Plugin):
    """SMAA 1x morphological anti-aliasing pass (see smaa_filter)."""

    def __init__(self, edge_threshold=0.05, max_search=8):
        self.threshold = edge_threshold
        self.max_search = max_search

    def build(self, app):
        thr, ms = self.threshold, self.max_search

        @system(name="smaa_pass")
        def smaa_pass(target=ResMut(RenderTarget.RESOURCE)):
            c = target.color
            target.color = _rgb_over(smaa_filter(c[:3], thr, ms), c)

        app.add_systems(Render, smaa_pass, in_set=POST_SET)


class CasPlugin(Plugin):
    """Contrast-adaptive sharpening pass (see cas_filter)."""

    def __init__(self, strength=0.6):
        self.strength = strength

    def build(self, app):
        s = self.strength

        @system(name="cas_pass")
        def cas_pass(target=ResMut(RenderTarget.RESOURCE)):
            c = target.color
            target.color = _rgb_over(cas_filter(c[:3], s), c)

        app.add_systems(Render, cas_pass, in_set=POST_SET,
                        before="tonemap_pass")


class FxaaPlugin(Plugin):
    """FXAA pass (see fxaa_filter)."""

    def __init__(self, edge_threshold=0.0625):
        self.threshold = edge_threshold

    def build(self, app):
        thr = self.threshold

        @system(name="fxaa_pass")
        def fxaa_pass(target=ResMut(RenderTarget.RESOURCE)):
            c = target.color
            target.color = _rgb_over(fxaa_filter(c[:3], thr), c)

        app.add_systems(Render, fxaa_pass, in_set=POST_SET)


class TonemappingPlugin(Plugin):
    """ref: the Tonemapping component on cameras — global here (one
    target). lut: an (n, n, n, 3) array for Tonemapping.LUT."""

    def __init__(self, mode: int = Tonemapping.ACES, exposure: float = 1.0,
                 lut=None):
        self.mode = mode
        self.exposure = exposure
        self.lut = lut

    def build(self, app):
        mode, exposure = self.mode, self.exposure
        lut = None
        if mode == Tonemapping.LUT:
            lut = torch.as_tensor(
                np.asarray(neutral_lut() if self.lut is None else self.lut,
                           np.float32), device=app.device)

        @system(name="tonemap_pass")
        def tonemap_pass(target=ResMut(RenderTarget.RESOURCE)):
            c = target.color
            target.color = _rgb_over(tonemap(c[:3], mode, exposure, lut), c)

        app.add_systems(Render, tonemap_pass, in_set=POST_SET)


def auto_exposure(c, ev, valid, dt, log2_target, speed_brighten,
                  speed_darken, min_exp, max_exp):
    """One eye-adaptation step: the EV that maps the frame's mean log2
    luminance onto the target, approached at the asymmetric speeds (the
    first frame takes it whole). Returns (colour scaled by 2^ev, ev)."""
    luma = 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]
    mean_log = torch.mean(torch.log2(torch.clamp(luma, min=1e-4)))
    want = torch.clamp(log2_target - mean_log, min_exp, max_exp)
    speed = torch.where(want > ev, speed_brighten, speed_darken)
    blend = 1.0 - torch.exp(-dt * speed)
    ev = torch.where(valid, ev + (want - ev) * blend, want)
    return _rgb_over(c[:3] * torch.exp2(ev), c), ev


class AutoExposurePlugin(Plugin):
    """Eye adaptation (ref: bevy_post_process/src/auto_exposure —
    histogram metering with asymmetric brighten / darken speeds; here the
    meter is the mean log2 luminance of the HDR frame). Runs before
    tonemapping; keeps its EV in the auto_exposure_state resource."""

    def __init__(self, target_luma=0.18, speed_brighten=3.0,
                 speed_darken=1.0, min_exp=-4.0, max_exp=4.0):
        self.target_luma = target_luma
        self.speed_brighten = speed_brighten
        self.speed_darken = speed_darken
        self.min_exp = min_exp
        self.max_exp = max_exp

    def build(self, app):
        dev = app.device
        log2_target = torch.log2(torch.tensor(self.target_luma,
                                              dtype=torch.float32,
                                              device=dev))
        sb, sd = self.speed_brighten, self.speed_darken
        lo, hi = self.min_exp, self.max_exp
        app.insert_resource("auto_exposure_state", {
            "ev": torch.zeros((), device=dev),
            "valid": torch.zeros((), dtype=torch.bool, device=dev),
        })

        @system(name="auto_exposure_pass")
        def auto_exposure_pass(target=ResMut(RenderTarget.RESOURCE),
                               st=ResMut("auto_exposure_state"),
                               time=Res("time")):
            target.color, st.ev = auto_exposure(
                target.color, st.ev, st.valid, time.delta, log2_target, sb,
                sd, lo, hi)
            st.valid = torch.ones_like(st.valid)

        app.add_systems(Render, auto_exposure_pass, in_set=POST_SET,
                        before="tonemap_pass")

