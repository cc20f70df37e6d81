"""Gizmos — immediate-mode debug drawing (port of bevy_tpu/render/gizmos.py;
ref: bevy_gizmos — the `Gizmos` system param accumulating per-frame
primitives, `src/gizmos.rs`, drawn by bevy_gizmos_render's polyline
pipeline into the transparent phases).

A line segment is a thin rotated solid quad. Systems append segments
into a fixed per-frame device buffer (the `gizmo_lines` resource); one
pass after the sprite pass draws them through the tile sprite raster,
kernel B4 (`bin_sprites` + `sprite_tiles`, as the JAX package's pallas
backend does), and the buffer clears after the overlay. 3D endpoints
project through the first alive Camera3d, 2D ones through the first
Camera2d.

Appends stay where their inputs are: shapes built from Python numbers are
computed on the CPU, and a system's batches reach the device as one copy
and one `index_copy_` a buffer field at its merge (JAX scatters each batch
in turn; the rows, the count and what is dropped at capacity are the
same).

Not ported: UiDebugOverlayPlugin (it needs the UI layout, ROADMAP A7).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from bevy_tpu_torch.app.main_schedule import Render, Update
from bevy_tpu_torch.app.plugin import Plugin
from bevy_tpu_torch.ecs._state import set_in
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Read, ResMut
from bevy_tpu_torch.ecs.system import register_param_type, system
from bevy_tpu_torch.math.quat import cross, quat_rotate_vec3
from bevy_tpu_torch.ops.raster2d import (
    bin_sprites, pack_sprite_instances, sprite_tiles,
)
from bevy_tpu_torch.render.camera import (
    Camera2d, Camera3d, camera_row, perspective_infinite_reverse,
    pick_camera, quat_z_angle, view_matrix, world_to_screen_2d,
)
from bevy_tpu_torch.render.plugin import (
    OVERLAY_SET, POST_SET, RenderPlugin, RenderTarget, add_render_stats,
)
from bevy_tpu_torch.render.stroke_font import layout, measure
from bevy_tpu_torch.transform import GlobalTransform

GIZMO_RES = "gizmo_lines"
TAU = 2 * 3.14159265
WHITE = (1.0, 1.0, 1.0, 1.0)
CPU = torch.device("cpu")
# the packed row of one segment: a (3), b (3), colour (4), width, is3d
_FIELDS = (("a", slice(0, 3)), ("b", slice(3, 6)), ("color", slice(6, 10)),
           ("width", 10), ("is3d", 11))


def _on_device(x):
    """Does `x` (a tensor, or a list / tuple holding some) live off the
    CPU?"""
    if isinstance(x, torch.Tensor):
        return x.device.type != "cpu"
    if isinstance(x, (list, tuple)):
        return any(_on_device(e) for e in x)
    return False


def _f32(x, dev):
    """`x` as an f32 tensor on `dev` (numbers round to f32 as jnp.asarray
    rounds them)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    if isinstance(x, (list, tuple)) and any(isinstance(e, torch.Tensor)
                                            for e in x):
        return torch.stack([_f32(e, dev) for e in x])
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _linspace(start, stop, num, dev):
    """jnp.linspace(start, stop, num) in f32: start * (1 - s) + stop * s
    with s = i / (num - 1), the last point exactly `stop`."""
    start, stop = _f32(start, dev), _f32(stop, dev)
    step = torch.arange(num - 1, dtype=torch.float32, device=dev) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop[None]])


class Gizmos:
    """System param (ref: Gizmos). Its methods append segments; `budget`
    caps the rows each appended batch keeps."""

    def __init__(self, budget: int = 256):
        self.budget = budget

    def build(self, state, world, sysctx):
        return GizmosView(self, state["res"][GIZMO_RES])


class GizmosView:
    def __init__(self, param, store):
        self._param = param
        self._dev = store["a"].device
        # (a, b, color, width, is3d[, valid]) per appended batch
        self._segments = []

    def _where(self, *xs):
        """The device shape arithmetic runs on: the world's where an input
        lives there, else the CPU (host numbers stay on the host until
        the merge)."""
        return self._dev if any(_on_device(x) for x in xs) else CPU

    def line(self, a, b, color=WHITE, width=2.0):
        """3D world-space segment(s); a / b (3,) or (n, 3)."""
        self._segments.append((a, b, color, width, True))

    def line_2d(self, a, b, color=WHITE, width=2.0):
        """2D world-space segment(s); a / b (2,) or (n, 2)."""
        self._segments.append((a, b, color, width, False))

    def rect_2d(self, center, size, color=WHITE, width=2.0):
        cx, cy = center[0], center[1]
        hx, hy = size[0] / 2, size[1] / 2
        corners = [(cx - hx, cy - hy), (cx + hx, cy - hy),
                   (cx + hx, cy + hy), (cx - hx, cy + hy)]
        for i in range(4):
            self.line_2d(corners[i], corners[(i + 1) % 4], color, width)

    # -- shape vocabulary (ref: bevy_gizmos src/circles.rs, arcs.rs,
    # primitives/, grid.rs — all decompose to batched segments) ---------

    def linestrip(self, points, color=WHITE, width=2.0):
        p = _f32(points, self._where(points))
        self.line(p[:-1], p[1:], color, width)

    def linestrip_2d(self, points, color=WHITE, width=2.0):
        p = _f32(points, self._where(points))
        self.line_2d(p[:-1], p[1:], color, width)

    def arc_2d(self, center, radius, start=0.0, sweep=TAU, color=WHITE,
               width=2.0, segments=32):
        dev = self._where(center, radius, start, sweep)
        t = _f32(start, dev) + _linspace(0.0, sweep, segments + 1, dev)
        pts = torch.addcmul(_f32(center, dev), _f32(radius, dev),
                            torch.stack([torch.cos(t), torch.sin(t)], 1))
        self.linestrip_2d(pts, color, width)

    def circle_2d(self, center, radius, color=WHITE, width=2.0,
                  segments=32):
        self.arc_2d(center, radius, 0.0, TAU, color, width, segments)

    def circle(self, center, normal, radius, color=WHITE, width=2.0,
               segments=32):
        """3D circle in the plane perpendicular to `normal`."""
        dev = self._where(center, normal, radius)
        n = _f32(normal, dev)
        n = n / torch.clamp(torch.sqrt(torch.sum(n * n)), min=1e-6)
        ref = torch.where(torch.abs(n[0]) < 0.9, _f32((1.0, 0.0, 0.0), dev),
                          _f32((0.0, 1.0, 0.0), dev))
        u = cross(n, ref)
        u = u / torch.clamp(torch.sqrt(torch.sum(u * u)), min=1e-6)
        v = cross(n, u)
        t = _linspace(0.0, TAU, segments + 1, dev)
        ring = torch.cos(t)[:, None] * u + torch.sin(t)[:, None] * v
        pts = torch.addcmul(_f32(center, dev), _f32(radius, dev), ring)
        self.linestrip(pts, color, width)

    def sphere(self, center, radius, color=WHITE, width=2.0, segments=32):
        """Three orthogonal great circles (ref: SphereBuilder)."""
        for axis in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)):
            self.circle(center, axis, radius, color, width, segments)

    def cuboid(self, center, half_size, color=WHITE, width=2.0):
        """Wireframe box: 12 edges as one batched append."""
        dev = self._where(center, half_size)
        c, h = _f32(center, dev), _f32(half_size, dev)
        sgn = _f32([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                    for sz in (-1, 1)], dev)
        corners = torch.addcmul(c, sgn, h)     # (8, 3), bit i = axis sign
        edges = [(0, 1), (2, 3), (4, 5), (6, 7),   # z edges
                 (0, 2), (1, 3), (4, 6), (5, 7),   # y edges
                 (0, 4), (1, 5), (2, 6), (3, 7)]   # x edges
        self.line(corners[[e[0] for e in edges]],
                  corners[[e[1] for e in edges]], color, width)

    def grid_2d(self, center, cell_size, counts, color=WHITE, width=1.0):
        cx, cy = float(center[0]), float(center[1])
        sx, sy = float(cell_size[0]), float(cell_size[1])
        nx, ny = int(counts[0]), int(counts[1])
        hw, hh = nx * sx / 2, ny * sy / 2
        xs = torch.arange(nx + 1, dtype=torch.float32) * sx + (cx - hw)
        ys = torch.arange(ny + 1, dtype=torch.float32) * sy + (cy - hh)
        self.line_2d(torch.stack([xs, torch.full((nx + 1,), cy - hh)], 1),
                     torch.stack([xs, torch.full((nx + 1,), cy + hh)], 1),
                     color, width)
        self.line_2d(torch.stack([torch.full((ny + 1,), cx - hw), ys], 1),
                     torch.stack([torch.full((ny + 1,), cx + hw), ys], 1),
                     color, width)

    def grid(self, center, cell_size, counts, color=WHITE, width=1.0):
        """XZ-plane 3D grid (ref: GridBuilder's default orientation)."""
        cx, cy, cz = (float(center[i]) for i in range(3))
        sx, sz = float(cell_size[0]), float(cell_size[1])
        nx, nz = int(counts[0]), int(counts[1])
        hw, hd = nx * sx / 2, nz * sz / 2
        xs = torch.arange(nx + 1, dtype=torch.float32) * sx + (cx - hw)
        zs = torch.arange(nz + 1, dtype=torch.float32) * sz + (cz - hd)

        def full(n, v):
            return torch.full((n,), v)

        self.line(torch.stack([xs, full(nx + 1, cy), full(nx + 1, cz - hd)],
                              1),
                  torch.stack([xs, full(nx + 1, cy), full(nx + 1, cz + hd)],
                              1), color, width)
        self.line(torch.stack([full(nz + 1, cx - hw), full(nz + 1, cy), zs],
                              1),
                  torch.stack([full(nz + 1, cx + hw), full(nz + 1, cy), zs],
                              1), color, width)

    def axes(self, position, rotation=None, length=1.0, width=2.0):
        """RGB basis axes at a pose (ref: axes.rs)."""
        dev = self._where(position, rotation, length)
        p = _f32(position, dev)
        for axis, col in (((1.0, 0.0, 0.0), (1.0, 0.2, 0.2, 1.0)),
                          ((0.0, 1.0, 0.0), (0.2, 1.0, 0.2, 1.0)),
                          ((0.0, 0.0, 1.0), (0.2, 0.4, 1.0, 1.0))):
            d = _f32(axis, dev)
            if rotation is not None:
                d = quat_rotate_vec3(_f32(rotation, dev), d)
            self.line(p, torch.addcmul(p, d, _f32(length, dev)), col, width)

    def arrow(self, a, b, color=WHITE, width=2.0, tip=0.15):
        """Segment with a two-line head at `b` (ref: arrows.rs)."""
        dev = self._where(a, b)
        a, b = _f32(a, dev), _f32(b, dev)
        d = b - a
        ln = torch.clamp(torch.sqrt(torch.sum(d * d)), min=1e-6)
        dn = d / ln
        ref = torch.where(torch.abs(dn[0]) < 0.9,
                          _f32((1.0, 0.0, 0.0), dev),
                          _f32((0.0, 1.0, 0.0), dev))
        side = cross(dn, ref)
        side = side / torch.clamp(torch.sqrt(torch.sum(side * side)),
                                  min=1e-6)
        t = ln * tip
        self.line(a, b, color, width)
        self.line(b, b - dn * t + side * t * 0.5, color, width)
        self.line(b, b - dn * t - side * t * 0.5, color, width)

    def arrow_2d(self, a, b, color=WHITE, width=2.0, tip=0.15):
        dev = self._where(a, b)
        a, b = _f32(a, dev), _f32(b, dev)
        d = b - a
        ln = torch.clamp(torch.sqrt(torch.sum(d * d)), min=1e-6)
        dn = d / ln
        side = torch.stack([-dn[1], dn[0]])
        t = ln * tip
        self.line_2d(a, b, color, width)
        self.line_2d(b, b - dn * t + side * t * 0.5, color, width)
        self.line_2d(b, b - dn * t - side * t * 0.5, color, width)

    def cross_2d(self, position, half_size=0.5, color=WHITE, width=2.0):
        """2D cross marker (ref: bevy_gizmos src/cross.rs)."""
        dev = self._where(position)
        p, h = _f32(position, dev), half_size
        self.line_2d(p + _f32((-h, 0.0), dev), p + _f32((h, 0.0), dev),
                     color, width)
        self.line_2d(p + _f32((0.0, -h), dev), p + _f32((0.0, h), dev),
                     color, width)

    def cross(self, position, half_size=0.5, color=WHITE, width=2.0):
        """3D axis-aligned cross marker (ref: cross.rs)."""
        dev = self._where(position)
        p = _f32(position, dev)
        for ax in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)):
            d = half_size * _f32(ax, dev)
            self.line(p - d, p + d, color, width)

    def text_2d(self, position, text, size=12.0, color=WHITE, width=1.5):
        """Debug text drawn as stroke-font polylines in 2D world space (ref:
        bevy_gizmos stroke_text.rs text_2d). Returns the measured (w, h)."""
        dev = self._where(position)
        p = _f32(position, dev)
        for poly in layout(str(text), float(size)):
            if len(poly) >= 2:
                self.linestrip_2d(p + _f32(poly, dev), color, width)
        return measure(str(text), float(size))

    def text(self, position, text, size=1.0, rotation=None, color=WHITE,
             width=1.5):
        """3D stroke text on the plane of `rotation` (a quaternion; default
        identity = the XY plane facing +Z; ref: stroke_text.rs text())."""
        dev = self._where(position, rotation)
        p = _f32(position, dev)
        for poly in layout(str(text), float(size)):
            if len(poly) < 2:
                continue
            pts = _f32([(x, y, 0.0) for x, y in poly], dev)
            if rotation is not None:
                pts = quat_rotate_vec3(_f32(rotation, dev), pts)
            self.linestrip(p + pts, color, width)
        return measure(str(text), float(size))

    def ray(self, origin, direction, color=WHITE, width=2.0):
        dev = self._where(origin, direction)
        o = _f32(origin, dev)
        self.line(o, o + _f32(direction, dev), color, width)

    def merge(self, state, tick):
        """Write this system's batches into the buffer. Each batch keeps
        its first `budget` rows, a masked batch its valid rows among those
        (masked appends take no budget); rows go on from `count` and past
        the capacity they drop. One packed copy to the device, one
        index_copy_ a buffer field."""
        if not self._segments:
            return state
        store = dict(state["res"][GIZMO_RES])
        cap, dev = store["a"].shape[0], self._dev
        budget = self._param.budget
        packs, masks = [], []
        for seg in self._segments:
            a, b, color, width, is3d = seg[:5]
            valid = seg[5] if len(seg) > 5 else None
            d = dev if valid is not None or _on_device(seg[:5]) else CPU
            a, b = _f32(a, d), _f32(b, d)
            if a.dim() == 1:
                a, b = a[None], b[None]
            if a.shape[1] == 2:
                a = torch.cat([a, torch.zeros_like(a[:, :1])], 1)
                b = torch.cat([b, torch.zeros_like(b[:, :1])], 1)
            n = min(a.shape[0], budget)
            packs.append(torch.cat([
                a[:n], b[:n], torch.broadcast_to(_f32(color, d), (n, 4)),
                torch.broadcast_to(_f32(width, d), (n,))[:, None],
                torch.broadcast_to(torch.as_tensor(is3d, device=d), (n,))
                .to(torch.float32)[:, None]], 1))
            masks.append(None if valid is None else valid[:n])
        pieces, run = [], []
        for p in packs:                  # consecutive host rows: one copy
            if p.device.type == "cpu":
                run.append(p)
                continue
            if run:
                pieces.append(torch.cat(run).to(dev))
                run = []
            pieces.append(p)
        if run:
            pieces.append(torch.cat(run).to(dev))
        rows_in = torch.cat(pieces)
        count = store["count"]
        if all(m is None for m in masks):
            rows = count + torch.arange(rows_in.shape[0], dtype=torch.int32,
                                        device=dev)
            ok = rows < cap
        else:
            v = torch.cat([torch.ones(p.shape[0], dtype=torch.bool,
                                      device=dev) if m is None else m
                           for p, m in zip(packs, masks)])
            rows = count + torch.cumsum(v.to(torch.int32), 0,
                                        dtype=torch.int32) - 1
            ok = v & (rows < cap)
        idx = torch.where(ok, rows, cap).long()
        for name, sl in _FIELDS:
            old = store[name]
            vals = rows_in[:, sl]
            if old.dtype == torch.bool:
                vals = vals > 0.5
            buf = torch.cat([old, old[:1]])      # row `cap` takes the drops
            buf.index_copy_(0, idx, vals)
            store[name] = buf[:cap]
        store["count"] = count + ok.sum(dtype=torch.int32)
        return set_in(state, ("res", GIZMO_RES), store)


register_param_type(Gizmos)


@system(name="clear_gizmos")
def clear_gizmos(g=ResMut(GIZMO_RES)):
    g.count = torch.zeros_like(g.count)


def make_gizmo_pass(width, height):
    """The gizmo pass: every buffered segment as a rotated solid quad
    (half size (len / 2 + w / 2, w / 2), z = its lane, so later appends
    draw over earlier ones) through B4 over the frame, with an all-ones
    atlas made once a device."""
    ones = {}                                    # device -> (4, 1, 1) atlas

    @system(name="gizmo_pass")
    def gizmo_pass(g=ResMut(GIZMO_RES),
                   cam2=Query(Read(Camera2d), Read(GlobalTransform)),
                   cam3=Query(Read(Camera3d), Read(GlobalTransform)),
                   target=ResMut(RenderTarget.RESOURCE),
                   stats=ResMut("render_stats")):
        with record_function("gizmo:prep"):
            cap, dev = g.a.shape[0], g.a.device
            if dev not in ones:
                ones[dev] = torch.ones((4, 1, 1), dtype=torch.float32,
                                       device=dev)
            lane = torch.arange(cap, dtype=torch.int32, device=dev)
            active = lane < g.count

            # 3D endpoints -> screen through the Camera3d
            c3, has3 = pick_camera(cam3.mask)
            gt3, k3 = cam3.global_transform, cam3.camera3d
            view = view_matrix(camera_row(gt3.translation, c3),
                               camera_row(gt3.rotation, c3),
                               camera_row(gt3.scale, c3))
            proj = perspective_infinite_reverse(
                camera_row(k3.fov, c3), width / height,
                camera_row(k3.near, c3))
            vp = proj @ view
            w1 = torch.ones((cap, 1), dtype=torch.float32, device=dev)

            def project(p):
                clip = (vp @ torch.cat([p, w1], 1).T).T
                w = clip[:, 3]
                ok = w > 1e-4
                inv = 1.0 / torch.where(ok, w, torch.ones_like(w))
                return torch.stack([(clip[:, 0] * inv * 0.5 + 0.5) * width,
                                    (0.5 - clip[:, 1] * inv * 0.5) * height],
                                   1), ok

            a3, ok_a = project(g.a)
            b3, ok_b = project(g.b)

            # 2D endpoints -> screen through the Camera2d
            c2, has2 = pick_camera(cam2.mask)
            gt2 = cam2.global_transform
            ang = quat_z_angle(camera_row(gt2.rotation, c2))
            cc, cs = torch.cos(ang), torch.sin(ang)
            cxy = camera_row(gt2.translation, c2)[:2]
            scale = camera_row(cam2.camera2d.scale, c2)
            a2 = world_to_screen_2d(g.a[:, :2], cxy, cc, cs, scale, width,
                                    height)
            b2 = world_to_screen_2d(g.b[:, :2], cxy, cc, cs, scale, width,
                                    height)

            use3 = (g.is3d & has3)[:, None]
            pa = torch.where(use3, a3, a2)
            pb = torch.where(use3, b3, b2)
            visible = active & torch.where(g.is3d, ok_a & ok_b & has3, has2)

            d = pb - pa
            length = torch.sqrt(torch.sum(d * d, 1))
            packed = pack_sprite_instances(
                center=(pa + pb) * 0.5,
                half=torch.stack([length * 0.5 + g.width * 0.5,
                                  g.width * 0.5], 1),
                rot=torch.atan2(d[:, 1], d[:, 0]), color=g.color,
                uv_min=torch.zeros((cap, 2), device=dev),
                uv_max=torch.ones((cap, 2), device=dev),
                tex=torch.full((cap,), -1, dtype=torch.int32, device=dev),
                z=lane.to(torch.float32), active=visible)
            *lists, st = bin_sprites(packed, height, width)
        with record_function("gizmo:tiles_B4"):
            target.color = sprite_tiles(target.color.contiguous(), *lists,
                                        ones[dev])
        stats.gizmo_pair_overflow = stats.gizmo_pair_overflow + \
            st["pair_overflow"]
        stats.gizmo_tile_overflow = stats.gizmo_tile_overflow + \
            st["tile_overflow"]

    return gizmo_pass


@component
class RetainedGizmo:
    """Persistent line segment drawn every frame (ref: bevy_gizmos
    src/retained.rs — retained gizmo assets beside the immediate API).
    Edit its fields in a system to animate it; despawn it to remove it."""
    a = field(3)
    b = field(3)
    color = field(4, default=WHITE)
    width = field((), default=2.0)
    is3d = field((), torch.bool, default=True)


@system(name="draw_retained_gizmos")
def draw_retained_gizmos(q=Query(RetainedGizmo), g=Gizmos(budget=1024)):
    sel = q.retained_gizmo
    # a masked batched append: only live rows take buffer rows
    g._segments.append((sel.a, sel.b, sel.color, sel.width, sel.is3d,
                        q.mask))


class GizmosPlugin(Plugin):
    """ref: GizmoPlugin + bevy_gizmos_render. `capacity` bounds the lines
    a frame. The buffer fills during Update, the pass draws it in the
    overlay set after the sprite pass and it clears in the post set.
    The gizmo pass's bin overflows count into render_stats'
    gizmo_pair_overflow / gizmo_tile_overflow."""

    def __init__(self, capacity: int = 1024):
        self.capacity = capacity

    def build(self, app):
        rp = next((p for p in app._plugins if isinstance(p, RenderPlugin)),
                  None)
        if rp is None:
            raise RuntimeError("GizmosPlugin requires RenderPlugin")
        for c in (Camera2d, Camera3d, GlobalTransform, RetainedGizmo):
            app.world.register_component(c)
        cap, dev = self.capacity, app.device
        app.insert_resource(GIZMO_RES, {
            "a": torch.zeros((cap, 3), dtype=torch.float32, device=dev),
            "b": torch.zeros((cap, 3), dtype=torch.float32, device=dev),
            "color": torch.zeros((cap, 4), dtype=torch.float32, device=dev),
            "width": torch.zeros(cap, dtype=torch.float32, device=dev),
            "is3d": torch.zeros(cap, dtype=torch.bool, device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        })
        add_render_stats(app, "gizmo_pair_overflow", "gizmo_tile_overflow")
        app.add_systems(Render, make_gizmo_pass(rp.width, rp.height),
                        in_set=OVERLAY_SET, after="sprite_pass")
        app.add_systems(Render, clear_gizmos, in_set=POST_SET)
        app.add_systems(Update, draw_retained_gizmos)
