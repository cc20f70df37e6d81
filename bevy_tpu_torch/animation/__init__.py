"""Animation and skeletal skinning (port of bevy_tpu/animation/__init__.py;
ref: bevy_animation — AnimationClip curves `src/animation_curves.rs`,
AnimationPlayer `src/lib.rs:735`; skinning: bevy_mesh SkinnedMesh joints +
inverse bindposes `src/skinning.rs:18`, the joint buffers of
bevy_pbr `src/render/skin.rs:28`).

- Clips are baked to a uniform sample rate at load: sampling is two frame
  gathers and a lerp / nlerp, batched over instances and joints.
- Joint hierarchies compose joint by joint in topological order (J is
  small and fixed) over batched (Ni, J, ...) tensors.
- Skinning is a dense (VC, J) weight-matrix product (skinned.py).

Host-side data (Skeleton, AnimationClip) is numpy; `bake_clips` puts the
clips on a device.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.message import MessageWriter, message
from bevy_tpu_torch.ecs.query import Query, Res
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.affine import TRS, trs_compose, trs_to_mat4
from bevy_tpu_torch.math.quat import quat_nlerp
from bevy_tpu_torch.time import Time


def on_device(cache, host, device):
    """`host` (a numpy array) as a tensor on `device`, copied once per
    device into the dict `cache`."""
    key = torch.device(device)
    if key not in cache:
        cache[key] = torch.as_tensor(host, device=key)
    return cache[key]


class Skeleton:
    """Host-side skeleton: parents in topological order (parent[j] < j,
    root = -1), rest-pose local TRS and inverse bindposes (ref:
    SkinnedMeshInverseBindposes), float32."""

    def __init__(self, parents, rest_translation, rest_rotation=None,
                 rest_scale=None, names: Optional[List[str]] = None,
                 inverse_bind=None):
        self.parents = np.asarray(parents, np.int32)
        j = len(self.parents)
        self.rest_t = np.asarray(rest_translation, np.float32).reshape(j, 3)
        self.rest_r = (np.asarray(rest_rotation, np.float32).reshape(j, 4)
                       if rest_rotation is not None
                       else np.tile([0, 0, 0, 1.0], (j, 1)).astype(np.float32))
        self.rest_s = (np.asarray(rest_scale, np.float32).reshape(j, 3)
                       if rest_scale is not None
                       else np.ones((j, 3), np.float32))
        self.names = names or [f"bone{i}" for i in range(j)]
        assert all(p < i for i, p in enumerate(self.parents)), \
            "parents must be topologically ordered"
        # asset formats (glTF inverseBindMatrices) give the matrices
        self._inverse_bind = None
        if inverse_bind is not None:
            self._inverse_bind = np.asarray(inverse_bind,
                                            np.float32).reshape(j, 4, 4)
        else:
            self._inverse_bind = self.inverse_bind()
        self._inverse_bind_t = {}

    @property
    def num_joints(self):
        return len(self.parents)

    def rest_global(self):
        """Rest-pose global TRS per joint: float32 torch math on the CPU,
        returned as numpy."""
        out_t = np.zeros_like(self.rest_t)
        out_r = np.zeros_like(self.rest_r)
        out_s = np.ones_like(self.rest_s)
        for j2 in range(self.num_joints):
            p = self.parents[j2]
            local = TRS(translation=torch.from_numpy(self.rest_t[j2]),
                        rotation=torch.from_numpy(self.rest_r[j2]),
                        scale=torch.from_numpy(self.rest_s[j2]))
            if p < 0:
                g = local
            else:
                g = trs_compose(TRS(translation=torch.from_numpy(out_t[p]),
                                    rotation=torch.from_numpy(out_r[p]),
                                    scale=torch.from_numpy(out_s[p])), local)
            out_t[j2] = g["translation"].numpy()
            out_r[j2] = g["rotation"].numpy()
            out_s[j2] = g["scale"].numpy()
        return out_t, out_r, out_s

    def inverse_bind(self) -> np.ndarray:
        """(J, 4, 4) inverse bindpose matrices (host numpy)."""
        if self._inverse_bind is not None:
            return self._inverse_bind
        t, r, s = self.rest_global()
        mats = trs_to_mat4(TRS(translation=torch.from_numpy(t),
                               rotation=torch.from_numpy(r),
                               scale=torch.from_numpy(s))).numpy()
        return np.linalg.inv(mats).astype(np.float32)

    def inverse_bind_on(self, device) -> torch.Tensor:
        """inverse_bind() as a tensor on `device` (copied once)."""
        return on_device(self._inverse_bind_t, self.inverse_bind(), device)


class AnimationClip:
    """Host clip: a pose function sampled to a uniform rate (ref:
    AnimationClip curves; authored keyframes resample the same way)."""

    def __init__(self, duration: float, pose_fn: Callable[[float], dict],
                 rate: float = 30.0):
        """pose_fn(time) -> {'translation': (J,3), 'rotation': (J,4),
        'scale': (J,3)} local joint pose (numpy-convertible)."""
        self.duration = float(duration)
        self.rate = float(rate)
        frames = max(2, int(round(duration * rate)) + 1)
        ts, rs, ss = [], [], []
        for f in range(frames):
            pose = pose_fn(f / rate)
            ts.append(np.asarray(pose["translation"], np.float32))
            rs.append(np.asarray(pose["rotation"], np.float32))
            ss.append(np.asarray(pose.get("scale",
                                          np.ones_like(ts[-1])), np.float32))
        self.t = np.stack(ts)    # (F, J, 3)
        self.r = np.stack(rs)    # (F, J, 4)
        self.s = np.stack(ss)    # (F, J, 3)

    @property
    def num_frames(self):
        return self.t.shape[0]


@component
class AnimationPlayer:
    """ref: AnimationPlayer (lib.rs:735) + AnimationTransitions
    (transition.rs): the active clip crossfades from `prev_clip` while
    `blend` ramps 0 -> 1 at `blend_rate` per second."""
    clip = field((), torch.int32)
    time = field(())
    speed = field((), default=1.0)
    playing = field((), torch.bool, default=True)
    prev_clip = field((), torch.int32)
    prev_time = field(())
    blend = field((), default=1.0)       # 1 = fully on `clip`
    blend_rate = field((), default=4.0)  # 1/seconds


def start_transition(world, entity, clip: int, duration: float = 0.25):
    """Host helper: crossfade the player to `clip` over `duration` seconds
    (ref: AnimationTransitions::play)."""
    cur = world.get(entity, AnimationPlayer)
    world.insert(entity, AnimationPlayer(
        clip=clip, time=0.0, speed=float(cur.speed),
        playing=bool(cur.playing),
        prev_clip=int(cur.clip), prev_time=float(cur.time),
        blend=0.0, blend_rate=1.0 / max(duration, 1e-3)))


def advance_players(durations):
    """Update-system factory: advance and wrap the player clocks and blend
    ramps (ref: advance_animations + advance_transitions). The wrap is a
    floor modulo (torch.remainder), as the reference's: a negative speed
    wraps to the clip's end."""
    host = np.asarray(durations, np.float32)
    cache = {}

    @system(name="advance_animations")
    def advance_animations(q=Query(AnimationPlayer), time=Res(Time)):
        p = q.animation_player
        durs = on_device(cache, host, p.time.device)
        dt = torch.where(p.playing, time.delta, 0.0) * p.speed

        def adv(t, clip):
            d = durs[torch.clamp(clip, 0, durs.shape[0] - 1).long()]
            return torch.remainder(t + dt, torch.clamp(d, min=1e-6))

        p.time = torch.where(q.mask, adv(p.time, p.clip), p.time)
        p.prev_time = torch.where(q.mask, adv(p.prev_time, p.prev_clip),
                                  p.prev_time)
        p.blend = torch.where(q.mask, torch.clamp(
            p.blend + time.delta * p.blend_rate, max=1.0), p.blend)

    return advance_animations


def bake_clips(clips: List[AnimationClip], device="cuda"):
    """Pad clips to one (C, F, J, 10) tensor on `device`, with per-clip
    frame counts and rates."""
    fmax = max(c.num_frames for c in clips)
    j = clips[0].t.shape[1]
    data = np.zeros((len(clips), fmax, j, 10), np.float32)
    counts, rates = [], []
    for i, c in enumerate(clips):
        f = c.num_frames
        data[i, :f, :, 0:3] = c.t
        data[i, :f, :, 3:7] = c.r
        data[i, :f, :, 7:10] = c.s
        data[i, f:] = data[i, f - 1]
        counts.append(f)
        rates.append(c.rate)
    return (torch.as_tensor(data, device=device),
            torch.as_tensor(np.asarray(counts, np.int32), device=device),
            torch.as_tensor(np.asarray(rates, np.float32), device=device))


def sample_pose(clip_data, counts, rates, clip_ids, times):
    """Batched clip sampling: (Ni,) clip ids + times -> local joint TRS
    (Ni, J, ...): two frame gathers and a lerp / nlerp (ref: curve
    evaluation)."""
    ci = torch.clamp(clip_ids.long(), 0, clip_data.shape[0] - 1)
    f = times * rates[ci]
    f0f = torch.floor(f)
    alpha = (f - f0f)[:, None, None]
    fmax = counts[ci].long() - 1
    f0 = torch.minimum(torch.clamp(f0f.long(), min=0), fmax)
    f1 = torch.minimum(f0 + 1, fmax)
    p0 = clip_data[ci, f0]        # (Ni, J, 10)
    p1 = clip_data[ci, f1]
    t = p0[..., 0:3] * (1 - alpha) + p1[..., 0:3] * alpha
    r = quat_nlerp(p0[..., 3:7], p1[..., 3:7], alpha)
    s = p0[..., 7:10] * (1 - alpha) + p1[..., 7:10] * alpha
    return TRS(translation=t, rotation=r, scale=s)


def sample_pose_blended(clip_data, counts, rates, player):
    """Crossfaded pose: nlerp(prev, cur, blend) (ref: the blend graph's
    two-node case). `player` holds (Ni,) columns clip, time, prev_clip,
    prev_time, blend."""
    cur = sample_pose(clip_data, counts, rates, player["clip"],
                      player["time"])
    prev = sample_pose(clip_data, counts, rates, player["prev_clip"],
                       player["prev_time"])
    b = player["blend"][:, None, None]
    return TRS(
        translation=prev["translation"] * (1 - b) + cur["translation"] * b,
        rotation=quat_nlerp(prev["rotation"], cur["rotation"], b),
        scale=prev["scale"] * (1 - b) + cur["scale"] * b)


def compose_joints(skeleton: Skeleton, local: TRS) -> TRS:
    """Batched hierarchy composition in topological order, one step a
    joint over (Ni, J, ...) tensors (ref: bevy_transform propagation
    specialised to skeletons)."""
    t, r, s = local["translation"], local["rotation"], local["scale"]
    gt, gr, gs = [], [], []
    for j2 in range(skeleton.num_joints):
        lj = TRS(translation=t[:, j2], rotation=r[:, j2], scale=s[:, j2])
        p = int(skeleton.parents[j2])
        if p < 0:
            g = lj
        else:
            g = trs_compose(TRS(translation=gt[p], rotation=gr[p],
                                scale=gs[p]), lj)
        gt.append(g["translation"])
        gr.append(g["rotation"])
        gs.append(g["scale"])
    return TRS(translation=torch.stack(gt, 1), rotation=torch.stack(gr, 1),
               scale=torch.stack(gs, 1))


def skin_matrices(skeleton: Skeleton, global_trs: TRS) -> torch.Tensor:
    """(Ni, J, 4, 4) = joint global @ inverse bind (ref: skin.rs joint
    buffer build)."""
    mats = trs_to_mat4(global_trs)                     # (Ni, J, 4, 4)
    inv_bind = skeleton.inverse_bind_on(mats.device)
    return torch.einsum("njab,jbc->njac", mats, inv_bind)


@message
class AnimationEvent:
    """ref: bevy_animation/src/animation_event.rs — a payload fired when a
    player's clock crosses an authored timestamp."""
    entity = field((), torch.int32)
    code = field((), torch.int32)


def make_animation_event_system(durations, events, budget: int = 64):
    """Update-system factory (run AFTER advance_animations): sends an
    AnimationEvent for every (clip, timestamp, code) in `events` whose
    timestamp the player's clock crossed this frame, wrap-aware (ref:
    trigger_animation_events). The clock before the advance is a floor
    modulo, as the reference's."""
    host = {
        "durs": np.asarray(durations, np.float32),
        "clip": np.asarray([e[0] for e in events], np.int32),
        "t": np.asarray([e[1] for e in events], np.float32),
        "code": np.asarray([e[2] for e in events], np.int32)}
    caches = {k: {} for k in host}
    n_ev = len(events)

    @system(name="animation_events")
    def animation_events(q=Query(AnimationPlayer), time=Res(Time),
                         w=MessageWriter(AnimationEvent, budget=budget)):
        p = q.animation_player
        dev = p.time.device
        durs, ev_clip, ev_t, ev_code = (
            on_device(caches[k], host[k], dev)
            for k in ("durs", "clip", "t", "code"))
        dt = torch.where(p.playing, time.delta, 0.0) * p.speed
        d = durs[torch.clamp(p.clip, 0, durs.shape[0] - 1).long()]
        # the clock BEFORE this frame's advance (advance ran already)
        old = torch.remainder(p.time - dt, torch.clamp(d, min=1e-6))
        tnew = p.time[:, None]
        told = old[:, None]
        ts = ev_t[None, :]
        match = (p.clip[:, None] == ev_clip[None, :]) & \
            q.mask[:, None] & (dt[:, None] > 0)
        nowrap = (told < ts) & (ts <= tnew)
        wrapped = (tnew < told) & ((ts > told) | (ts <= tnew))
        fire = (match & (nowrap | wrapped)).reshape(-1)
        ni = p.time.shape[0]
        ent = torch.arange(ni, dtype=torch.int32, device=dev)[:, None] \
            .expand(ni, n_ev).reshape(-1)
        code = ev_code[None, :].expand(ni, n_ev).reshape(-1)
        fire32 = fire.to(torch.int32)
        pos = torch.cumsum(fire32, 0) - 1
        tgt = torch.where(fire & (pos < budget), pos, budget).long()
        ent_buf = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
        ent_buf[tgt] = ent
        code_buf = torch.zeros(budget + 1, dtype=torch.int32, device=dev)
        code_buf[tgt] = code
        total = torch.clamp(fire32.sum(), max=budget)
        w.send(count=total, entity=ent_buf[:budget], code=code_buf[:budget])

    return animation_events
