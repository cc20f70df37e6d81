"""Animation blend graphs (port of bevy_tpu/animation/graph.py; ref:
bevy_animation's `AnimationGraph` — a DAG of Clip / Blend / Add nodes
with weights, `src/graph.rs`).

The graph's shape is static (host side), so evaluation unrolls node by
node: each node's pose is a batched (Ni, J, ...) TRS; Blend nodes
nlerp-accumulate their children by normalised weight, Add nodes layer a
difference pose on top (ref: graph.rs AnimationNodeType::Add).
Per-instance node times, speeds and weights live in one fixed-width
component (`MAX_NODES` lanes).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from bevy_tpu_torch.animation import on_device
from bevy_tpu_torch.ecs.component import component, field
from bevy_tpu_torch.ecs.query import Query, Res
from bevy_tpu_torch.ecs.system import system
from bevy_tpu_torch.math.affine import TRS
from bevy_tpu_torch.math.quat import quat_mul, quat_nlerp
from bevy_tpu_torch.time import Time

MAX_NODES = 16


@component
class AnimationGraphPlayer:
    """Per-instance graph state, one lane a node (ref: the active
    animations of AnimationPlayer + graph node weights)."""
    times = field(MAX_NODES)
    speeds = field(MAX_NODES)         # 0 = paused
    weights = field(MAX_NODES)


class GraphNode:
    def __init__(self, kind, clip=-1, children=None, weight=1.0,
                 mask=None):
        self.kind = kind                  # "clip" | "blend" | "add"
        self.clip = clip
        self.children: List[int] = children or []
        self.weight = weight
        self.mask = mask                  # (J,) joint mask or None (all)
        self._mask_t = {}


class AnimationGraph:
    """Host-side graph builder (ref: AnimationGraph::add_clip/add_blend).

    >>> g = AnimationGraph()
    >>> walk = g.add_clip(0); run = g.add_clip(1)
    >>> root = g.add_blend([walk, run])
    """

    def __init__(self):
        self.nodes: List[GraphNode] = []
        self.root: Optional[int] = None

    def add_clip(self, clip: int, weight=1.0, mask=None) -> int:
        """`mask` (J,) restricts the clip to a joint subset (ref: graph.rs
        node masks — upper/lower body splits)."""
        self.nodes.append(GraphNode("clip", clip=clip, weight=weight,
                                    mask=mask))
        return self._added()

    def add_blend(self, children: List[int], weight=1.0) -> int:
        self.nodes.append(GraphNode("blend", children=children,
                                    weight=weight))
        return self._added()

    def add_additive(self, base: int, layers: List[int], weight=1.0) -> int:
        """Additive node: the layers' deviation from the identity scales
        by their weights on top of the base pose (ref:
        AnimationNodeType::Add)."""
        self.nodes.append(GraphNode("add", children=[base] + layers,
                                    weight=weight))
        return self._added()

    def _added(self) -> int:
        idx = len(self.nodes) - 1
        assert idx < MAX_NODES, f"graph exceeds {MAX_NODES} nodes"
        self.root = idx
        return idx

    def default_player(self, **overrides):
        """An AnimationGraphPlayer with every node playing at its
        authored weight."""
        w = [0.0] * MAX_NODES
        s = [0.0] * MAX_NODES
        for i, n in enumerate(self.nodes):
            w[i] = n.weight
            s[i] = 1.0
        kw = dict(times=[0.0] * MAX_NODES, speeds=s, weights=w)
        kw.update(overrides)
        return AnimationGraphPlayer(**kw)

    def sample(self, clip_data, counts, rates, player_cols, rows):
        """Evaluate the graph for instance `rows` (a long tensor).
        player_cols is the AnimationGraphPlayer column view; returns TRS
        (Ni, J, ...)."""
        from bevy_tpu_torch.animation import sample_pose

        times = player_cols.times[rows]          # (Ni, MAX_NODES)
        weights = player_cols.weights[rows]
        poses = [None] * len(self.nodes)
        eff_w = [None] * len(self.nodes)         # (Ni, J) per joint

        def joint_w(w, n, j):
            wj = w[:, None].expand(w.shape[0], j)
            if n.mask is not None:
                wj = wj * on_device(n._mask_t,
                                    np.asarray(n.mask, np.float32),
                                    w.device)[None, :]
            return wj

        for i, n in enumerate(self.nodes):
            w = weights[:, i]
            if n.kind == "clip":
                cid = torch.full((rows.shape[0],), n.clip, dtype=torch.int32,
                                 device=rows.device)
                poses[i] = sample_pose(clip_data, counts, rates, cid,
                                       times[:, i])
                eff_w[i] = joint_w(w, n, poses[i]["translation"].shape[1])
            elif n.kind == "blend":
                total = None
                acc_t = acc_r = acc_s = None
                for c in n.children:
                    p = poses[c]
                    if acc_t is None:
                        total = eff_w[c]
                        acc_t = p["translation"]
                        acc_r = p["rotation"]
                        acc_s = p["scale"]
                    else:
                        new_total = total + eff_w[c]
                        frac = (eff_w[c] /
                                torch.clamp(new_total, min=1e-8))[:, :, None]
                        acc_t = acc_t * (1 - frac) + p["translation"] * frac
                        acc_r = quat_nlerp(acc_r, p["rotation"], frac)
                        acc_s = acc_s * (1 - frac) + p["scale"] * frac
                        total = new_total
                poses[i] = TRS(translation=acc_t, rotation=acc_r,
                               scale=acc_s)
                eff_w[i] = joint_w(w, n, acc_t.shape[1])
            elif n.kind == "add":
                base = poses[n.children[0]]
                t = base["translation"]
                r = base["rotation"]
                s = base["scale"]
                for c in n.children[1:]:
                    lw = eff_w[c][:, :, None]
                    layer = poses[c]
                    t = t + layer["translation"] * lw
                    ident = torch.zeros_like(layer["rotation"])
                    ident[..., 3] = 1.0
                    lr = quat_nlerp(ident, layer["rotation"], lw)
                    r = quat_mul(lr, r)
                    s = s * (1.0 + (layer["scale"] - 1.0) * lw)
                poses[i] = TRS(translation=t, rotation=r, scale=s)
                eff_w[i] = joint_w(w, n, t.shape[1])
            else:
                raise ValueError(n.kind)
        return poses[self.root]


def advance_graph_players(durations, graph: AnimationGraph):
    """Update-system factory: advance every node clock, wrapping at its
    clip's duration by a floor modulo (ref: advance_animations)."""
    host = np.asarray(
        [float(durations[n.clip]) if n.kind == "clip" and
         0 <= n.clip < len(durations) else 1.0
         for n in graph.nodes] + [1.0] * (MAX_NODES - len(graph.nodes)),
        np.float32)
    cache = {}

    @system(name="advance_graph_players")
    def advance(q=Query(AnimationGraphPlayer), time=Res(Time)):
        p = q.animation_graph_player
        node_dur = on_device(cache, host, p.times.device)
        t = torch.remainder(p.times + time.delta * p.speeds,
                            torch.clamp(node_dur, min=1e-6))
        p.times = torch.where(q.mask[:, None], t, p.times)

    return advance
