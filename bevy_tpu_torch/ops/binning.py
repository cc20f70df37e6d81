"""Tile binning primitive (port of bevy_tpu/ops/binning.py; ref: the
GPU-driven binning of bevy_render batching/gpu_preprocessing.rs).

Variable-length run expansion under a static capacity: overflow is
counted, never a crash, and no output shape depends on the data.
"""

from __future__ import annotations

import torch


def expand_runs(counts, capacity: int):
    """Expand N variable-length runs into a flat list of (owner, rank) pairs.

    counts: (N,) int32 — length of each run (0 allowed).
    capacity: static output length P.
    Returns (owner, rank, valid, total):
      owner (P,) int32 — which run each slot belongs to (clipped when invalid)
      rank  (P,) int32 — position inside the run
      valid (P,) bool  — slot < total pairs
      total ()   int32 — sum(counts) (may exceed capacity ⇒ overflow)
    """
    counts = counts.to(torch.int32)
    dev = counts.device
    n = counts.shape[0]
    ends = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = ends - counts
    pos = torch.arange(capacity, dtype=torch.int32, device=dev)
    # owner: mark each run's start slot with its index, then forward-fill
    # (scatter-max + cummax; slot `capacity` takes the dropped marks)
    mark_at = torch.where((counts > 0) & (starts < capacity), starts,
                          capacity)
    mark = torch.full((capacity + 1,), -1, dtype=torch.int32, device=dev)
    mark.scatter_reduce_(0, mark_at.long(),
                         torch.arange(n, dtype=torch.int32, device=dev),
                         "amax")
    owner = torch.cummax(mark[:capacity], 0).values
    owner_c = torch.clamp(owner, 0, max(n - 1, 0))
    rank = pos - starts[owner_c]
    total = ends[-1] if n > 0 else torch.zeros((), dtype=torch.int32,
                                               device=dev)
    valid = pos < torch.clamp(total, max=capacity)
    return owner_c, rank, valid, total
