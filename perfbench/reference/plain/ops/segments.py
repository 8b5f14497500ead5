"""Sorted-segment layout for the bundle tracer's chunked kernel
(materialrefgs_tpu/ops/segments.py).

Given candidate pairs (segment id, sort key, valid flag), produce a
fixed-capacity layout where each segment's pairs are contiguous, sorted by
key, and each segment starts at a K_CHUNK-aligned offset. The 128-pair chunk
boundaries this fixes are part of the tracer's exact-order semantics (each
ray sorts its hits within a chunk, not across chunks).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

K_CHUNK = 128


class SegmentLayout(NamedTuple):
    perm_pos: torch.Tensor  # (N,) int32 destination slot per input pair (== capacity -> dropped)
    seg_start: torch.Tensor  # (S+1,) int32 aligned start offsets
    seg_count: torch.Tensor  # (S,) int32 valid pairs per segment
    num_kept: torch.Tensor  # () int32
    overflow: torch.Tensor  # () int32


def build_aligned_segments(
    seg_id: torch.Tensor,  # (N,) int in [0, S); invalid pairs may hold anything
    sort_key: torch.Tensor,  # (N,) f32 ordering within segment
    valid: torch.Tensor,  # (N,) bool
    num_segments: int,
    capacity: int,
) -> SegmentLayout:
    if capacity % K_CHUNK:
        raise ValueError(f"capacity {capacity} is not a multiple of {K_CHUNK}")
    dev = seg_id.device
    N = seg_id.shape[0]
    S = num_segments
    i32 = dict(dtype=torch.int32, device=dev)
    sid = torch.where(valid, seg_id.to(torch.int32), torch.full_like(seg_id, S, dtype=torch.int32))

    # The JAX package's stable two-key lax.sort on (segment, key): a stable
    # sort by key, then a stable sort by segment, gives the same order.
    by_key = torch.sort(sort_key.to(torch.float32), stable=True).indices
    by_sid = torch.sort(sid[by_key], stable=True).indices
    order = by_key[by_sid]
    sid_sorted = sid[order]

    raw_start = torch.searchsorted(sid_sorted, torch.arange(S + 1, **i32), side="left").to(torch.int32)
    counts = raw_start[1:] - raw_start[:-1]
    if capacity >= 2 * S * K_CHUNK:
        # Graceful truncation: when demand exceeds capacity, every segment
        # shrinks in proportion and keeps its nearest pairs (float32 ratio,
        # as the JAX package computes it).
        padded = (counts + K_CHUNK - 1) // K_CHUNK * K_CHUNK
        total_padded = torch.sum(padded)
        f32 = dict(dtype=torch.float32, device=dev)
        ratio = (torch.tensor(capacity, **f32) - torch.tensor(S * K_CHUNK, **f32)) / torch.clamp(
            total_padded.to(torch.float32), min=1.0
        )
        counts_eff = torch.where(
            total_padded <= capacity,
            counts,
            torch.floor(counts.to(torch.float32) * ratio).to(torch.int32),
        )
    else:
        # Capacity cannot give every segment one chunk: leading segments
        # keep their pairs, trailing ones are cut at the capacity.
        counts_eff = counts
    padded_eff = (counts_eff + K_CHUNK - 1) // K_CHUNK * K_CHUNK
    padded_start = torch.cat([torch.zeros(1, **i32), torch.cumsum(padded_eff, 0).to(torch.int32)])
    seg_start = torch.clamp(padded_start, max=capacity)
    seg_count = torch.minimum(counts_eff, seg_start[1:] - seg_start[:-1]).to(torch.int32)

    # Destination of each sorted pair: its segment's start plus its rank
    # inside the segment; pairs past the segment's kept count are dropped.
    seg_of = torch.clamp(sid_sorted, max=max(S - 1, 0)).long()
    rank = torch.arange(N, **i32)
    local = rank - raw_start[seg_of]
    keep = (sid_sorted < S) & (local < seg_count[seg_of])
    pos_sorted = torch.where(keep, seg_start[seg_of] + local, torch.full_like(local, capacity))

    perm_pos = torch.empty(N, **i32)
    perm_pos[order] = pos_sorted
    num_kept = torch.sum(seg_count).to(torch.int32)
    return SegmentLayout(
        perm_pos=perm_pos,
        seg_start=seg_start,
        seg_count=seg_count,
        num_kept=num_kept,
        overflow=(torch.sum(valid.to(torch.int32)) - num_kept).to(torch.int32),
    )


def scatter_pairs(values: torch.Tensor, perm_pos: torch.Tensor, capacity: int, fill=0):
    """Scatter (N, ...) values into (capacity, ...) slots (dropped -> fill)."""
    out = torch.full((capacity,) + tuple(values.shape[1:]), fill, dtype=values.dtype, device=values.device)
    kept = perm_pos < capacity
    out[perm_pos[kept].long()] = values[kept]
    return out
