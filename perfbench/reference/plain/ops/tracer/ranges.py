"""The bundle tracer's work list: each bundle's walk cut into ranges of at
most RANGE_CHUNKS chunks (one CUDA block each in csrc/trace_{fwd,bwd}.cu).

A range never crosses a bundle and a bundle of at most RANGE_CHUNKS chunks
is one range. The list is built on the tensors' device from seg_count alone
(a cumsum and a searchsorted, no host read); its length is a bound taken
from the payload's column count, and the entries past the real ranges name
bundle NB (the kernels skip them). The plain versions walk the same list.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from perfbench.reference.plain.ops.tracer.layout import K_CHUNK

# Chunks per range. A surfel2 training step's walks (PERF.md §6) are short
# (median 6 chunks) with a tail of silhouette bundles up to ~800 chunks; at
# 8 a range is about a hundred microseconds of one block's hit tests and the
# step still gives ~5,000 ranges (ring view 0: ~59,000) for 132 SMs.
RANGE_CHUNKS = 8


class RangeList(NamedTuple):
    bundle: torch.Tensor  # (max_ranges,) int32 bundle of each range; NB past the list
    chunk0: torch.Tensor  # (max_ranges,) int32 the range's first chunk in its bundle
    range_off: torch.Tensor  # (NB + 1,) int32 first range of each bundle (exclusive cumsum)


def max_ranges(cols: int, nb: int, R: int) -> int:
    """A bound on the ranges of any segment layout inside `cols` payload
    columns (every chunk lies there): sum ceil(c / R) <= min(C, C / R + NB)."""
    chunks = cols // K_CHUNK
    return max(min(chunks, chunks // R + nb), 0)


def chunk_ranges(seg_count: torch.Tensor, R: int, n_max: int) -> RangeList:
    """The work list for walks of ceil(seg_count / 128) chunks, cut at R."""
    if R < 1:
        raise ValueError(f"ranges need at least one chunk, got R={R}")
    nb = seg_count.shape[0]
    dev = seg_count.device
    n_chunks = (seg_count.long() + K_CHUNK - 1) // K_CHUNK
    n_ranges = (n_chunks + R - 1) // R
    range_off = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    torch.cumsum(n_ranges, 0, out=range_off[1:])
    i = torch.arange(n_max, dtype=torch.int64, device=dev)
    bundle = torch.searchsorted(range_off[1:], i, right=True)
    first = range_off[torch.clamp(bundle, max=max(nb - 1, 0))] if nb else torch.zeros_like(i)
    chunk0 = (i - first) * R
    return RangeList(bundle.to(torch.int32), chunk0.to(torch.int32), range_off.to(torch.int32))
