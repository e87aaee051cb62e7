"""KV-cache writes as in-place indexed writes (port of
`repro.models.cache_update`).

The JAX package rewrites the whole cache with a masked `where` so that XLA
can partition the update along a sharded sequence axis.  Eagerly, on one
device, the port writes only the rows that change: each function updates
``cache`` in place and returns it.
"""

from __future__ import annotations

from typing import Union

import torch

Index = Union[int, torch.Tensor]


def write_row(cache: torch.Tensor, row: torch.Tensor, index: Index) -> torch.Tensor:
    """Write ``row`` (B, 1, ...) at sequence position ``index`` of ``cache``
    (B, S, ...).  A (B,) ``index`` writes each batch row at its own position
    (continuous batching: every slot has its own length).  Positions must
    lie in [0, S)."""
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, index.to(device=cache.device, dtype=torch.long)] = row[:, 0].to(cache.dtype)
    else:
        cache[:, int(index)] = row[:, 0].to(cache.dtype)
    return cache


def insert_rows(big: torch.Tensor, small: torch.Tensor, slots: torch.Tensor, axis: int) -> torch.Tensor:
    """Replace the batch rows ``slots`` (along ``axis``) of ``big`` with
    ``small``'s rows: the slot insert of continuous batching.  Whole-row
    replacement, so a new occupant cannot read its predecessor's KV."""
    slots = slots.to(device=big.device, dtype=torch.long)
    return big.index_copy_(axis, slots, small.to(big.dtype))


def write_segment(cache: torch.Tensor, seg: torch.Tensor, index: int) -> torch.Tensor:
    """Write ``seg`` (B, L, ...) at positions [index, index + L)."""
    L = seg.shape[1]
    cache[:, index : index + L] = seg.to(cache.dtype)
    return cache
