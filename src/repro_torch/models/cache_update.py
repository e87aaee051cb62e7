"""KV-cache writes as in-place indexed writes (port of
`repro.models.cache_update`).

The JAX package rewrites the whole cache with a masked `where` so that XLA
can partition the update along a sharded sequence axis.  Eagerly, on one
device, the port writes only the rows that change: each function updates
``cache`` in place and returns it.

A DTensor cache (a sharded run, placed by `launch.shardings.cache_pspec`)
is written on each rank's shard: the new rows take the cache's layout
first (JAX constrains the written cache the same way), with the sequence
whole.  Where the cache's sequence dim is unsharded the write is the
indexed one on the local shard; where it is sharded (the tiny-batch
long-decode layout, MLA's latent) only the rank that holds a position
writes it, by JAX's masked ``where`` over its own part of the sequence.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.util import is_dtensor

Index = Union[int, torch.Tensor]


def _sharded_write(cache, seg, index: Index, write) -> None:
    """``write(local cache, local rows, index)`` on the DTensor ``cache``'s
    shard, or the masked write where its sequence dim (1) is sharded."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    rep = [Replicate()] * mesh.ndim

    def local(x, placements):
        x = x if isinstance(x, DTensor) else DTensor.from_local(x, mesh, rep, run_check=False)
        return x.redistribute(mesh, placements).to_local()

    rows = local(seg.to(cache.dtype), [Replicate() if p == Shard(1) else p for p in pl])
    if isinstance(index, torch.Tensor) and index.dim() == 1:  # (B,): the batch's shards
        index = local(index.to(device=cache.device), [p if p == Shard(0) else Replicate()
                                                       for p in pl])
    c = cache.to_local()
    if Shard(1) not in pl:
        write(c, rows, index)
        return
    S, L = cache.shape[1], seg.shape[1]
    seq = [Shard(0) if p == Shard(1) else Replicate() for p in pl]
    pos = distribute_tensor(torch.arange(S, device=c.device), mesh, seq,
                            src_data_rank=None).to_local()  # this shard's positions
    off = pos - torch.as_tensor(index, device=c.device).reshape(-1, 1)  # (1 or B, S_local)
    hit = (off >= 0) & (off < L)
    b = torch.arange(rows.shape[0], device=c.device)[:, None]
    new = rows[b, off.clamp(0, L - 1).expand(rows.shape[0], -1)]  # (B, S_local, ...)
    c.copy_(torch.where(hit.reshape(*hit.shape, *[1] * (c.dim() - 2)), new, c))


def write_row(cache: torch.Tensor, row: torch.Tensor, index: Index) -> torch.Tensor:
    """Write ``row`` (B, 1, ...) at sequence position ``index`` of ``cache``
    (B, S, ...).  A (B,) ``index`` writes each batch row at its own position
    (continuous batching: every slot has its own length).  Positions must
    lie in [0, S)."""
    if is_dtensor(cache):
        _sharded_write(cache, row, index, _write_row)
        return cache
    return _write_row(cache, row, index)


def _write_row(cache: torch.Tensor, row: torch.Tensor, index: Index) -> torch.Tensor:
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
    if is_dtensor(cache):
        _sharded_write(cache, seg, int(index), _write_segment)
        return cache
    return _write_segment(cache, seg, index)


def _write_segment(cache: torch.Tensor, seg: torch.Tensor, index: int) -> torch.Tensor:
    L = seg.shape[1]
    cache[:, index : index + L] = seg.to(cache.dtype)
    return cache
