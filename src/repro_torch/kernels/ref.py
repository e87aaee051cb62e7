"""Plain PyTorch versions of the attention kernels (the port of
`repro.kernels.ref`, attention half).

They are the ground truth the CUDA kernels are held against on the card,
and the path a wrapper takes for a tensor that lies on the CPU.  Written
naively (full materialisation) for auditability.

All arithmetic is fp32 whatever the input dtypes; the output takes q's
dtype, as the kernels' does.  Where every position of a row is masked the
result is 0 (the kernels divide by ``max(l, 1e-30)``), not the NaN of a
plain softmax; no caller produces such a row.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None or cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


def _masked_softmax_av(
    logits: torch.Tensor, mask: torch.Tensor, v: torch.Tensor, eq: str
) -> torch.Tensor:
    """exp-normalise fp32 ``logits`` under ``mask`` and contract with v."""
    s = logits.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum(eq, p / l.clamp_min(1e-30), v)


def mha_reference(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)   K divides H (GQA)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Naive attention with GQA head grouping, causal/sliding masks, softcap."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    if H % K:
        raise ValueError(f"n_heads {H} not a multiple of n_kv_heads {K}")
    group = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Sq, K, group, D) * scale
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    logits = softcap(logits, logit_cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None and window > 0:
        mask &= k_pos > q_pos - window
    out = _masked_softmax_av(logits, mask, v.float(), "bkgqs,bskd->bqkgd")
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # (B, H, D)          one new token
    k_cache: torch.Tensor,  # (B, S, K, D)
    v_cache: torch.Tensor,  # (B, S, K, D)
    cache_len: torch.Tensor,  # (B,) int valid lengths
    *,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA by reshaping q to (B, K, G, D): the cache is never repeated."""
    B, H, D = q.shape
    _, S, K, _ = k_cache.shape
    group = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, K, group, D) * scale
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    logits = softcap(logits, logit_cap)
    clen = cache_len.to(device=q.device, dtype=torch.int64)[:, None]
    pos = torch.arange(S, device=q.device)[None, :]
    valid = pos < clen
    if window is not None and window > 0:
        valid &= pos > clen - 1 - window
    out = _masked_softmax_av(
        logits, valid[:, None, None, :], v_cache.float(), "bkgs,bskd->bkgd"
    )
    return out.reshape(B, H, v_cache.shape[-1]).to(q.dtype)
