"""Plain PyTorch oracles (the port of `repro.kernels.ref`: attention and
the Mamba2 SSD scan).

Written naively (full materialisation, or one step at a time) for
auditability.  The attention references are the plain versions the CUDA
attention kernels are held against on the card and the path their
wrappers take for a CPU tensor; the SSD references are the oracles of the
chunked plain scan in `mamba2_ssd.py`.

All arithmetic is fp32 whatever the input dtypes; the output takes the
input's dtype (q, x), as the kernels' does.  Where every position of an
attention row is masked the result is 0 (the kernels divide by
``max(l, 1e-30)``), not the NaN of a plain softmax; no caller produces
such a row.
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


# ---------------------------------------------------------------------------
# Mamba2 / SSD (state-space dual) scan
# ---------------------------------------------------------------------------

def ssd_reference(
    x: torch.Tensor,  # (B, S, H, P)   inputs per head
    dt: torch.Tensor,  # (B, S, H)      softplus'd timestep
    A: torch.Tensor,  # (H,)           negative decay rate
    Bmat: torch.Tensor,  # (B, S, G, N)   G groups broadcast over H
    Cmat: torch.Tensor,  # (B, S, G, N)
    D: Optional[torch.Tensor] = None,  # (H,) skip
    *,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    return_state: bool = False,
):
    """Sequential (exact) SSD recurrence, one step at a time:
        h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t (+ D x_t)
    with a per-head fp32 state (P, N)."""
    Bz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    Bh = Bmat.float().repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = Cmat.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    decay = torch.exp(A.float()[None, None, :] * dtf)  # (B,S,H)
    h = (init_state.float() if init_state is not None
         else torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device))
    ys = []
    for t in range(S):
        h = h * decay[:, t, :, None, None] + (
            (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        )
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)  # (B,S,H,P)
    if D is not None:
        y = y + xf * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    return (y, h) if return_state else y


def ssd_chunked_reference(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bmat: torch.Tensor,
    Cmat: torch.Tensor,
    D: Optional[torch.Tensor] = None,
    *,
    chunk: int = 64,
    init_state: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Matmul-form chunked SSD over all chunks at once (the algorithm the
    kernel implements): the within-chunk quadratic term, then the
    cross-chunk state recurrence.  S must be a multiple of ``chunk``."""
    Bz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    rep = H // G
    xf = x.float().reshape(Bz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bz, nc, chunk, H)
    Bh = Bmat.float().repeat_interleave(rep, dim=2).reshape(Bz, nc, chunk, H, N)
    Ch = Cmat.float().repeat_interleave(rep, dim=2).reshape(Bz, nc, chunk, H, N)

    a_cum = torch.cumsum(A.float()[None, None, None, :] * dtf, dim=2)  # (B,nc,c,H)
    a_total = a_cum[:, :, -1, :]  # (B,nc,H)
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bnthk,bnshk->bntsh", Ch, Bh) * L
    y_intra = torch.einsum("bntsh,bnsh,bnshp->bnthp", scores, dtf, xf)

    decay_to_end = torch.exp(a_total[:, :, None, :] - a_cum)  # (B,nc,c,H)
    chunk_state = torch.einsum("bnch,bnch,bnchk,bnchp->bnhpk", decay_to_end, dtf, Bh, xf)
    h = (init_state.float() if init_state is not None
         else torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device))
    h_in = []
    for n in range(nc):  # state entering each chunk
        h_in.append(h)
        h = h * torch.exp(a_total[:, n])[:, :, None, None] + chunk_state[:, n]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,P,N)
    y_inter = torch.einsum("bnch,bnchk,bnhpk->bnchp", torch.exp(a_cum), Ch, h_in)
    y = (y_intra + y_inter).reshape(Bz, S, H, P)
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    y = y.to(x.dtype)
    return (y, h) if return_state else y
