"""Plain PyTorch oracles (the port of `repro.kernels.ref`: attention, the
Mamba2 SSD scan and the mLSTM cell).

Written naively (full materialisation, or one step at a time) for
auditability.  The attention references are the plain versions the CUDA
attention kernels are held against on the card and the path their
wrappers take for a CPU tensor; the SSD references are the oracles of the
chunked plain scan in `mamba2_ssd.py`; `mlstm_reference` is the plain
mLSTM for short sequences (`mlstm.mlstm_plain`), `mlstm_recurrent_step`
the oracle of the in-place decode step and, through
`mlstm_prefill_replay`, of the closed-form prefill state.

All arithmetic is fp32 whatever the input dtypes; the output takes the
input's dtype (q, x), as the kernels' does.  Where every position of an
attention row is masked the result is 0 (the kernels divide by
``max(l, 1e-30)``), not the NaN of a plain softmax; no caller produces
such a row.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell)
# ---------------------------------------------------------------------------

def mlstm_reference(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,  # (B, S, H, D)
    i_gate: torch.Tensor,  # (B, S, H) input-gate preactivation
    f_gate: torch.Tensor,  # (B, S, H) forget-gate preactivation
) -> torch.Tensor:
    """Stabilized parallel mLSTM (xLSTM eq. 19-27), fully materialised:
        D_ts = F_t - F_s + i_s for s <= t, F = cumsum(log sigmoid f)
        m_t  = max_s D_ts
        out  = (q k^T / sqrt(d) * exp(D - m)) v / max(|row sum|, exp(-m_t))
    """
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    F = torch.cumsum(torch.nn.functional.logsigmoid(f_gate.float()), dim=1)  # (B,S,H)
    S = q.shape[1]
    dmat = F[:, :, None, :] - F[:, None, :, :] + i_gate.float()[:, None, :, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    dmat = dmat.masked_fill(~tri[None, :, :, None], float("-inf"))
    m = dmat.amax(dim=2, keepdim=True)  # (B,S,1,H) row max
    dprime = torch.exp(dmat - m)
    scores = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) * scale
    weights = scores * dprime
    denom = torch.maximum(weights.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    out = torch.einsum("btsh,bshd->bthd", weights / denom, v.float())
    return out.to(q.dtype)


def mlstm_recurrent_step(
    c: torch.Tensor,  # (B, H, D, D) matrix memory
    n: torch.Tensor,  # (B, H, D) normalizer
    m: torch.Tensor,  # (B, H) stabilizer
    q_t: torch.Tensor,  # (B, H, D)
    k_t: torch.Tensor,
    v_t: torch.Tensor,
    i_t: torch.Tensor,  # (B, H)
    f_t: torch.Tensor,  # (B, H)
) -> Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """One recurrent mLSTM step with full-size temporaries (the JAX
    package's formula, term for term); returns ((c, n, m), h in q's dtype).
    The state is not modified."""
    scale = 1.0 / math.sqrt(q_t.shape[-1])
    logf = torch.nn.functional.logsigmoid(f_t.float())
    i_t = i_t.float()
    m_new = torch.maximum(logf + m, i_t)
    fgate = torch.exp(logf + m - m_new)
    igate = torch.exp(i_t - m_new)
    kf, vf, qs = k_t.float(), v_t.float(), q_t.float() * scale
    c_new = fgate[..., None, None] * c + igate[..., None, None] * (vf[..., :, None] * kf[..., None, :])
    n_new = fgate[..., None] * n + igate[..., None] * kf
    h_num = torch.einsum("bhvk,bhk->bhv", c_new, qs)
    h_den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qs).abs(), torch.exp(-m_new))
    return (c_new, n_new, m_new), (h_num / h_den[..., None]).to(q_t.dtype)


def mlstm_prefill_replay(
    c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,  # (B, S, H, D)
    i_gate: torch.Tensor, f_gate: torch.Tensor,  # (B, S, H)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The final (c, n, m) after a prompt, one recurrent step per token:
    what the JAX mLSTM block's prefill computes (`repro/models/xlstm.py`,
    the scan over `mlstm_decode_step`).  The oracle of the closed form in
    `models/xlstm.py`; S sequential steps, so tests only."""
    for t in range(q.shape[1]):
        (c, n, m), _ = mlstm_recurrent_step(
            c, n, m, q[:, t], k[:, t], v[:, t], i_gate[:, t], f_gate[:, t]
        )
    return c, n, m


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory recurrent cell with exponential gating)
# ---------------------------------------------------------------------------

def slstm_reference(
    x: torch.Tensor,  # (B, S, H, D) pre-projected inputs (per gate computed outside)
    gates_x: torch.Tensor,  # (B, S, H, D, 4) input contributions to i, f, z, o
    r_kernel: torch.Tensor,  # (H, D, D, 4) block-diagonal recurrent weights
    init: Optional[Tuple[torch.Tensor, ...]] = None,
) -> torch.Tensor:
    """sLSTM with exponential input gate, sigmoid/exp forget gate and
    stabilizer state (xLSTM eq. 7-18): (B, S, H, D) hidden states in x's
    dtype.  Strictly sequential, one step per token, in fp32; ``init`` is
    the (c, n, m, h) carry, each (B, H, D)."""
    B, S, H, D = x.shape
    zeros = torch.zeros((B, H, D), dtype=torch.float32, device=x.device)
    c, n, m, h = init if init is not None else (zeros, zeros, zeros - 1e9, zeros)
    gx = gates_x.float()
    r = r_kernel.float()
    hs = []
    for t in range(S):
        pre = gx[:, t] + torch.einsum("bhd,hdke->bhke", h, r)
        i_t, f_t = pre[..., 0], pre[..., 1]
        z_t = torch.tanh(pre[..., 2])
        o_t = torch.sigmoid(pre[..., 3])
        logf = torch.nn.functional.logsigmoid(f_t)
        m_new = torch.maximum(logf + m, i_t)
        igate = torch.exp(i_t - m_new)
        fgate = torch.exp(logf + m - m_new)
        c = fgate * c + igate * z_t
        n = fgate * n + igate
        m = m_new
        h = o_t * c / torch.clamp_min(n, 1.0)
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)
