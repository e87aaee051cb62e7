"""Dispatch layer: models call these.

The rule is by the tensor's device, with no fallback: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(or the call raises).  Each kernel name here is the kernel module's
wrapper, which makes that choice itself; tests that want the plain version
on any device call ``ref`` (or the kernel modules' ``*_plain``) directly.
``ssd_decode_step`` and ``mlstm_decode_step`` are plain PyTorch on every
device: the JAX package has no kernel for them either.

Not ported yet: the chunked online-softmax path for Dv != D (MLA; see
ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .mamba2_ssd import ssd as ssd_scan
from .mlstm import mlstm as mlstm_parallel

__all__ = [
    "decode_attention", "flash_attention", "mlstm_decode_step", "mlstm_parallel",
    "ssd_decode_step", "ssd_scan",
]


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N) fp32
    x_t: torch.Tensor,  # (B, H, P)
    dt_t: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    B_t: torch.Tensor,  # (B, G, N)
    C_t: torch.Tensor,  # (B, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step -> (new fp32 state, y (B, H, P) in x's dtype)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.float().repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(A.float()[None, :] * dt_t.float())  # (B,H)
    state = state * decay[..., None, None] + (
        (dt_t.float()[..., None] * x_t.float())[..., None] * Bh[:, :, None, :]
    )
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    if D is not None:
        y = y + x_t.float() * D.float()[None, :, None]
    return state, y.to(x_t.dtype)


def mlstm_decode_step(
    c: torch.Tensor,  # (B, H, D, D) fp32 matrix memory, contiguous
    n: torch.Tensor,  # (B, H, D) fp32 normalizer
    m: torch.Tensor,  # (B, H) fp32 stabilizer
    q_t: torch.Tensor,  # (B, H, D)
    k_t: torch.Tensor,
    v_t: torch.Tensor,
    i_t: torch.Tensor,  # (B, H)
    f_t: torch.Tensor,  # (B, H)
) -> torch.Tensor:
    """O(1) recurrent mLSTM step; updates (c, n, m) in place and returns h
    (B, H, D) in q's dtype.  ``ref.mlstm_recurrent_step`` is the same step
    with full-size temporaries; here c is scaled in place and takes one
    rank-1 update, (i v) k^T, so a step moves c through memory three times
    (scale, update, the read for h) and allocates nothing of its size."""
    B, H, D = q_t.shape
    logf = F.logsigmoid(f_t.float())
    i_t = i_t.float()
    m_new = torch.maximum(logf + m, i_t)
    fgate = torch.exp(logf + m - m_new)
    igate = torch.exp(i_t - m_new)
    kf = k_t.float()
    qs = q_t.float() * (1.0 / math.sqrt(D))
    c.mul_(fgate[..., None, None])
    cb = c.view(B * H, D, D)
    cb.baddbmm_((v_t.float() * igate[..., None]).reshape(B * H, D, 1), kf.reshape(B * H, 1, D))
    n.mul_(fgate[..., None]).add_(igate[..., None] * kf)
    m.copy_(m_new)
    h_num = torch.bmm(cb, qs.reshape(B * H, D, 1)).view(B, H, D)
    h_den = torch.maximum((n * qs).sum(dim=-1).abs(), torch.exp(-m_new))
    return (h_num / h_den[..., None]).to(q_t.dtype)
