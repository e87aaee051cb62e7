"""Dispatch layer: models call these.

The rule is by the tensor's device, with no fallback: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(or the call raises).  Each kernel name here is the kernel module's
wrapper, which makes that choice itself; tests that want the plain version
on any device call ``ref`` (or the kernel modules' ``*_plain``) directly.
``ssd_decode_step`` is plain PyTorch on every device: the JAX package has
no kernel for it either.

Not ported yet: the chunked online-softmax path for Dv != D (MLA) and the
mLSTM cell (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .mamba2_ssd import ssd as ssd_scan

__all__ = ["decode_attention", "flash_attention", "ssd_decode_step", "ssd_scan"]


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
