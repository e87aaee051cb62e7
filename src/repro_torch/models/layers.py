"""Common layers, as plain functions on tensors (port of
`repro.models.layers`).

Parameters are nested dicts of tensors with the JAX package's layouts
(`w_gate (D, F)`, `wq (D, H, hd)`), so converted JAX weights load one to one.
Initialisers draw from an explicit `torch.Generator` with the same
distributions as the JAX initialisers (not the same numbers).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .sharding import reshape

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _normal(shape, std: float, gen: torch.Generator, dtype, device) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=device)
    out.normal_(0.0, std, generator=gen)
    return out.to(dtype)


def dense_init(gen, in_dim: int, *out_dims: int, dtype=torch.float32, device="cpu",
               scale: Optional[float] = None) -> torch.Tensor:
    std = scale if scale is not None else (2.0 / (in_dim + math.prod(out_dims))) ** 0.5
    return _normal((in_dim, *out_dims), std, gen, dtype, device)


def embed_init(gen, vocab: int, dim: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return _normal((vocab, dim), dim**-0.5, gen, dtype, device)


def rmsnorm_init(dim: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.zeros((dim,), dtype=dtype, device=device)  # offset-from-1


# ---------------------------------------------------------------------------
# RMSNorm / RoPE / MLP
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6, offset: bool = True) -> torch.Tensor:
    xf = x.float()
    xn = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.float()) if offset else w.float()
    return (xn * scale).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of x (..., S, H, D); pairs split as
    [0:D/2], [D/2:D].  ``positions`` broadcasts to (..., S): one shared row
    (1, S) or per-row (B, S)."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., : D // 2].float(), x[..., D // 2 :].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_init(gen, d_model: int, d_ff: int, dtype=torch.float32, device="cpu") -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "w_up": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def mlp_apply(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = x @ p["w_gate"]
    gate = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (gate * (x @ p["w_up"])) @ p["w_down"]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None or cap <= 0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def causal_conv1d(
    x: torch.Tensor,  # (B, S, C)
    kernel: torch.Tensor,  # (K, C) depthwise
    bias: Optional[torch.Tensor] = None,
    state: Optional[torch.Tensor] = None,  # (B, K-1, C) left context (decode)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv; returns (y, new_state).  The state may be kept
    in another dtype (an fp32 cache under bf16 compute): it is cast to x's
    dtype first, so the concat never promotes the activations, and the new
    state comes back in x's dtype (the values a cache then stores)."""
    K = kernel.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, C)
    S = x.shape[1]
    y = sum(xp[:, i : i + S, :] * kernel[i][None, None, :] for i in range(K))
    if bias is not None:
        y = y + bias[None, None, :]
    new_state = xp[:, -(K - 1) :, :] if K > 1 else torch.zeros_like(state)
    return y, new_state


def grouped_rmsnorm(x: torch.Tensor, w: torch.Tensor, n_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """Per-group RMS norm over the channel dim (the Mamba2 gated norm)."""
    B, S, C = x.shape
    xg = reshape(x, (B, S, n_groups, C // n_groups)).float()
    var = (xg * xg).mean(dim=-1, keepdim=True)
    xn = reshape(xg * torch.rsqrt(var + eps), (B, S, C))
    return (xn * (1.0 + w.float())).to(x.dtype)
