"""Multi-head Latent Attention, DeepSeek-V2/V3 (port of `repro.models.mla`).

The KV state is a per-token latent c_kv (rank 512) and one decoupled-RoPE
key k_pe (64) shared by all heads.  Two forms:

  * forward / prefill: up-project the latent to per-head K (nope | rope,
    192) and V (128) and attend causally.  Dv != Dqk, so `ops` sends it
    to plain PyTorch by shape, as the JAX dispatch sends it to its jnp
    paths (no kernel of the port takes it);
  * decode: weight absorption -- q_lat = q_nope W_UK, scores = q_lat c_kv
    + q_rope k_pe against the latent cache, the context accumulated in
    latent space and up-projected once with W_UV.  Plain fp32 einsums on
    every device, as in the JAX package.

Cache per layer: {"c_kv": (B, S, kv_lora_rank), "k_pe": (B, S,
rope_head_dim)}, updated in place.  Under a mesh the latent cache is
sequence-sharded (`mla_cache_spec`); the new rows are written in the
cache's layout (`cache_update`), and q, k, v, the output and the absorbed
query take the JAX package's constraints.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

from .attention import _out_proj, _proj
from .cache_update import write_row, write_segment
from .sharding import DP, TP, shard
from .layers import Params, apply_rope, dense_init, rmsnorm, rmsnorm_init


def mla_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "q_down": dense_init(gen, D, m.q_lora_rank, **kw),
        "q_norm": rmsnorm_init(m.q_lora_rank, **kw),
        "q_up": dense_init(gen, m.q_lora_rank, H, m.nope_head_dim + m.rope_head_dim, **kw),
        "kv_down": dense_init(gen, D, m.kv_lora_rank + m.rope_head_dim, **kw),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, **kw),
        "kv_up": dense_init(gen, m.kv_lora_rank, H, m.nope_head_dim + m.v_head_dim, **kw),
        "wo": dense_init(gen, H, m.v_head_dim, D, **kw),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cpu") -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        "k_pe": torch.zeros((batch, max_len, m.rope_head_dim), dtype=dtype, device=device),
    }


def _positions(positions: torch.Tensor) -> torch.Tensor:
    return positions if positions.dim() == 2 else positions[None, :]


def mla_cache_spec() -> Tuple:
    return (DP, TP, None)  # sequence-sharded latent


def _q_heads(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """-> (q_nope (B, S, H, nope), q_pe (B, S, H, rope))."""
    m = cfg.mla
    q = _proj(rmsnorm(x @ p["q_down"], p["q_norm"], eps=cfg.rms_eps), p["q_up"])
    q_pe = apply_rope(q[..., m.nope_head_dim:], _positions(positions), cfg.rope_theta)
    return q[..., : m.nope_head_dim], q_pe


def _latent(p: Params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """-> (c_kv (B, S, r), k_pe (B, S, rope))."""
    m = cfg.mla
    kv = x @ p["kv_down"]  # (B, S, r + rope)
    c_kv = rmsnorm(kv[..., : m.kv_lora_rank], p["kv_norm"], eps=cfg.rms_eps)
    k_pe = apply_rope(kv[..., m.kv_lora_rank:][:, :, None, :], _positions(positions),
                      cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,  # (S,) or per-row (B, S)
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_len=None,  # int, 0-d tensor, or per-row (B,) int tensor
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, cache), the cache updated in place."""
    B, S, _ = x.shape
    m = cfg.mla
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q_nope, q_pe = _q_heads(p, x, cfg, positions)
    c_kv, k_pe = _latent(p, x, cfg, positions)

    if cache is not None and S == 1:
        # absorbed decode: write the new row, attend over positions <= cache_len
        write_row(cache["c_kv"], c_kv, cache_len)
        write_row(cache["k_pe"], k_pe, cache_len)
        ckv, kpe = cache["c_kv"].float(), cache["k_pe"].float()
        kv_up_k = p["kv_up"][..., : m.nope_head_dim]  # (r, H, nope)
        kv_up_v = p["kv_up"][..., m.nope_head_dim:]  # (r, H, v)
        q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0], kv_up_k)  # activations' dtype
        q_lat = shard(q_lat, DP, TP, None)
        s_lat = torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
        s_pe = torch.einsum("bhk,bsk->bhs", q_pe[:, 0].float(), kpe)
        scores = (s_lat + s_pe) * scale  # (B, H, S) fp32
        pos = torch.arange(ckv.shape[1], device=x.device)[None, None, :]
        clen = torch.as_tensor(cache_len, device=x.device)
        if clen.dim() == 1:
            clen = clen[:, None, None]  # per-slot lengths (continuous batching)
        probs = torch.softmax(torch.where(pos <= clen, scores, -1e30), dim=-1)
        ctx_lat = torch.einsum("bhs,bsr->bhr", probs, ckv)
        ctx = torch.einsum("bhr,rhv->bhv", ctx_lat, kv_up_v.float())
        out = torch.einsum("bhv,hvd->bd", ctx.to(x.dtype), p["wo"])[:, None]
        return out, cache

    # forward / prefill: materialise per-head K (nope | rope) and V
    kv = _proj(c_kv, p["kv_up"])  # (B, S, H, nope + v)
    k_nope, v = kv[..., : m.nope_head_dim], kv[..., m.nope_head_dim:]
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(*k_nope.shape[:3], m.rope_head_dim)], -1)
    q = shard(torch.cat([q_nope, q_pe], dim=-1), DP, None, TP, None)
    k = shard(k, DP, None, TP, None)
    v = shard(v, DP, None, TP, None)
    out = shard(ops.flash_attention(q, k, v, causal=True, scale=scale), DP, None, TP, None)
    y = _out_proj(out, p["wo"])
    if cache is not None:
        write_segment(cache["c_kv"], c_kv, int(cache_len))
        write_segment(cache["k_pe"], k_pe, int(cache_len))
    return y, cache
