"""GQA/MHA attention block: no cache (full), prefill (cache fill) and decode
(one token), and cross-attention over precomputed encoder K/V (whisper)
-- port of `repro.models.attention`.

KV-cache layout per layer: {"k": (B, Smax, K, hd), "v": (B, Smax, K, hd)};
`cache_len` is a scalar (aligned batched serving) or a per-row (B,) int
tensor (continuous batching: every slot decodes at its own position).  The
cache is updated in place.

Under a mesh (`sharding.use_mesh`) q and the output take the JAX package's
constraints (batch over dp, heads over tp), and the new K/V rows take the
cache's layout (`cache_logical_spec`) before they are written into it; with
no mesh each constraint returns its input.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

from .cache_update import write_row, write_segment
from .layers import Params, apply_rope, dense_init, rmsnorm, rmsnorm_init
from .sharding import DP, TP, axis_size, current_mesh, describe, physical_axes, reshape, shard


def attn_init(gen, cfg: ModelConfig, *, q_in_dim: Optional[int] = None,
              kv_in_dim: Optional[int] = None, dtype=torch.float32, device="cpu") -> Params:
    """q/k/v project from ``q_in_dim``/``kv_in_dim`` (d_model by default;
    the hybrid's shared block projects from 2 d_model)."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "wq": dense_init(gen, q_in_dim or D, H, hd, **kw),
        "wk": dense_init(gen, kv_in_dim or D, K, hd, **kw),
        "wv": dense_init(gen, kv_in_dim or D, K, hd, **kw),
        "wo": dense_init(gen, H, hd, D, **kw),
    }
    if cfg.attn_bias:
        p["wq_b"] = torch.zeros((H, hd), **kw)
        p["wk_b"] = torch.zeros((K, hd), **kw)
        p["wv_b"] = torch.zeros((K, hd), **kw)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, **kw)
        p["k_norm"] = rmsnorm_init(hd, **kw)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cpu") -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _dp_size() -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    return axis_size(mesh, physical_axes(mesh, DP))


def _tp_size() -> int:
    mesh = current_mesh()
    if mesh is None or "model" not in describe(mesh).axis_names:
        return 0
    return describe(mesh).shape["model"]


def cache_logical_spec(cfg: ModelConfig, tp_size: int, batch: int) -> Tuple:
    """(B, S, K, hd) logical axes for the KV cache.  Must agree with
    launch/shardings.py:cache_pspec."""
    dp_n = _dp_size()
    heads_ok = tp_size and cfg.n_kv_heads % tp_size == 0
    if batch % max(dp_n, 1) == 0 and batch >= dp_n:
        return (DP, None, TP, None) if heads_ok else (DP, TP, None, None)
    # tiny batch (long-context decode): shard the sequence dim
    return (None, DP, TP, None) if heads_ok else (None, (DP, TP), None, None)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product; under a mesh the
    heads are split off the product only where the mesh dim sharding them
    divides them (`sharding.reshape`)."""
    B, S, _ = x.shape
    return reshape(x @ w.reshape(w.shape[0], -1), (B, S, w.shape[1], w.shape[2]))


def _project_qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.attn_bias:
        q = q + p["wq_b"]
        k = k + p["wk_b"]
        v = v + p["wv_b"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], eps=cfg.rms_eps)
        k = rmsnorm(k, p["k_norm"], eps=cfg.rms_eps)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    B, S = out.shape[:2]
    return out.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


def decode_lengths(cache_len, batch: int, device) -> torch.Tensor:
    """The (B,) int32 lengths a decode step attends over, ``cache_len + 1``
    (the new row included), as the decode kernel takes them.  A decode step
    builds this once and hands it to every layer."""
    clen = torch.as_tensor(cache_len, device=device).to(torch.int32)
    return (clen.reshape(-1).expand(batch) + 1).contiguous()


def attn_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,  # (S,) or per-row (B, S)
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_len=None,  # int, 0-d tensor, or per-row (B,) int tensor
    attend_len: Optional[torch.Tensor] = None,  # decode: decode_lengths(cache_len, ...)
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # encoder k, v
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, cache), the cache updated in place.  With ``cross_kv``
    only q is projected (no qk-norm, RoPE or softcap, as in JAX) and it
    attends over the given encoder K/V, non-causally; no cache is touched."""
    B, S, _ = x.shape
    scale = cfg.attn_scale if cfg.attn_scale is not None else 1.0 / math.sqrt(cfg.hd)

    if cross_kv is not None:
        q = _proj(x, p["wq"])
        if cfg.attn_bias:
            q = q + p["wq_b"]
        k, v = cross_kv
        out = ops.flash_attention(q, k, v, causal=False, scale=scale)
        out = shard(out, DP, None, TP, None)
        return _out_proj(out, p["wo"]), None

    q, k, v = _project_qkv(p, x, cfg)
    if use_rope and cfg.pos_embedding == "rope":
        if positions is None:
            positions = torch.arange(S, device=x.device)
        pos_b = positions if positions.dim() == 2 else positions[None, :]
        q = apply_rope(q, pos_b, cfg.rope_theta)
        k = apply_rope(k, pos_b, cfg.rope_theta)
    q = shard(q, DP, None, TP, None)

    if cache is None:
        out = ops.flash_attention(
            q, k, v, causal=causal, window=window, logit_cap=cfg.attn_softcap, scale=scale
        )
        out = shard(out, DP, None, TP, None)
        return _out_proj(out, p["wo"]), None

    spec = cache_logical_spec(cfg, _tp_size(), B)
    if S > 1:
        # lay fresh k/v out like the cache before the update
        k = shard(k, *spec)
        v = shard(v, *spec)
    if S == 1:
        # decode: write the new row first, then attend over len + 1
        write_row(cache["k"], k, cache_len)
        write_row(cache["v"], v, cache_len)
        if attend_len is None:
            attend_len = decode_lengths(cache_len, B, x.device)
        out = ops.decode_attention(
            q[:, 0], cache["k"], cache["v"], attend_len,
            logit_cap=cfg.attn_softcap, window=window, scale=scale,
        )[:, None]
    else:
        # prefill: write the whole segment, attend causally within it
        write_segment(cache["k"], k, int(cache_len))
        write_segment(cache["v"], v, int(cache_len))
        out = ops.flash_attention(
            q, k, v, causal=causal, window=window, logit_cap=cfg.attn_softcap,
            q_offset=0, scale=scale,
        )
    out = shard(out, DP, None, TP, None)
    return _out_proj(out, p["wo"]), cache


def cross_kv_init(p: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder K/V a decoder layer's cross-attention reads, each (B,
    S_enc, K, hd) in the encoder output's dtype."""
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if cfg.attn_bias:
        k = k + p["wk_b"]
        v = v + p["wv_b"]
    return k, v
