"""Dense decoder stage (port of the dense half of
`repro.models.transformer`).

The JAX package stacks layer parameters as (outer, period, ...) and scans
over them; eagerly, the port keeps a plain list of per-layer dicts in
layer order (layer ``o * period + i``) and loops.  The local/global window
period (gemma2: [local, global]) and sandwich norms carry over.  MoE, MLA,
Mamba2, xLSTM and enc-dec stages come with later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

from . import attention as attn
from .layers import Params, mlp_apply, mlp_init, rmsnorm, rmsnorm_init


def layer_period(cfg: ModelConfig) -> int:
    return cfg.global_every if (cfg.sliding_window and cfg.global_every) else 1


def layer_window(cfg: ModelConfig, layer: int) -> Optional[int]:
    """Sliding window of decoder layer ``layer`` (None = global)."""
    period = layer_period(cfg)
    if cfg.sliding_window and (period == 1 or layer % period < period - 1):
        return cfg.sliding_window
    return None


def decoder_layer_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    kw = dict(dtype=dtype, device=device)
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, **kw), "ln2": rmsnorm_init(cfg.d_model, **kw)}
    if cfg.sandwich_norm:
        p["ln1_post"] = rmsnorm_init(cfg.d_model, **kw)
        p["ln2_post"] = rmsnorm_init(cfg.d_model, **kw)
    p["attn"] = attn.attn_init(gen, cfg, **kw)
    p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, **kw)
    return p


def decoder_layer_apply(
    p: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    window: Optional[int],
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]],
    cache_len,
    attend_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    x = rmsnorm(h, p["ln1"], eps=cfg.rms_eps)
    a_out, new_cache = attn.attn_apply(
        p["attn"], x, cfg, window=window, positions=positions, cache=cache,
        cache_len=cache_len, attend_len=attend_len,
    )
    if cfg.sandwich_norm:
        a_out = rmsnorm(a_out, p["ln1_post"], eps=cfg.rms_eps)
    h = h + a_out
    x = rmsnorm(h, p["ln2"], eps=cfg.rms_eps)
    m_out = mlp_apply(p["mlp"], x, cfg.act)
    if cfg.sandwich_norm:
        m_out = rmsnorm(m_out, p["ln2_post"], eps=cfg.rms_eps)
    return h + m_out, new_cache


def decoder_stage_init(gen, cfg: ModelConfig, n_layers: int, *, dtype=torch.float32,
                       device="cpu") -> List[Params]:
    if n_layers % layer_period(cfg):
        raise ValueError(f"{n_layers} layers not a multiple of period {layer_period(cfg)}")
    return [decoder_layer_init(gen, cfg, dtype=dtype, device=device) for _ in range(n_layers)]


def decoder_stage_apply(
    layers: List[Params],
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[List[Dict[str, torch.Tensor]]] = None,
    cache_len=None,
    attend_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
    for i, lp in enumerate(layers):
        h, _ = decoder_layer_apply(
            lp, h, cfg,
            window=layer_window(cfg, i), positions=positions,
            cache=None if cache is None else cache[i], cache_len=cache_len,
            attend_len=attend_len,
        )
    return h, cache
