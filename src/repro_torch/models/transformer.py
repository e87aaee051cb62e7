"""Decoder stages: dense, MoE (with MLA where the config has it), the
zamba2 hybrid, xLSTM, and whisper's encoder and cross-attending decoder
(port of `repro.models.transformer`).

The JAX package stacks layer parameters as (outer, period, ...) and scans
over them; eagerly, the port keeps a plain list of per-layer dicts in
layer order (layer ``o * period + i``) and loops.  The local/global window
period (gemma2: [local, global]) and sandwich norms carry over.  The hybrid
stage is {"super": [[Mamba2 layer] * shared_attn_every] * n_super, "shared":
one attention block reused after every super block, "tail": [Mamba2
layer] * n_tail}.  The xLSTM stage is [{"m": [mLSTM block] * (slstm_every
- 1), "s": sLSTM block}] * n_groups.  A decoder layer attends with MLA
when ``cfg.mla`` is set and runs the MoE layer in place of its MLP when
``use_moe``; the decoder stage returns the layers' summed MoE aux loss.
The JAX package stacks whisper's encoder and cross-attending decoder on
one leading axis (L, ...); the port keeps a list of per-layer dicts for
them too.

``remat`` (no-cache forward only) wraps each layer or block in
``torch.utils.checkpoint`` (non-reentrant): the backward pass recomputes
it from its input, which is all that is saved -- the JAX package's default
policy ``nothing`` (``REPRO_REMAT_POLICY``), applied per layer where JAX
applies it per scanned period.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

from . import attention as attn
from . import mamba2 as mb
from . import mla as mla_mod
from . import moe as moe_mod
from . import xlstm as xl
from .layers import Params, _normal, mlp_apply, mlp_init, rmsnorm, rmsnorm_init
from .sharding import residual_shard, sublayer_input


def _call(fn, remat: bool, *args, **kw):
    """``fn(*args, **kw)``; under ``remat`` recomputed in the backward pass
    from its inputs instead of saving its activations."""
    if not remat:
        return fn(*args, **kw)
    return checkpoint(fn, *args, use_reentrant=False, **kw)


def layer_period(cfg: ModelConfig) -> int:
    return cfg.global_every if (cfg.sliding_window and cfg.global_every) else 1


def layer_window(cfg: ModelConfig, layer: int) -> Optional[int]:
    """Sliding window of decoder layer ``layer`` (None = global)."""
    period = layer_period(cfg)
    if cfg.sliding_window and (period == 1 or layer % period < period - 1):
        return cfg.sliding_window
    return None


def decoder_layer_init(gen, cfg: ModelConfig, *, use_moe: bool = False, dtype=torch.float32,
                       device="cpu") -> Params:
    kw = dict(dtype=dtype, device=device)
    p: Params = {"ln1": rmsnorm_init(cfg.d_model, **kw), "ln2": rmsnorm_init(cfg.d_model, **kw)}
    if cfg.sandwich_norm:
        p["ln1_post"] = rmsnorm_init(cfg.d_model, **kw)
        p["ln2_post"] = rmsnorm_init(cfg.d_model, **kw)
    if cfg.mla is not None:
        p["attn"] = mla_mod.mla_init(gen, cfg, **kw)
    else:
        p["attn"] = attn.attn_init(gen, cfg, **kw)
    if use_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, **kw)
    else:
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
    use_moe: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict], Optional[torch.Tensor]]:
    """-> (h, cache, MoE aux loss or None for an MLP layer)."""
    h = residual_shard(h)
    x = sublayer_input(rmsnorm(h, p["ln1"], eps=cfg.rms_eps))
    if cfg.mla is not None:
        a_out, new_cache = mla_mod.mla_apply(
            p["attn"], x, cfg, positions=positions, cache=cache, cache_len=cache_len,
        )
    else:
        a_out, new_cache = attn.attn_apply(
            p["attn"], x, cfg, window=window, positions=positions, cache=cache,
            cache_len=cache_len, attend_len=attend_len,
        )
    a_out = residual_shard(a_out)
    if cfg.sandwich_norm:
        a_out = rmsnorm(a_out, p["ln1_post"], eps=cfg.rms_eps)
    h = h + a_out
    x = sublayer_input(rmsnorm(h, p["ln2"], eps=cfg.rms_eps))
    aux = None
    if use_moe:
        m_out, aux = moe_mod.moe_apply(p["moe"], x, cfg)
    else:
        m_out = mlp_apply(p["mlp"], x, cfg.act)
    m_out = residual_shard(m_out)
    if cfg.sandwich_norm:
        m_out = rmsnorm(m_out, p["ln2_post"], eps=cfg.rms_eps)
    return h + m_out, new_cache, aux


def decoder_stage_init(gen, cfg: ModelConfig, n_layers: int, *, use_moe: bool = False,
                       dtype=torch.float32, device="cpu") -> List[Params]:
    if n_layers % layer_period(cfg):
        raise ValueError(f"{n_layers} layers not a multiple of period {layer_period(cfg)}")
    return [decoder_layer_init(gen, cfg, use_moe=use_moe, dtype=dtype, device=device)
            for _ in range(n_layers)]


def decoder_stage_apply(
    layers: List[Params],
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[List[Dict[str, torch.Tensor]]] = None,
    cache_len=None,
    attend_len: Optional[torch.Tensor] = None,
    use_moe: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Dict]], torch.Tensor]:
    """-> (h, cache, the layers' summed MoE aux loss, fp32 0 without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, lp in enumerate(layers):
        h, _, a = _call(
            decoder_layer_apply, remat and cache is None, lp, h, cfg,
            window=layer_window(cfg, i), positions=positions,
            cache=None if cache is None else cache[i], cache_len=cache_len,
            attend_len=attend_len, use_moe=use_moe,
        )
        if a is not None:
            aux = aux + a
    return h, cache, aux


# ---------------------------------------------------------------------------
# encoder stage (whisper): full attention, no cache
# ---------------------------------------------------------------------------

def encoder_layer_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "ln1": rmsnorm_init(cfg.d_model, **kw),
        "ln2": rmsnorm_init(cfg.d_model, **kw),
        "attn": attn.attn_init(gen, cfg, **kw),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def encoder_stage_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> List[Params]:
    return [encoder_layer_init(gen, cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_encoder_layers)]


def encoder_layer_apply(lp: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = sublayer_input(rmsnorm(h, lp["ln1"], eps=cfg.rms_eps))
    a, _ = attn.attn_apply(lp["attn"], x, cfg, causal=False, use_rope=False)
    h = h + residual_shard(a)
    x = sublayer_input(rmsnorm(h, lp["ln2"], eps=cfg.rms_eps))
    return h + residual_shard(mlp_apply(lp["mlp"], x, cfg.act))


def encoder_stage_apply(layers: List[Params], h: torch.Tensor, cfg: ModelConfig, *,
                        remat: bool = False) -> torch.Tensor:
    for lp in layers:
        h = _call(encoder_layer_apply, remat, lp, h, cfg)
    return h


# ---------------------------------------------------------------------------
# cross-decoder stage (whisper decoder: self + cross + mlp)
# ---------------------------------------------------------------------------

def xdecoder_layer_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    kw = dict(dtype=dtype, device=device)
    return {
        "ln1": rmsnorm_init(cfg.d_model, **kw),
        "ln_x": rmsnorm_init(cfg.d_model, **kw),
        "ln2": rmsnorm_init(cfg.d_model, **kw),
        "self_attn": attn.attn_init(gen, cfg, **kw),
        "cross_attn": attn.attn_init(gen, cfg, **kw),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, **kw),
    }


def xdecoder_stage_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> List[Params]:
    return [xdecoder_layer_init(gen, cfg, dtype=dtype, device=device)
            for _ in range(cfg.n_layers)]


def xdecoder_layer_apply(
    lp: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    c: Optional[Dict],
    enc_out: Optional[torch.Tensor],
    *,
    positions: torch.Tensor,
    cache_len=None,
    attend_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention, cross-attention over the encoder output (or the
    layer cache ``c``'s "cross" K/V), MLP."""
    x = sublayer_input(rmsnorm(h, lp["ln1"], eps=cfg.rms_eps))
    a, _ = attn.attn_apply(
        lp["self_attn"], x, cfg, positions=positions,
        cache=None if c is None else c["self"], cache_len=cache_len,
        attend_len=attend_len, use_rope=False,
    )
    h = h + residual_shard(a)
    x = sublayer_input(rmsnorm(h, lp["ln_x"], eps=cfg.rms_eps))
    if c is not None and "cross" in c:
        ck, cv = c["cross"]["k"], c["cross"]["v"]
    else:
        ck, cv = attn.cross_kv_init(lp["cross_attn"], enc_out, cfg)
        if c is not None:
            c["cross"] = {"k": ck, "v": cv}
    a, _ = attn.attn_apply(lp["cross_attn"], x, cfg, cross_kv=(ck, cv))
    h = h + residual_shard(a)
    x = sublayer_input(rmsnorm(h, lp["ln2"], eps=cfg.rms_eps))
    return h + residual_shard(mlp_apply(lp["mlp"], x, cfg.act))


def xdecoder_stage_apply(
    layers: List[Params],
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    enc_out: Optional[torch.Tensor] = None,  # (B, S_enc, D), or None once cached
    positions: torch.Tensor,
    cache: Optional[List[Dict]] = None,
    cache_len=None,
    attend_len: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
    """Cache: [{"self": kv, "cross": {"k", "v"}}] per layer, updated in
    place.  A layer whose cache has no "cross" entry (a fresh cache, as
    `init_cache` makes it) projects the encoder output and stores the
    result there, in the activations' dtype; later calls read it."""
    for i, lp in enumerate(layers):
        h = _call(
            xdecoder_layer_apply, remat and cache is None, lp, h, cfg,
            None if cache is None else cache[i], enc_out,
            positions=positions, cache_len=cache_len, attend_len=attend_len,
        )
    return h, cache


# ---------------------------------------------------------------------------
# hybrid stage (zamba2): Mamba2 super blocks + one shared attention block
# ---------------------------------------------------------------------------

def shared_attn_block_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    D, F = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    return {
        "ln": rmsnorm_init(2 * D, **kw),
        "attn": attn.attn_init(gen, cfg, q_in_dim=2 * D, kv_in_dim=2 * D, **kw),
        "ln2": rmsnorm_init(2 * D, **kw),
        "mlp": {
            "w_gate": _normal((2 * D, F), (2 * D) ** -0.5, gen, dtype, device),
            "w_up": _normal((2 * D, F), (2 * D) ** -0.5, gen, dtype, device),
            "w_down": _normal((F, D), F**-0.5, gen, dtype, device),
        },
    }


def shared_attn_block_apply(
    p: Params,
    h: torch.Tensor,
    h0: torch.Tensor,  # the stage's input embeddings (zamba's concat)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_len=None,
    attend_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention and MLP over [h | h0], both normed from the same concat."""
    xcat = torch.cat([h, h0], dim=-1)  # (B, S, 2D)
    a, _ = attn.attn_apply(
        p["attn"], sublayer_input(rmsnorm(xcat, p["ln"], eps=cfg.rms_eps)), cfg,
        positions=positions, cache=cache, cache_len=cache_len, attend_len=attend_len,
    )
    h = h + residual_shard(a)
    x = sublayer_input(rmsnorm(xcat, p["ln2"], eps=cfg.rms_eps))
    return h + residual_shard(mlp_apply(p["mlp"], x, cfg.act))


def hybrid_shape(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(Mamba layers per super block, super blocks, tail layers)."""
    per = cfg.shared_attn_every
    n_super = cfg.n_layers // per
    return per, n_super, cfg.n_layers - n_super * per


def hybrid_stage_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    per, n_super, n_tail = hybrid_shape(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "super": [[mb.mamba2_init(gen, cfg, **kw) for _ in range(per)] for _ in range(n_super)],
        "shared": shared_attn_block_init(gen, cfg, **kw),
        "tail": [mb.mamba2_init(gen, cfg, **kw) for _ in range(n_tail)],
    }


def hybrid_stage_apply(
    params: Params,
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    cache_len=None,
    attend_len: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Cache: {"super": [{"mamba": [state] * per, "attn": kv}] * n_super,
    "tail": [state] * n_tail}, updated in place."""
    h0 = h
    remat = remat and cache is None
    for o, block in enumerate(params["super"]):
        c = None if cache is None else cache["super"][o]
        for i, lp in enumerate(block):
            out, _ = _call(mb.mamba2_apply, remat, lp, h, cfg,
                           state=None if c is None else c["mamba"][i])
            h = h + out
        h = _call(
            shared_attn_block_apply, remat, params["shared"], h, h0, cfg, positions=positions,
            cache=None if c is None else c["attn"], cache_len=cache_len, attend_len=attend_len,
        )
    for i, lp in enumerate(params["tail"]):
        out, _ = _call(mb.mamba2_apply, remat, lp, h, cfg,
                       state=None if cache is None else cache["tail"][i])
        h = h + out
    return h, cache


# ---------------------------------------------------------------------------
# xlstm stage: groups of (slstm_every - 1) mLSTM blocks + 1 sLSTM block
# ---------------------------------------------------------------------------

def xlstm_groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(mLSTM blocks per group, groups)."""
    per = cfg.xlstm.slstm_every
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.n_layers} layers not a multiple of slstm_every {per}")
    return per - 1, cfg.n_layers // per


def xlstm_stage_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> List[Params]:
    n_m, n_groups = xlstm_groups(cfg)
    kw = dict(dtype=dtype, device=device)
    return [
        {"m": [xl.mlstm_block_init(gen, cfg, **kw) for _ in range(n_m)],
         "s": xl.slstm_block_init(gen, cfg, **kw)}
        for _ in range(n_groups)
    ]


def xlstm_stage_apply(
    groups: List[Params],
    h: torch.Tensor,
    cfg: ModelConfig,
    *,
    cache: Optional[List[Dict]] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
    """Cache: [{"m": [mLSTM state] * n_m, "s": sLSTM state}] * n_groups,
    updated in place."""
    remat = remat and cache is None
    for g, grp in enumerate(groups):
        c = None if cache is None else cache[g]
        for i, lp in enumerate(grp["m"]):
            h, _ = _call(xl.mlstm_block_apply, remat, lp, h, cfg,
                         state=None if c is None else c["m"][i])
        h, _ = _call(xl.slstm_block_apply, remat, grp["s"], h, cfg,
                     state=None if c is None else c["s"])
    return h, cache
