"""Model facade for the dense, moe, hybrid and ssm (xLSTM) families: init /
forward / prefill / decode (port of `repro.models.model`).

Parameters: {"embed": {"tok": (V, D)}, "final_norm": (D,), "lm_head": (D, V)
unless tied, "decoder": the stage}.  The dense stage is [per-layer dict,
...] with caches {"decoder": [{"k", "v"} per layer]}, each (B, S, K, hd).
The moe family has a "dense_prefix" stage of ``num_dense_layers`` MLP
layers (deepseek: 3) before its "decoder" stage of MoE layers, caches
{"dense_prefix": [...], "decoder": [...]} with one KV dict per layer, or
an MLA latent dict ({"c_kv", "k_pe"}) when the config has MLA, and an
"mtp" head (deepseek) that `forward` runs.  The hybrid and xLSTM stages
and their caches are described in `transformer`.  Caches are updated in
place.

Other families raise `NotImplementedError` naming the ROADMAP.md slice
that brings them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.util import tree_map

from . import attention as attn
from . import mamba2 as mb
from . import mla as mla_mod
from . import transformer as tfm
from . import xlstm as xl
from .layers import Params, dtype_of, embed_init, rmsnorm, rmsnorm_init, softcap

Batch = Dict[str, torch.Tensor]

PORTED = ("dense", "moe", "hybrid", "ssm")  # the families the port serves
_LATER = {
    "encdec": "slice 4 (whisper enc-dec)",
    "vlm": "slice 4 (VLM prefix)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        later = _LATER.get(cfg.family, "a later slice")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: see ROADMAP.md, {later}"
        )


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
) -> Params:
    """Random weights with the JAX initialisers' distributions, on ``device``
    (``cuda`` by default).  ``generator`` must live on that device; by
    default one seeded with 0."""
    _check_family(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    kw = dict(dtype=dtype_of(cfg.param_dtype), device=dev)
    p: Params = {
        "embed": {"tok": embed_init(generator, cfg.vocab_size, cfg.d_model, **kw)},
        "final_norm": rmsnorm_init(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(generator, cfg.d_model, cfg.vocab_size, **kw)
    if cfg.family == "hybrid":
        p["decoder"] = tfm.hybrid_stage_init(generator, cfg, **kw)
    elif cfg.family == "ssm":
        p["decoder"] = tfm.xlstm_stage_init(generator, cfg, **kw)
    elif cfg.family == "moe":
        nd = cfg.moe.num_dense_layers
        if nd:
            p["dense_prefix"] = tfm.decoder_stage_init(generator, cfg, nd, **kw)
        p["decoder"] = tfm.decoder_stage_init(generator, cfg, cfg.n_layers - nd, use_moe=True, **kw)
        if cfg.mtp_depth:
            p["mtp"] = {
                "proj": embed_init(generator, 2 * cfg.d_model, cfg.d_model, **kw),
                "block": tfm.decoder_layer_init(generator, cfg, **kw),
                "norm": rmsnorm_init(cfg.d_model, **kw),
            }
    else:
        p["decoder"] = tfm.decoder_stage_init(generator, cfg, cfg.n_layers, **kw)
    return p


def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    h = p["embed"]["tok"][tokens]
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype)
    return h


def head_weight(p: Params, cfg: ModelConfig) -> torch.Tensor:
    """(D, V) output head (tied or separate)."""
    return p["embed"]["tok"].T if cfg.tie_embeddings else p["lm_head"]


def _lm_logits(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, p["final_norm"], eps=cfg.rms_eps)
    logits = (h @ head_weight(p, cfg)).float()
    return softcap(logits, cfg.final_softcap)


def _backbone(p: Params, cfg: ModelConfig, h: torch.Tensor, *, cache=None, **kw):
    """Run the family's stages -> (h, aux loss fp32); ``cache`` (the whole
    cache dict, or None) is updated in place."""
    stage = lambda name: None if cache is None else cache[name]  # noqa: E731
    if cfg.family == "ssm":  # no positions: the recurrences carry them
        h, _ = tfm.xlstm_stage_apply(p["decoder"], h, cfg, cache=stage("decoder"))
    elif cfg.family == "hybrid":
        h, _ = tfm.hybrid_stage_apply(p["decoder"], h, cfg, cache=stage("decoder"), **kw)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if "dense_prefix" in p:
            h, _, aux = tfm.decoder_stage_apply(
                p["dense_prefix"], h, cfg, cache=stage("dense_prefix"), **kw)
        h, _, a = tfm.decoder_stage_apply(
            p["decoder"], h, cfg, cache=stage("decoder"), use_moe=cfg.family == "moe", **kw)
        return h, aux + a
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def forward(p: Params, cfg: ModelConfig, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Full-sequence forward -> (logits (B, S, V) fp32, MoE aux loss fp32,
    extras).  With an MTP head (deepseek) ``extras["mtp_logits"]`` (B, S -
    1, V) predicts token t + 2 from [rmsnorm(h_t) | embed(token t + 1)]
    through one dense layer at positions [0, S - 1)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    h = _embed_tokens(p, cfg, tokens).to(dtype_of(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, aux = _backbone(p, cfg, h, positions=positions)
    extras: Dict[str, torch.Tensor] = {}
    if cfg.mtp_depth and "mtp" in p:
        mtp = p["mtp"]
        emb_next = _embed_tokens(p, cfg, tokens)[:, 1:]  # the parameters' dtype, as in JAX
        cat = torch.cat([rmsnorm(h[:, :-1], mtp["norm"], eps=cfg.rms_eps), emb_next], dim=-1)
        h_mtp, _, _ = tfm.decoder_layer_apply(
            mtp["block"], cat @ mtp["proj"], cfg,
            window=None, positions=positions[:-1], cache=None, cache_len=None,
        )
        extras["mtp_logits"] = _lm_logits(p, cfg, h_mtp)
    return _lm_logits(p, cfg, h), aux, extras


def init_cache(
    cfg: ModelConfig,
    batch_size: int,
    max_len: int,
    cache_dtype=torch.bfloat16,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Any]:
    """Dense: a KV cache per layer; moe: the same per layer of each stage,
    or an MLA latent cache when the config has MLA.  Hybrid: a KV cache per super block
    (the shared block attends once per super block) in ``cache_dtype``, and
    per Mamba layer a conv state and an ssm state, both fp32.  ssm: per
    mLSTM and sLSTM block its recurrent state, all fp32 whatever
    ``cache_dtype`` (``max_len`` does not size it)."""
    _check_family(cfg)
    dev = resolve_device(device)
    kv = lambda: attn.init_kv_cache(cfg, batch_size, max_len, cache_dtype, dev)  # noqa: E731
    if cfg.family == "hybrid":
        per, n_super, n_tail = tfm.hybrid_shape(cfg)
        ms = lambda: mb.init_mamba_state(cfg, batch_size, device=dev)  # noqa: E731
        return {"decoder": {
            "super": [{"mamba": [ms() for _ in range(per)], "attn": kv()} for _ in range(n_super)],
            "tail": [ms() for _ in range(n_tail)],
        }}
    if cfg.family == "ssm":
        n_m, n_groups = tfm.xlstm_groups(cfg)
        return {"decoder": [
            {"m": [xl.init_mlstm_state(cfg, batch_size, dev) for _ in range(n_m)],
             "s": xl.init_slstm_state(cfg, batch_size, dev)}
            for _ in range(n_groups)
        ]}
    if cfg.family == "moe":
        if cfg.mla is not None:
            kv = lambda: mla_mod.init_mla_cache(cfg, batch_size, max_len, cache_dtype, dev)  # noqa: E731
        nd = cfg.moe.num_dense_layers
        cache = {"dense_prefix": [kv() for _ in range(nd)]} if nd else {}
        cache["decoder"] = [kv() for _ in range(cfg.n_layers - nd)]
        return cache
    return {"decoder": [kv() for _ in range(cfg.n_layers)]}


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Tree of ints: the batch axis of each cache leaf (all 0: layers are
    lists, not a stacked leading axis).  Feeds `cache_update.insert_rows`."""
    _check_family(cfg)
    return tree_map(lambda t: 0, init_cache(cfg, 1, 1, torch.float32, "meta"))


def prefill(
    p: Params,
    cfg: ModelConfig,
    batch: Batch,
    cache: Dict[str, Any],
    *,
    all_logits: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any], int]:
    """Process the prompt; returns (last-token logits, cache, new_len).

    ``all_logits=True`` returns logits for every prompt position (B, S, V):
    the continuous-batching prefill right-pads prompts and takes each
    row's logits at its own last true token."""
    _check_family(cfg)
    tokens = batch["tokens"]
    h = _embed_tokens(p, cfg, tokens).to(dtype_of(cfg.dtype))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _ = _backbone(p, cfg, h, positions=positions, cache=cache, cache_len=0)
    logits = _lm_logits(p, cfg, h if all_logits else h[:, -1:])
    return logits, cache, tokens.shape[1]


def decode_step(
    p: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # (B, 1)
    cache: Dict[str, Any],
    cache_len,  # int, or (B,) int tensor of per-slot lengths
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode; returns (logits (B, 1, V), cache).

    A (B,) ``cache_len`` is the continuous-batching form: every row decodes
    at its own position, so positions are (B, 1) and the cache write and
    the attention mask are per row."""
    _check_family(cfg)
    dev = tokens.device
    h = _embed_tokens(p, cfg, tokens).to(dtype_of(cfg.dtype))
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
        cache_len = cache_len.to(device=dev, dtype=torch.int32)
        positions = cache_len[:, None]
    else:
        cache_len = int(cache_len)
        positions = torch.tensor([cache_len], device=dev)
    attend_len = None
    if cfg.family != "ssm" and cfg.mla is None:  # xLSTM attends over nothing, MLA masks itself
        attend_len = attn.decode_lengths(cache_len, tokens.shape[0], dev)
    h, _ = _backbone(
        p, cfg, h, positions=positions, cache=cache, cache_len=cache_len, attend_len=attend_len,
    )
    return _lm_logits(p, cfg, h), cache
