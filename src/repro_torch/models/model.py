"""Model facade for every family of the JAX package (dense, moe, hybrid,
ssm (xLSTM), encdec (whisper) and vlm): init / forward / prefill / decode
(port of `repro.models.model`).

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

The batch dict carries the family's inputs: "tokens" (B, S) always;
"prefix_embed" (B, P, D) for the vlm (precomputed patch embeddings, put
in front of the text, so prefill returns P + S); "audio_frames" (B,
S_enc, D) for encdec (precomputed frames).  encdec adds "embed.pos" (a
learned table of ``max_target_positions`` rows, clamped at its last row),
"enc_pos", "encoder" and "encoder_norm"; its cache is {"decoder":
[{"self": kv} per layer]}, and prefill adds each layer's "cross" K/V.  The
vlm runs the dense stage.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.util import is_dtensor, tree_map

from . import attention as attn
from . import mamba2 as mb
from . import mla as mla_mod
from . import transformer as tfm
from . import xlstm as xl
from .layers import Params, dtype_of, embed_init, rmsnorm, rmsnorm_init, softcap
from .sharding import DP, TP, residual_shard, shard, whole_gradient

Batch = Dict[str, torch.Tensor]

PORTED = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")  # the families the port serves


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED:
        raise ValueError(cfg.family)


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
    if cfg.pos_embedding == "learned":
        p["embed"]["pos"] = embed_init(generator, cfg.max_target_positions, cfg.d_model, **kw)
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
    elif cfg.family == "encdec":
        p["enc_pos"] = embed_init(generator, cfg.encoder_seq, cfg.d_model, **kw)
        p["encoder"] = tfm.encoder_stage_init(generator, cfg, **kw)
        p["encoder_norm"] = rmsnorm_init(cfg.d_model, **kw)
        p["decoder"] = tfm.xdecoder_stage_init(generator, cfg, **kw)
    else:  # dense, vlm
        p["decoder"] = tfm.decoder_stage_init(generator, cfg, cfg.n_layers, **kw)
    return p


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table``'s rows at ``ids``, as ``jnp.take`` gives them: an id in
    ``[-V, 0)`` wraps to ``V + id``, any id outside ``[-V, V)`` gives a NaN
    row.  The index is clamped before the lookup, so no id reaches the
    device out of range (on the card that would be a device-side assert,
    fatal to every request the process holds)."""
    V = table.shape[0]
    ids = torch.where(ids < 0, ids + V, ids)
    valid = (ids >= 0) & (ids < V)
    rows = table[ids.clamp(0, V - 1)]
    return torch.where(valid[..., None], rows, rows.new_full((), float("nan")))


def _embed_tokens(p: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    table = p["embed"]["tok"]
    # on a mesh every token is replicated for the vocab-parallel lookup
    # (each rank its vocab shard, the rows summed), where XLA partitions
    # JAX's take; DTensor's embedding mis-masks tokens sharded over another
    # mesh dim (torch 2.13), and its backward of indexing fails (2.11)
    tokens = shard(tokens, *([None] * tokens.dim()))
    h = F.embedding(tokens, table) if is_dtensor(table) else take_rows(table, tokens)
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model**0.5, dtype=h.dtype)
    # the lookup's partial rows summed here, in the residual stream's layout
    # (DTensor cannot add them to another partial sum: deepseek's MTP input),
    # and the gradient reduced before the lookup's backward
    return whole_gradient(residual_shard(h)) if h.dim() == 3 else h


def head_weight(p: Params, cfg: ModelConfig) -> torch.Tensor:
    """(D, V) output head (tied or separate)."""
    return p["embed"]["tok"].T if cfg.tie_embeddings else p["lm_head"]


def _lm_logits(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, p["final_norm"], eps=cfg.rms_eps)
    logits = (h @ head_weight(p, cfg)).float()
    return shard(softcap(logits, cfg.final_softcap), DP, None, TP)


def _learned_positions(p: Params, positions: torch.Tensor) -> torch.Tensor:
    """Rows of the learned position table at ``positions``, clamped at its
    last row (as JAX clamps them)."""
    table = p["embed"]["pos"]
    return table[positions.clamp(max=table.shape[0] - 1)]


def _assemble_input(p: Params, cfg: ModelConfig, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (hidden (B, S, D) in ``cfg.dtype``, positions (S,)): the token
    embeddings behind the vlm's ``prefix_embed`` where the batch has it,
    plus learned positions clamped at the table's last row."""
    h = _embed_tokens(p, cfg, batch["tokens"])
    if cfg.frontend == "vision_stub" and "prefix_embed" in batch:
        h = torch.cat([batch["prefix_embed"].to(h.dtype), h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    if cfg.pos_embedding == "learned":
        h = h + _learned_positions(p, positions)[None]
    return residual_shard(h.to(dtype_of(cfg.dtype))), positions


def _encode(p: Params, cfg: ModelConfig, batch: Batch, *, remat: bool = False) -> torch.Tensor:
    """The encoder over ``audio_frames`` (B, S_enc, D) -> (B, S_enc, D)."""
    frames = batch["audio_frames"]
    h = frames.to(dtype_of(cfg.dtype)) + p["enc_pos"][None, : frames.shape[1]]
    h = shard(h, DP, None, None)
    h = tfm.encoder_stage_apply(p["encoder"], h, cfg, remat=remat)
    return rmsnorm(h, p["encoder_norm"], eps=cfg.rms_eps)


def _backbone(p: Params, cfg: ModelConfig, h: torch.Tensor, *, cache=None, enc_out=None,
              remat: bool = False, **kw):
    """Run the family's stages -> (h, aux loss fp32); ``cache`` (the whole
    cache dict, or None) is updated in place.  ``remat`` recomputes each
    layer in the backward pass (no-cache forward only)."""
    stage = lambda name: None if cache is None else cache[name]  # noqa: E731
    if cfg.family == "encdec":
        h, _ = tfm.xdecoder_stage_apply(p["decoder"], h, cfg, enc_out=enc_out,
                                        cache=stage("decoder"), remat=remat, **kw)
    elif cfg.family == "ssm":  # no positions: the recurrences carry them
        h, _ = tfm.xlstm_stage_apply(p["decoder"], h, cfg, cache=stage("decoder"), remat=remat)
    elif cfg.family == "hybrid":
        h, _ = tfm.hybrid_stage_apply(p["decoder"], h, cfg, cache=stage("decoder"),
                                      remat=remat, **kw)
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if "dense_prefix" in p:
            h, _, aux = tfm.decoder_stage_apply(
                p["dense_prefix"], h, cfg, cache=stage("dense_prefix"), remat=remat, **kw)
        h, _, a = tfm.decoder_stage_apply(
            p["decoder"], h, cfg, cache=stage("decoder"), use_moe=cfg.family == "moe",
            remat=remat, **kw)
        return h, aux + a
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _forward_trunk(p: Params, cfg: ModelConfig, batch: Batch, *, remat: bool = False):
    """-> (h before the final norm, MoE aux loss fp32, the MTP head's hidden
    state or None).  With an MTP head (deepseek) the hidden state (B, S -
    1, D) comes from [rmsnorm(h_t) | embed(token t + 1)] through one dense
    layer at positions [0, S - 1); it predicts token t + 2."""
    _check_family(cfg)
    enc_out = _encode(p, cfg, batch, remat=remat) if cfg.family == "encdec" else None
    h, positions = _assemble_input(p, cfg, batch)
    h, aux = _backbone(p, cfg, h, positions=positions, enc_out=enc_out, remat=remat)
    h_mtp = None
    if cfg.mtp_depth and "mtp" in p:
        mtp = p["mtp"]
        emb_next = _embed_tokens(p, cfg, batch["tokens"])[:, 1:]  # the parameters' dtype, as in JAX
        cat = torch.cat([rmsnorm(h[:, :-1], mtp["norm"], eps=cfg.rms_eps), emb_next], dim=-1)
        h_mtp, _, _ = tfm.decoder_layer_apply(
            mtp["block"], cat @ mtp["proj"], cfg,
            window=None, positions=positions[:-1], cache=None, cache_len=None,
        )
    return h, aux, h_mtp


def forward(p: Params, cfg: ModelConfig, batch: Batch, *,
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Full-sequence forward (train / eval) -> (logits (B, S, V) fp32, MoE
    aux loss fp32, extras).  With an MTP head (deepseek)
    ``extras["mtp_logits"]`` (B, S - 1, V) predicts token t + 2 (see
    `_forward_trunk`).  ``remat`` recomputes each layer in the backward
    pass, saving only the layers' inputs (the JAX default policy)."""
    h, aux, h_mtp = _forward_trunk(p, cfg, batch, remat=remat)
    extras: Dict[str, torch.Tensor] = {}
    if h_mtp is not None:
        extras["mtp_logits"] = _lm_logits(p, cfg, h_mtp)
    return _lm_logits(p, cfg, h), aux, extras


def forward_hidden(p: Params, cfg: ModelConfig, batch: Batch, *,
                   remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """`forward` without the head matmul -> (final-normed h (B, S, D), aux,
    extras with ``mtp_hidden``, final-normed too), for the fused
    (vocab-chunked) loss."""
    h, aux, h_mtp = _forward_trunk(p, cfg, batch, remat=remat)
    extras: Dict[str, torch.Tensor] = {}
    if h_mtp is not None:
        extras["mtp_hidden"] = rmsnorm(h_mtp, p["final_norm"], eps=cfg.rms_eps)
    return rmsnorm(h, p["final_norm"], eps=cfg.rms_eps), aux, extras


def init_cache(
    cfg: ModelConfig,
    batch_size: int,
    max_len: int,
    cache_dtype=torch.bfloat16,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, Any]:
    """Dense and vlm: a KV cache per layer; moe: the same per layer of each
    stage, or an MLA latent cache when the config has MLA; encdec: a
    self-attention KV cache per layer, {"self": kv} (prefill adds the
    cross K/V).  Hybrid: a KV cache per super block
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
    if cfg.family == "encdec":
        return {"decoder": [{"self": kv()} for _ in range(cfg.n_layers)]}
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
    ``new_len`` counts the vlm's prefix rows with the tokens.

    ``all_logits=True`` returns logits for every prompt position (B, S, V):
    the continuous-batching prefill right-pads prompts and takes each
    row's logits at its own last true token."""
    _check_family(cfg)
    enc_out = _encode(p, cfg, batch) if cfg.family == "encdec" else None
    h, positions = _assemble_input(p, cfg, batch)
    h, _ = _backbone(p, cfg, h, positions=positions, cache=cache, cache_len=0, enc_out=enc_out)
    logits = _lm_logits(p, cfg, h if all_logits else h[:, -1:])
    return logits, cache, h.shape[1]


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
    the attention mask are per row.  Learned positions (encdec) are read
    at ``cache_len``, clamped at the table's last row."""
    _check_family(cfg)
    dev = tokens.device
    h = _embed_tokens(p, cfg, tokens).to(dtype_of(cfg.dtype))
    if isinstance(cache_len, torch.Tensor) and cache_len.dim() == 1:
        cache_len = cache_len.to(device=dev, dtype=torch.int32)
        positions = cache_len[:, None]
    else:
        cache_len = int(cache_len)
        positions = torch.tensor([cache_len], device=dev)
    if cfg.pos_embedding == "learned":
        h = h + _learned_positions(p, positions).reshape(-1, 1, cfg.d_model)
    h = shard(h, DP, None, None)
    attend_len = None
    if cfg.family != "ssm" and cfg.mla is None:  # xLSTM attends over nothing, MLA masks itself
        attend_len = attn.decode_lengths(cache_len, tokens.shape[0], dev)
    h, _ = _backbone(
        p, cfg, h, positions=positions, cache=cache, cache_len=cache_len, attend_len=attend_len,
    )
    return _lm_logits(p, cfg, h), cache
