"""JAX parameter trees, as numpy arrays, -> the port's parameters.

The JAX package stacks a dense decoder's layer weights as (outer, period,
...) (`decoder_stage_init`); the port keeps a list of per-layer dicts, so
the conversion unstacks layer ``o * period + i`` from ``leaf[o, i]``.  The
hybrid stage stacks its Mamba layers as ``super`` (n_super, per, ...) and
``tail`` (n_tail, ...), unstacked the same way; its ``shared`` attention
block is one dict, converted once (every super block reuses it).  The
xLSTM stage stacks its mLSTM blocks as ``mlstm`` (n_groups, per - 1, ...)
and its sLSTM blocks as ``slstm`` (n_groups, ...); the port keeps one
``{"m": [...], "s": ...}`` dict per group.  The moe family's two stages,
``dense_prefix`` and ``decoder``, are stacked as (n, 1, ...) like a dense
decoder (experts (n, 1, E, D, F), ``router_bias`` and ``shared`` inside
each layer's ``moe``); its ``mtp`` head (``proj``, ``norm`` and one
unstacked ``block`` layer) converts leaf by leaf.  The encdec family
(whisper) stacks its ``encoder`` and cross-attending ``decoder`` on one
leading axis, (L, ...), so layer ``i`` is ``leaf[i]``; ``enc_pos``,
``encoder_norm`` and the learned ``embed.pos`` convert leaf by leaf.  The
vlm's tree is a dense one.
Weight layouts are the same on both sides (`wq (D, H, hd)`, `wo (H, hd,
D)`, `w_gate (D, F)`), so no leaf is transposed.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` rejects: they are recognised by ``dtype.name`` and
reinterpreted through ``uint16``.  Nothing here imports jax.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import PORTED
from repro_torch.models.transformer import hybrid_shape, layer_period, xlstm_groups
from repro_torch.util import tree_flatten, tree_map


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.array(a, copy=True)  # own, writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cpu") -> Dict[str, Any]:
    """Convert a model's JAX parameter tree (leaves as numpy arrays)."""
    if cfg.family not in PORTED:
        raise ValueError(cfg.family)
    conv = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    stacked = ("decoder", "dense_prefix", "encoder")
    out = {k: tree_map(conv, v) for k, v in tree.items() if k not in stacked}
    dec = tree["decoder"]
    if cfg.family == "encdec":
        for name in ("encoder", "decoder"):
            n = tree_flatten(tree[name])[0][0].shape[0]
            out[name] = [tree_map(lambda a, i=i: conv(a[i]), tree[name]) for i in range(n)]
        return out
    if cfg.family == "hybrid":
        per, n_super, n_tail = hybrid_shape(cfg)
        out["decoder"] = {
            "super": [[tree_map(lambda a, o=o, i=i: conv(a[o, i]), dec["super"])
                       for i in range(per)] for o in range(n_super)],
            "shared": tree_map(conv, dec["shared"]),
            "tail": [tree_map(lambda a, i=i: conv(a[i]), dec["tail"]) for i in range(n_tail)],
        }
        return out
    if cfg.family == "ssm":
        n_m, n_groups = xlstm_groups(cfg)
        out["decoder"] = [
            {"m": [tree_map(lambda a, g=g, i=i: conv(a[g, i]), dec["mlstm"]) for i in range(n_m)],
             "s": tree_map(lambda a, g=g: conv(a[g]), dec["slstm"])}
            for g in range(n_groups)
        ]
        return out
    period = layer_period(cfg)
    for name in stacked:
        if name in tree:
            outer = tree_flatten(tree[name])[0][0].shape[0]
            out[name] = [
                tree_map(lambda a, o=o, i=i: conv(a[o, i]), tree[name])
                for o in range(outer)
                for i in range(period)
            ]
    return out
