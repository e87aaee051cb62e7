"""JAX parameter trees, as numpy arrays, <-> the port's parameters.

The JAX package stacks a dense decoder's layer weights as (outer, period,
...) (`decoder_stage_init`); the port keeps a list of per-layer dicts, so
the conversion unstacks layer ``o * period + i`` from ``leaf[o, i]``.  The
hybrid stage stacks its Mamba layers as ``super`` (n_super, per, ...) and
``tail`` (n_tail, ...; absent when n_tail is 0), unstacked the same way; its
``shared`` attention block is one dict, converted once (every super block
reuses it).  The xLSTM stage stacks its mLSTM blocks as ``mlstm`` (n_groups,
per - 1, ...) and its sLSTM blocks as ``slstm`` (n_groups, ...); the port
keeps one ``{"m": [...], "s": ...}`` dict per group.  The moe family's two
stages, ``dense_prefix`` and ``decoder``, are stacked as (n, 1, ...) like a
dense decoder (experts (n, 1, E, D, F), ``router_bias`` and ``shared``
inside each layer's ``moe``); its ``mtp`` head (``proj``, ``norm`` and one
unstacked ``block`` layer) converts leaf by leaf.  The encdec family
(whisper) stacks its ``encoder`` and cross-attending ``decoder`` on one
leading axis, (L, ...), so layer ``i`` is ``leaf[i]``; ``enc_pos``,
``encoder_norm`` and the learned ``embed.pos`` convert leaf by leaf.  The
vlm's tree is a dense one.
Weight layouts are the same on both sides (`wq (D, H, hd)`, `wo (H, hd,
D)`, `w_gate (D, F)`), so no leaf is transposed.

:func:`params_from_jax` goes JAX -> port; :func:`params_to_jax` is its exact
inverse, port -> JAX, and :func:`moments_from_jax` converts the AdamW
moments of a JAX train state (int8 blocks included; see its docstring).

bf16 leaves arrive as ``ml_dtypes.bfloat16`` numpy arrays, which
``torch.from_numpy`` rejects: they are recognised by ``dtype.name`` and
reinterpreted through ``uint16``.  Going out, a bf16 leaf is its ``uint16``
bits, returned beside its dtype name ``bfloat16`` (the same bits as
``ml_dtypes.bfloat16``).  Nothing here imports jax or ml_dtypes.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import PORTED
from repro_torch.models.transformer import hybrid_shape, layer_period, xlstm_groups
from repro_torch.storage.serialization import host_array
from repro_torch.util import tree_flatten, tree_map, tree_unflatten


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A numpy array (an ``ml_dtypes.bfloat16`` one included) or a tensor,
    as a tensor of its own on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.array(a, copy=True)  # own, writable, contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


_STACKED = ("decoder", "dense_prefix", "encoder")


def _from_jax_layout(tree: Dict[str, Any], cfg: ModelConfig, take: Callable) -> Dict[str, Any]:
    """Restructure a tree in JAX's layout into the port's: ``take(leaf,
    idx)`` gives the port's leaf for layer index ``idx`` of a stacked JAX
    leaf (``()`` for a leaf that is not stacked)."""
    if cfg.family not in PORTED:
        raise ValueError(cfg.family)
    conv = lambda a: take(a, ())  # noqa: E731
    out = {k: tree_map(conv, v) for k, v in tree.items() if k not in _STACKED}
    dec = tree["decoder"]
    if cfg.family == "encdec":
        for name in ("encoder", "decoder"):
            n = tree_flatten(tree[name])[0][0].shape[0]
            out[name] = [tree_map(lambda a, i=i: take(a, (i,)), tree[name]) for i in range(n)]
        return out
    if cfg.family == "hybrid":
        per, n_super, n_tail = hybrid_shape(cfg)
        out["decoder"] = {
            "super": [[tree_map(lambda a, o=o, i=i: take(a, (o, i)), dec["super"])
                       for i in range(per)] for o in range(n_super)],
            "shared": tree_map(conv, dec["shared"]),
            "tail": [tree_map(lambda a, i=i: take(a, (i,)), dec["tail"]) for i in range(n_tail)],
        }
        return out
    if cfg.family == "ssm":
        n_m, n_groups = xlstm_groups(cfg)
        out["decoder"] = [
            {"m": [tree_map(lambda a, g=g, i=i: take(a, (g, i)), dec["mlstm"]) for i in range(n_m)],
             "s": tree_map(lambda a, g=g: take(a, (g,)), dec["slstm"])}
            for g in range(n_groups)
        ]
        return out
    period = layer_period(cfg)
    for name in _STACKED:
        if name in tree:
            outer = tree_flatten(tree[name])[0][0].shape[0]
            out[name] = [
                tree_map(lambda a, o=o, i=i: take(a, (o, i)), tree[name])
                for o in range(outer)
                for i in range(period)
            ]
    return out


def _to_jax_layout(tree: Dict[str, Any], cfg: ModelConfig, stack: Callable) -> Dict[str, Any]:
    """Inverse of :func:`_from_jax_layout` over already-converted leaves:
    ``stack(leaves)`` stacks a list of same-shaped leaves on a new leading
    axis."""
    if cfg.family not in PORTED:
        raise ValueError(cfg.family)
    stack_trees = lambda ts: tree_map(lambda *xs: stack(list(xs)), *ts)  # noqa: E731
    out = {k: v for k, v in tree.items() if k not in _STACKED}
    dec = tree["decoder"]
    if cfg.family == "encdec":
        for name in ("encoder", "decoder"):
            out[name] = stack_trees(tree[name])
        return out
    if cfg.family == "hybrid":
        out["decoder"] = {"super": stack_trees([stack_trees(row) for row in dec["super"]]),
                          "shared": dec["shared"]}
        if dec["tail"]:
            out["decoder"]["tail"] = stack_trees(dec["tail"])
        return out
    if cfg.family == "ssm":
        out["decoder"] = {"mlstm": stack_trees([stack_trees(g["m"]) for g in dec]),
                          "slstm": stack_trees([g["s"] for g in dec])}
        return out
    period = layer_period(cfg)
    for name in _STACKED:
        if name in tree:
            layers = tree[name]
            out[name] = stack_trees([stack_trees(layers[o : o + period])
                                     for o in range(0, len(layers), period)])
    return out


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cpu") -> Dict[str, Any]:
    """Convert a model's JAX parameter tree (leaves as numpy arrays, or as
    tensors)."""
    return _from_jax_layout(tree, cfg, lambda a, idx: tensor_from_numpy(a[idx], device))


def params_to_jax(params: Dict[str, Any], cfg: ModelConfig) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's parameters in the JAX package's layout: ``(arrays,
    dtypes)``, two trees of one structure.  ``arrays`` holds host numpy
    arrays, with a bf16 leaf as its ``uint16`` bits; ``dtypes`` holds each
    leaf's dtype name (``bfloat16`` there), so ``a.view(ml_dtypes.bfloat16)``
    gives JAX's array.  The exact inverse of :func:`params_from_jax`."""
    leaves, struct = tree_flatten(params)
    hosted = [host_array(t) for t in leaves]
    arrays = _to_jax_layout(tree_unflatten(struct, [a for a, _ in hosted]), cfg, np.stack)
    dtypes = _to_jax_layout(tree_unflatten(struct, [n for _, n in hosted]), cfg,
                            lambda names: names[0])
    return arrays, dtypes


class _Stacked:
    """A JAX moment leaf (an array, or an int8 ``{"q", "scale"}`` block
    encoding) beside the shape of the parameter it belongs to."""

    def __init__(self, leaf: Any, shape) -> None:
        self.leaf, self.shape = leaf, tuple(shape)
        self._full = None

    def dequantized(self) -> torch.Tensor:
        from repro_torch.train.optimizer import _q8_decode

        if self._full is None:
            self._full = _q8_decode({k: torch.as_tensor(v) for k, v in self.leaf.items()},
                                    self.shape)
        return self._full


def moments_from_jax(moments: Any, like: Any, cfg: ModelConfig, device="cpu") -> Any:
    """Convert one AdamW moment tree (``m`` or ``v``) of a JAX train state.

    ``like`` is the JAX-layout parameter tree (or any tree of its structure
    whose leaves have the parameters' ``.shape``).  A plain moment leaf is
    unstacked like its parameter.  An int8 leaf ``{"q": (blocks, 256),
    "scale": (blocks, 1)}`` holds blocks of 256 consecutive elements of the
    *stacked* leaf, while the port's blocks run over each per-layer leaf.
    Where a per-layer leaf holds a multiple of 256 elements (every leaf of
    llama3-8b) the blocks coincide and are sliced exactly.  Where it does
    not (the reduced configs' 128-wide norms), the stacked leaf is
    dequantised and each layer's slice quantised afresh: the values move by
    up to half an int8 step of the new block's scale."""
    from repro_torch.train.optimizer import _is_q8, _q8_encode

    leaves, struct = tree_flatten(moments, is_leaf=_is_q8)
    shapes = [a.shape for a in tree_flatten(like)[0]]
    if len(leaves) != len(shapes):
        raise ValueError(f"moment tree has {len(leaves)} leaves, parameters {len(shapes)}")
    wrapped = tree_unflatten(struct, [_Stacked(l, s) for l, s in zip(leaves, shapes)])

    def take(w: _Stacked, idx) -> Any:
        if not _is_q8(w.leaf):
            return tensor_from_numpy(w.leaf[idx], device)
        q, scale = (torch.as_tensor(w.leaf[k]) for k in ("q", "scale"))
        layer_n = math.prod(w.shape[len(idx):])
        if not idx or layer_n % q.shape[1] == 0:
            nb = -(-layer_n // q.shape[1])
            off = int(np.ravel_multi_index(idx, w.shape[: len(idx)])) * nb if idx else 0
            return {"q": q[off : off + nb].to(device, copy=True),
                    "scale": scale[off : off + nb].to(device, copy=True)}
        enc = _q8_encode(w.dequantized()[idx].contiguous())
        return {k: v.to(device) for k, v in enc.items()}

    return _from_jax_layout(wrapped, cfg, take)
