"""The stateless training step: (train_state, batch) -> (train_state',
metrics) (port of `repro.train.train_step`).

This is the unit the serverless runtime schedules.  It is pure: the same
state and batch give the same result, which is what makes PyWren-style
idempotent re-execution correct for training.

Features: CE loss with ignore index, MoE aux loss, MTP aux loss (DeepSeek),
grad clipping, microbatch gradient accumulation in fp32, remat, metrics.
A sharded state (DTensor leaves, run under `models.sharding.use_mesh`)
gets its gradients in its parameters' placements.

Gradients are ``torch.autograd.grad`` of the loss with respect to the
parameter leaves (detached aliases that require grad, so the caller's
tensors are untouched); a leaf the loss does not reach gets zeros, as
``jax.grad`` gives.  ``inplace=True`` is the form for the card: the
parameters and moments are overwritten leaf by leaf
(`AdamW.update_`), the clip factor applied inside the update, and no
gradient outlives its leaf's update; the returned state holds the same
tensors as the one passed in.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward, forward_hidden, head_weight
from repro_torch.models.sharding import DP, placed_like, shard
from repro_torch.util import tree_flatten, tree_unflatten

from .fused_ce import fused_cross_entropy
from .optimizer import AdamW, AdamWState, apply_updates, clip_by_global_norm, clip_factor, global_norm

IGNORE = -1


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamWState


def cross_entropy(
    logits: torch.Tensor,  # (B, S, V) fp32
    labels: torch.Tensor,  # (B, S) int, IGNORE = masked
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (summed nll, token count)."""
    mask = labels != IGNORE
    safe = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    # under a mesh the gather reads the vocab whole: DTensor's gather over a
    # vocab-sharded dim leaves a masked partial sum it fails to reduce
    # (torch 2.13), where XLA partitions JAX's take_along_axis
    gold = torch.gather(shard(logits, DP, None, None), -1, safe[..., None])[..., 0]
    nll = torch.where(mask, logz - gold, 0.0)
    return nll.sum(), mask.sum()


def make_loss_fn(cfg: ModelConfig, *, remat: bool = False, fused_ce: Optional[bool] = None):
    """``fused_ce=True`` uses the vocab-chunked CE (never materialises (N, V)
    fp32 logits, see `fused_ce`).  Default: the ``REPRO_FUSED_CE``
    environment variable, as in JAX."""
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    mtp_w = 0.3 if cfg.mtp_depth else 0.0
    if fused_ce is None:
        fused_ce = os.environ.get("REPRO_FUSED_CE", "0") == "1"

    def _labels(batch):
        labels = batch["labels"]
        if cfg.frontend == "vision_stub" and "prefix_embed" in batch:
            # prefix positions carry no LM loss
            P = batch["prefix_embed"].shape[1]
            pad = torch.full((labels.shape[0], P), IGNORE, dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], dim=1)
        return labels

    def loss_fn_fused(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        h, aux, extras = forward_hidden(params, cfg, batch, remat=remat)
        labels = _labels(batch)
        W = head_weight(params, cfg)
        B, S, D = h.shape
        nll, count = fused_cross_entropy(
            h.reshape(B * S, D), W, labels.reshape(-1), final_softcap=cfg.final_softcap,
        )
        loss = nll / torch.clamp(count, min=1)
        metrics = {"nll": loss, "tokens": count}
        if aux_w:
            loss = loss + aux_w * aux
            metrics["router_aux"] = aux
        if mtp_w and "mtp_hidden" in extras:
            hm = extras["mtp_hidden"]
            mtp_labels = labels[:, 2:]
            hm = hm[:, : mtp_labels.shape[1]]
            Bm, Sm, _ = hm.shape
            mtp_nll, mtp_count = fused_cross_entropy(
                hm.reshape(Bm * Sm, D), W, mtp_labels.reshape(-1),
                final_softcap=cfg.final_softcap,
            )
            mtp_loss = mtp_nll / torch.clamp(mtp_count, min=1)
            loss = loss + mtp_w * mtp_loss
            metrics["mtp_nll"] = mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def loss_fn(params, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, aux, extras = forward(params, cfg, batch, remat=remat)
        labels = _labels(batch)
        nll, count = cross_entropy(logits, labels)
        loss = nll / torch.clamp(count, min=1)
        metrics = {"nll": loss, "tokens": count}
        if aux_w:
            loss = loss + aux_w * aux
            metrics["router_aux"] = aux
        if mtp_w and "mtp_logits" in extras:
            # MTP predicts token t+2 from position t
            mtp_labels = labels[:, 2:]
            mtp_logits = extras["mtp_logits"][:, : mtp_labels.shape[1]]
            mtp_nll, mtp_count = cross_entropy(mtp_logits, mtp_labels)
            mtp_loss = mtp_nll / torch.clamp(mtp_count, min=1)
            loss = loss + mtp_w * mtp_loss
            metrics["mtp_nll"] = mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn_fused if fused_ce else loss_fn


def grad_fn(loss_fn, params, batch) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """-> (gradients in ``tree_flatten(params)`` order, metrics detached)."""
    flat, struct = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    loss, metrics = loss_fn(tree_unflatten(struct, leaves), batch)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    del loss
    for i, (g, p) in enumerate(zip(grads, flat)):
        grads[i] = torch.zeros_like(p) if g is None else placed_like(g, p)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(
    cfg: ModelConfig,
    opt: AdamW,
    *,
    remat: bool = False,
    grad_clip: float = 1.0,
    microbatches: int = 1,
    fused_ce: Optional[bool] = None,
    inplace: bool = False,
):
    """The stateless step.  With ``microbatches > 1`` the global batch is
    split on the batch axis and the gradients accumulated in fp32 (the
    first microbatch fixes the metric structure, as in JAX)."""
    loss_fn = make_loss_fn(cfg, remat=remat, fused_ce=fused_ce)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if microbatches == 1:
            grads, metrics = grad_fn(loss_fn, params, batch)
        else:
            def part(x, i):
                B = x.shape[0]
                if B % microbatches:
                    raise ValueError(f"batch {B} not a multiple of {microbatches} microbatches")
                return x.reshape(microbatches, B // microbatches, *x.shape[1:])[i]

            grads, metrics = grad_fn(loss_fn, params, {k: part(v, 0) for k, v in batch.items()})
            grads = [g.to(torch.float32) for g in grads]
            for i in range(1, microbatches):
                g_i, met = grad_fn(loss_fn, params, {k: part(v, i) for k, v in batch.items()})
                grads = [a + b.to(torch.float32) for a, b in zip(grads, g_i)]
                metrics = {k: metrics[k] + met[k] for k in metrics}
            grads = [g / microbatches for g in grads]
            metrics = {k: m / microbatches for k, m in metrics.items()}

        if inplace:
            gnorm = global_norm(grads)
            new_opt = opt.update_(grads, state.opt_state, params,
                                  grad_scale=clip_factor(gnorm, grad_clip))
            new_params = params
        else:
            struct = tree_flatten(params)[1]
            clipped, gnorm = clip_by_global_norm(tree_unflatten(struct, grads), grad_clip)
            del grads
            updates, new_opt = opt.update(clipped, state.opt_state, params)
            new_params = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return TrainState(params=new_params, opt_state=new_opt), metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt: AdamW, generator: Optional[torch.Generator] = None,
                     device=None) -> TrainState:
    """Random parameters (`init_params`, seed 0 by default) on ``device``
    (``cuda`` by default) and the optimizer's initial state."""
    from repro_torch.models import init_params

    params = init_params(cfg, generator, device)
    return TrainState(params=params, opt_state=opt.init(params))
