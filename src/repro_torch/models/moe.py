"""Mixture-of-Experts layer: OLMoE (64 experts, softmax top-8) and
DeepSeek-V3 (256 experts, sigmoid top-8 selected with a bias, one shared
expert) -- port of `repro.models.moe`.

Dispatch is the JAX package's grouped one-hot formulation, ported exactly:

  tokens (N, D) -> groups (G, g, D), g = min(group_size, N)
  combine (G, g, E, C)  one-hot x gate weights
  expert_in (G, E, C, D) = einsum(combine > 0, x)
  expert_out = per-expert SwiGLU
  out (G, g, D) = einsum(combine, expert_out)

The padded tail of the last group is routed to expert 0 with a zero gate:
it is never dispatched, but it still takes expert 0's capacity.  Each
expert takes at most ``cap`` tokens per group, filled slot by slot (all
first choices, then all second choices, ...); a dropped token falls
through on the residual path.  Which tokens drop depends on the batch's
composition and padding, so the outputs do too: a gather-based dispatch
would change them and is not used.  The expert products are plain einsums
on every device (the JAX package runs no kernel here either).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.util import is_dtensor

from .layers import Params, dense_init, mlp_apply, mlp_init
from .sharding import DP, TP, axis_size, describe, physical_axes, shard


def moe_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    """The router stays fp32 whatever ``dtype``; experts are (E, D, F) /
    (E, F, D) with the JAX package's `dense_init(E, D, F)` scale."""
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.num_experts, m.d_ff_expert
    kw = dict(dtype=dtype, device=device)
    p: Params = {
        "router": dense_init(gen, D, E, dtype=torch.float32, device=device),
        "experts": {
            "w_gate": dense_init(gen, E, D, Fe, **kw),
            "w_up": dense_init(gen, E, D, Fe, **kw),
            "w_down": dense_init(gen, E, Fe, D, **kw),
        },
    }
    if m.num_shared:
        p["shared"] = mlp_init(gen, D, m.num_shared * Fe, **kw)
    # DeepSeek-V3's aux-free balancing bias (selection only; updated outside grad)
    p["router_bias"] = torch.zeros((E,), dtype=torch.float32, device=device)
    return p


def _route(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, ...]:
    """-> (gates (N, k) fp32, idx (N, k), aux loss (fp32 scalar))."""
    m = cfg.moe
    logits = tokens.float() @ p["router"]  # (N, E)
    if cfg.mla is not None:  # DeepSeek-V3: sigmoid scores, biased selection
        scores = torch.sigmoid(logits)
        idx = torch.topk(scores + p["router_bias"][None, :], m.top_k, dim=-1).indices
        gates = torch.gather(scores, 1, idx)
        gates = gates / gates.sum(dim=1, keepdim=True).clamp_min(1e-9)
        probs = scores / scores.sum(dim=1, keepdim=True).clamp_min(1e-9)
    else:  # OLMoE: softmax top-k
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, m.top_k, dim=-1)
        gates = gates / gates.sum(dim=1, keepdim=True).clamp_min(1e-9)
    # switch-style load-balance loss on the first choice: E * sum_e f_e * p_e
    E = logits.shape[-1]
    f = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * (f * probs.mean(dim=0)).sum()
    return gates, idx, aux


def _swiglu_experts(exp: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """x (..., E, C, D) -> (..., E, C, D); weights (E, D, F) / (E, F, D)."""
    g = torch.einsum("...ecd,edf->...ecf", x, exp["w_gate"])
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    u = torch.einsum("...ecd,edf->...ecf", x, exp["w_up"])
    return torch.einsum("...ecf,efd->...ecd", g * u, exp["w_down"])


def capacity(cfg: ModelConfig, g: int) -> int:
    """Tokens each expert takes per group of ``g``: ceil(g k / E) times the
    capacity factor, at least 8, rounded up to a multiple of 8."""
    m = cfg.moe
    cap = int(max(8, -(-g * m.top_k // m.num_experts) * m.capacity_factor))
    return -(-cap // 8) * 8


def dispatch_plan(gates: torch.Tensor, idx: torch.Tensor, cfg: ModelConfig, n: int):
    """(combine (G, g, E, cap) fp32, g) for routed tokens ``gates``/``idx``
    (N, k), the last group padded to ``g`` tokens with expert 0, gate 0."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    # under a mesh the routing is replicated (N x k values): the slot counts
    # run along every token of a group, which DTensor does not split (its
    # partial int64 sums come back float32), and XLA does
    gates, idx = shard(gates, None, None), shard(idx, None, None)
    g = min(m.group_size, n)
    pad = (-n) % g
    if pad:
        gates = F.pad(gates, (0, 0, 0, pad))
        idx = F.pad(idx, (0, 0, 0, pad))
    G = idx.shape[0] // g
    cap = capacity(cfg, g)
    gg, ig = gates.reshape(G, g, k), idx.reshape(G, g, k)
    counts = torch.zeros((G, E), dtype=torch.int64, device=idx.device)
    combine = torch.zeros((G, g, E, cap), dtype=torch.float32, device=idx.device)
    for j in range(k):  # slot-priority dropping with running per-expert counts
        oh = F.one_hot(ig[:, :, j], E)  # (G, g, E)
        pos = counts[:, None, :] + oh.cumsum(dim=1) - oh  # position before self
        mypos = (pos * oh).sum(dim=2)  # (G, g)
        pos_oh = F.one_hot(torch.where(mypos < cap, mypos, cap), cap + 1)[..., :cap]
        combine = combine + (
            gg[:, :, j][..., None, None] * oh.float()[..., None] * pos_oh.float()[:, :, None, :]
        )
        counts = counts + oh.sum(dim=1)
    return combine, g


def _experts(exp: Params, combine: torch.Tensor, xg: torch.Tensor, act: str) -> torch.Tensor:
    """Dispatch, the experts and the combine: (G, g, E, C) x (G, g, D) ->
    (G, g, D) in xg's dtype."""
    dispatch = (combine > 0).to(xg.dtype)
    expert_in = torch.einsum("Ggec,Ggd->Gecd", dispatch, xg)
    expert_out = _swiglu_experts(exp, expert_in, act)
    return torch.einsum("Ggec,Gecd->Ggd", combine.to(xg.dtype), expert_out)


def _experts_local(exp: Params, combine, xg, act: str):
    """:func:`_experts` on DTensors through ``local_map``: each rank runs its
    groups (G over dp) against its experts (E over tp), the layout of JAX's
    constraints on ``expert_in`` and ``expert_out`` ((DP, TP, None, None));
    the combine's sum over experts comes back partial over tp.  DTensor
    cannot run the einsums on those placements: their reshapes merge the
    sharded dims.  An axis that does not divide G (or E) takes none of
    it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = combine.device_mesh
    view = describe(mesh)
    dp, tp = physical_axes(mesh, DP) or (), physical_axes(mesh, TP)
    G, E = combine.shape[0], combine.shape[2]
    on_g = [a in dp and G % axis_size(mesh, dp) == 0 for a in view.axis_names]
    on_e = [a == tp and E % axis_size(mesh, tp) == 0 for a in view.axis_names]

    def pl(g, e):  # the placement of each mesh dim: g where it splits G, e where E
        return [g if on_g[m] else e if on_e[m] else Replicate() for m in range(mesh.ndim)]

    names = ("w_gate", "w_up", "w_down")
    w, w_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
    fn = local_map(
        lambda c, x, *ws: _experts(dict(zip(names, ws)), c, x, act),
        pl(Shard(0), Partial()),
        (pl(Shard(0), Shard(2)), pl(Shard(0), Replicate()), w, w, w),
        (pl(Shard(0), Shard(2)), pl(Shard(0), Partial()), w_grad, w_grad, w_grad),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(combine, xg, *(exp[n] for n in names))


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss fp32)."""
    B, S, D = x.shape
    N = B * S
    tokens = x.reshape(N, D)
    gates, idx, aux = _route(p, tokens, cfg)
    combine, g = dispatch_plan(gates, idx, cfg, N)
    pad = combine.shape[0] * g - N
    xg = shard(F.pad(tokens, (0, 0, 0, pad)).reshape(-1, g, D), DP, None, None)
    combine = shard(combine, DP, None, TP, None)
    if is_dtensor(combine):
        out = _experts_local(p["experts"], combine, xg, cfg.act)
    else:
        out = _experts(p["experts"], combine, xg, cfg.act)
    out = shard(out, DP, None, None)
    out = out.reshape(-1, D)[:N].reshape(B, S, D)
    if cfg.moe.num_shared:
        out = out + mlp_apply(p["shared"], x, cfg.act)
    return out, aux
