"""Mamba2 mixer block, the zamba2 backbone (port of `repro.models.mamba2`).

in_proj fans out to [z | x | B | C | dt]; a depthwise causal conv runs over
[x | B | C]; the SSD scan runs over heads (`ops.ssd_scan`: the CUDA kernel on
the card, the plain chunked scan on the CPU); then the gated RMSNorm and
out_proj.  Decode keeps (conv state, ssm state): O(1) per token.

The state dict is updated in place, as the attention caches are.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

from .layers import Params, causal_conv1d, dense_init, grouped_rmsnorm
from .sharding import DP, TP, placed_like, residual_shard, shard, sublayer_input


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.num_groups * s.state_dim
    return s, d_in, n_heads, conv_dim


def mamba2_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    """Random weights with the JAX initialisers' distributions: dt drawn
    log-uniform in [dt_min, dt_max] and stored as its inverse softplus,
    A_log = log(1..H), D = 1."""
    s, d_in, nh, conv_dim = _dims(cfg)
    D = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    proj_out = 2 * d_in + 2 * s.num_groups * s.state_dim + nh
    in_proj = dense_init(gen, D, proj_out, **kw)
    u = torch.rand((nh,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(s.dt_max) - math.log(s.dt_min)) + math.log(s.dt_min))
    conv = torch.empty((s.conv_kernel, conv_dim), device=device).normal_(generator=gen) * 0.1
    return {
        "in_proj": in_proj,
        "conv_kernel": conv.to(dtype),
        "conv_bias": torch.zeros((conv_dim,), **kw),
        "A_log": torch.log(torch.arange(1, nh + 1, dtype=torch.float32, device=device)),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),  # inverse softplus, fp32
        "gated_norm": torch.zeros((d_in,), **kw),
        "out_proj": dense_init(gen, d_in, D, **kw),
    }


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """Conv state (B, K-1, conv_dim) in ``dtype`` (fp32 by default, as in
    the JAX package) and the ssm state (B, H, P, N), always fp32."""
    s, _, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.state_dim), dtype=torch.float32,
                           device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    s, d_in, nh, _ = _dims(cfg)
    gn = s.num_groups * s.state_dim
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in : d_in + d_in + 2 * gn]
    dt = zxbcdt[..., -nh:]
    return z, xBC, dt


def mamba2_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, state).  Three modes: ``state=None`` is the stateless
    forward; with a state, S > 1 is prefill (the scan also returns the final
    ssm state) and S == 1 is one decode step.  The state is written in
    place."""
    s, d_in, nh, _ = _dims(cfg)
    B, S, _ = x.shape
    G, N = s.num_groups, s.state_dim
    gn = G * N

    z, xBC, dt = _split_proj(cfg, shard(sublayer_input(x) @ p["in_proj"], DP, None, TP))
    xBC, new_conv = causal_conv1d(
        xBC, p["conv_kernel"], p["conv_bias"], None if state is None else state["conv"]
    )
    xBC = F.silu(xBC)
    # views of the conv output (row stride conv_dim): the scan reads them
    # through their strides
    xs = xBC[..., :d_in].reshape(B, S, nh, s.head_dim)
    Bm = xBC[..., d_in : d_in + gn].reshape(B, S, G, N)
    Cm = xBC[..., d_in + gn :].reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])

    if state is not None and S == 1:
        new_ssm, y = ops.ssd_decode_step(
            state["ssm"], xs[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], p["D"]
        )
        y = y[:, None]
    elif state is not None:  # prefill: one pass, the final state from the scan
        y, new_ssm = ops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk=s.chunk, return_state=True)
    else:
        y = ops.ssd_scan(xs, dt, A, Bm, Cm, p["D"], chunk=s.chunk)

    y = y.reshape(B, S, d_in)
    y = grouped_rmsnorm(y * F.silu(z), p["gated_norm"], n_groups=G, eps=cfg.rms_eps)
    out = residual_shard(y @ p["out_proj"])
    if state is not None:
        state["conv"].copy_(placed_like(new_conv, state["conv"]))
        state["ssm"].copy_(placed_like(new_ssm, state["ssm"]))
    return out, state
