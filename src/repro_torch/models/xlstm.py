"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, strictly recurrent), the xlstm-1.3b backbone (port of
`repro.models.xlstm`).

mLSTM block: norm -> up-projection to (x, z) at 2x width -> causal conv +
silu on x -> headwise q, k (from the conv branch) and v (from x) -> the
mLSTM cell (`ops.mlstm_parallel`: the CUDA kernel on the card, the plain
version on the CPU; one recurrent step in decode) -> group norm -> +
learnable skip of the conv branch -> gate with silu(z) -> down-projection
-> residual.

sLSTM block: norm -> causal conv + silu -> 4-gate cell with a headwise
recurrence, one step per token -> group norm -> gated FFN (proj factor
4/3) -> residual.

The head dim of the mLSTM cell is d_in / n_heads (1024 at xlstm-1.3b), not
``cfg.head_dim``.  Decode state: mLSTM (conv, C, n, m), sLSTM (conv, c, n,
m, h), all fp32, updated in place.

The JAX block gets the mLSTM state after a prompt by replaying the prompt
one recurrent step at a time; here :func:`mlstm_prefill_state` computes the
same (c, n, m) in closed form from the F and i that feed the kernel, one
batched matmul per layer (the replay, `ref.mlstm_prefill_replay`, is its
test oracle).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.mlstm import gate_cumsum

from .layers import (
    Params, _normal, causal_conv1d, dense_init, grouped_rmsnorm, rmsnorm, rmsnorm_init,
)
from .sharding import DP, TP, placed_like, reshape, residual_shard, shard, sublayer_input

State = Dict[str, torch.Tensor]


def _mdims(cfg: ModelConfig):
    x = cfg.xlstm
    d_in = int(x.proj_factor * cfg.d_model)
    nh = cfg.n_heads
    return x, d_in, nh, d_in // nh


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_block_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    x, d_in, nh, hd = _mdims(cfg)
    D = cfg.d_model
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": rmsnorm_init(D, **kw),
        "w_up": dense_init(gen, D, 2 * d_in, **kw),
        "conv_kernel": _normal((x.conv_kernel, d_in), 0.1, gen, dtype, device),
        "conv_bias": torch.zeros((d_in,), **kw),
        "w_qhw": dense_init(gen, nh, hd, hd, **kw),  # headwise
        "w_khw": dense_init(gen, nh, hd, hd, **kw),
        "w_vhw": dense_init(gen, nh, hd, hd, **kw),
        "w_igate": dense_init(gen, 3 * d_in, nh, scale=0.01, **f32),
        "w_fgate": dense_init(gen, 3 * d_in, nh, scale=0.01, **f32),
        "fgate_bias": torch.linspace(3.0, 6.0, nh, **f32),
        "igate_bias": torch.full((nh,), -10.0, **f32),
        "skip": torch.ones((d_in,), **kw),
        "gn": rmsnorm_init(d_in, **kw),
        "w_down": dense_init(gen, d_in, D, **kw),
    }


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cpu") -> State:
    x, d_in, nh, hd = _mdims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, x.conv_kernel - 1, d_in), **f32),
        "c": torch.zeros((batch, nh, hd, hd), **f32),
        "n": torch.zeros((batch, nh, hd), **f32),
        "m": torch.full((batch, nh), -1e9, **f32),
    }


def _headwise(x: torch.Tensor, w: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, S, d_in) x (nh, hd, hd) -> (B, S, nh, hd)"""
    B, S, d_in = x.shape
    return torch.einsum("bshi,hij->bshj", reshape(x, (B, S, nh, d_in // nh)), w)


def mlstm_prefill_state(
    state: State,
    k: torch.Tensor,  # (B, S, H, D)
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, S, H)
    Fc: torch.Tensor,  # (B, S, H) fp32: gate_cumsum(f_gate)
) -> None:
    """Advance (c, n, m) over a whole prompt in place, in closed form:
        m_S = max(F_S + m_0, max_s (F_S - F_s + i_s))
        c_S = e^(F_S + m_0 - m_S) c_0 + sum_s e^(F_S - F_s + i_s - m_S) v_s k_s^T
        n_S = e^(F_S + m_0 - m_S) n_0 + sum_s e^(F_S - F_s + i_s - m_S) k_s
    which is what S recurrent steps from (c_0, n_0, m_0) compute."""
    c, n, m = state["c"], state["n"], state["m"]
    B, S, H, D = k.shape
    FS = Fc[:, -1]  # (B, H)
    dec = (FS[:, None] - Fc) + i_gate.float()  # (B, S, H)
    carry = FS + m
    m_new = torch.maximum(carry, dec.amax(dim=1))
    w = torch.exp(dec - m_new[:, None])  # (B, S, H)
    g0 = torch.exp(carry - m_new)  # (B, H)
    kf = k.float()
    vw = v.float() * w[..., None]
    c.mul_(g0[..., None, None])
    c.view(B * H, D, D).baddbmm_(
        vw.permute(0, 2, 3, 1).reshape(B * H, D, S), kf.permute(0, 2, 1, 3).reshape(B * H, S, D)
    )
    n.mul_(g0[..., None]).add_(torch.einsum("bsh,bshd->bhd", w, kf))
    m.copy_(m_new)


def mlstm_block_apply(
    p: Params,
    h: torch.Tensor,  # (B, S, D) residual stream
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Three modes: ``state=None`` is the stateless forward; with a state,
    S > 1 is prefill (the cell's output from the parallel form, the final
    state in closed form) and S == 1 one recurrent step (a one-token prompt
    included, as in the JAX block).  The state is written in place."""
    _, d_in, nh, _ = _mdims(cfg)
    B, S, _ = h.shape

    up = shard(sublayer_input(rmsnorm(h, p["norm"], eps=cfg.rms_eps)) @ p["w_up"], DP, None, TP)
    xb, z = up[..., :d_in], up[..., d_in:]
    xc, new_conv = causal_conv1d(
        xb, p["conv_kernel"], p["conv_bias"], None if state is None else state["conv"]
    )
    xc = F.silu(xc)

    q = _headwise(xc, p["w_qhw"], nh)
    k = _headwise(xc, p["w_khw"], nh)
    v = _headwise(xb, p["w_vhw"], nh)
    gate_in = torch.cat([q.reshape(B, S, -1), k.reshape(B, S, -1), v.reshape(B, S, -1)],
                        dim=-1).float()
    ig = gate_in @ p["w_igate"] + p["igate_bias"]
    fg = gate_in @ p["w_fgate"] + p["fgate_bias"]

    if state is not None and S == 1:
        out = ops.mlstm_decode_step(
            state["c"], state["n"], state["m"], q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]
        )[:, None]
    else:
        out = ops.mlstm_parallel(q, k, v, ig, fg)
        if state is not None:
            mlstm_prefill_state(state, k, v, ig, gate_cumsum(fg))
    if state is not None:
        state["conv"].copy_(new_conv)

    out = grouped_rmsnorm(out.reshape(B, S, d_in), p["gn"], n_groups=nh, eps=cfg.rms_eps)
    out = out + xc * p["skip"][None, None, :]
    out = out * F.silu(z)
    return h + residual_shard(out @ p["w_down"]), state


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_block_init(gen, cfg: ModelConfig, *, dtype=torch.float32, device="cpu") -> Params:
    x = cfg.xlstm
    D, nh = cfg.d_model, cfg.n_heads
    hd = D // nh
    f = int(x.slstm_proj_factor * D)
    kw = dict(dtype=dtype, device=device)
    gates_b = torch.zeros((nh, hd, 4), dtype=torch.float32, device=device)
    gates_b[..., 1] = 3.0  # forget-gate bias
    return {
        "norm": rmsnorm_init(D, **kw),
        "conv_kernel": _normal((x.conv_kernel, D), 0.1, gen, dtype, device),
        "conv_bias": torch.zeros((D,), **kw),
        "gates_x": dense_init(gen, D, nh, hd * 4, device=device).reshape(D, nh, hd, 4),
        "gates_b": gates_b,
        "r_kernel": _normal((nh, hd, hd, 4), hd**-0.5, gen, torch.float32, device),
        "gn": rmsnorm_init(D, **kw),
        "w_gate": dense_init(gen, D, f, **kw),
        "w_up": dense_init(gen, D, f, **kw),
        "w_down": dense_init(gen, f, D, **kw),
    }


def init_slstm_state(cfg: ModelConfig, batch: int, device="cpu") -> State:
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, cfg.d_model), **f32),
        "c": torch.zeros((batch, nh, hd), **f32),
        "n": torch.zeros((batch, nh, hd), **f32),
        "m": torch.full((batch, nh, hd), -1e9, **f32),
        "h": torch.zeros((batch, nh, hd), **f32),
    }


def slstm_block_apply(
    p: Params,
    h: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    *,
    state: Optional[State] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """The recurrence runs one step per token in every mode; with a state it
    starts from it and the final (conv, c, n, m, h) is written back in
    place."""
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    B, S, D = h.shape

    xin = sublayer_input(rmsnorm(h, p["norm"], eps=cfg.rms_eps))
    xc, new_conv = causal_conv1d(
        xin, p["conv_kernel"], p["conv_bias"], None if state is None else state["conv"]
    )
    xc = F.silu(xc)
    gx = torch.einsum("bsd,dhke->bshke", xc.float(), p["gates_x"]) + p["gates_b"]

    if state is not None:
        carry = (state["c"], state["n"], state["m"], state["h"])
    else:
        z = torch.zeros((B, nh, hd), dtype=torch.float32, device=h.device)
        carry = (z, z, torch.full_like(z, -1e9), z)
    hs, *carry = ops.slstm_recurrence(gx, p["r_kernel"].reshape(nh, hd, hd * 4), *carry)
    out = hs.reshape(B, S, D).to(h.dtype)
    out = grouped_rmsnorm(out, p["gn"], n_groups=nh, eps=cfg.rms_eps)
    ff = (F.gelu(out @ p["w_gate"], approximate="tanh") * (out @ p["w_up"])) @ p["w_down"]
    if state is not None:
        state["conv"].copy_(new_conv)
        for key, val in zip(("c", "n", "m", "h"), carry):
            state[key].copy_(placed_like(val, state[key]))
    return h + residual_shard(ff), state
