"""Dispatch layer: models call these.

The rule is by the tensor's device, with no fallback: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(or the call raises).  Each kernel name here is the kernel module's
wrapper, which makes that choice itself; tests that want the plain version
on any device call ``ref`` (or the kernel modules' ``*_plain``) directly.
``ssd_decode_step`` and ``mlstm_decode_step`` are plain PyTorch on every
device: the JAX package has no kernel for them either.

A CUDA call that autograd must differentiate (grad mode on and an input
requiring grad: the train step) of flash attention, the SSD scan or the
mLSTM runs the kernel inside ``_build.PlainBackwardFn``, whose backward
recomputes through the kernel's plain version; every other call goes to the wrapper as it is,
so serving launches are unchanged.  The SSD scan under autograd returns y
only (a ``return_state`` request raises); decode attention and the
wrappers called directly raise under autograd.  On the CPU the plain
versions are differentiable as they stand.

Attention whose value head dim differs from the query's (MLA: Dqk 192,
Dv 128) is sent to plain PyTorch by shape on every device, as the JAX
dispatch sends it to its jnp paths: the naive reference up to Sq * Sk <=
256^2, the chunked online-softmax scan above.  This is a rule on the
shape, not a fallback: the CUDA kernel takes Dv == D only and raises
otherwise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import ref
from ._build import PlainBackwardFn
from .decode_attention import decode_attention
from .flash_attention import flash_attention as flash_attention_kernel
from .flash_attention import flash_attention_plain
from .mamba2_ssd import ssd as ssd_kernel
from .mamba2_ssd import ssd_plain
from .mlstm import mlstm as mlstm_kernel
from .mlstm import mlstm_plain

__all__ = [
    "attention_chunked", "decode_attention", "flash_attention", "mlstm_decode_step",
    "mlstm_parallel", "ssd_decode_step", "ssd_scan",
]

NEG_INF = -1e30


def _grad_on_card(*tensors) -> bool:
    """A CUDA call that autograd must differentiate: grad mode on and an
    input requiring grad."""
    return (tensors[0].device.type == "cuda" and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors))


def _launch(kernel, plain, kw, *tensors):
    """``kernel(*tensors, **kw)``, inside ``PlainBackwardFn`` (the plain
    version's derivative) where autograd must differentiate a CUDA call."""
    if _grad_on_card(*tensors):
        return PlainBackwardFn.apply(kernel, plain, kw, *tensors)
    return kernel(*tensors, **kw)


def attention_chunked(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, Dv)
    *,
    causal: bool,
    window: Optional[int],
    logit_cap: Optional[float],
    q_offset: int,
    scale: float,
    block_k: int = 4096,
) -> torch.Tensor:
    """Online-softmax attention, a loop over KV blocks of ``block_k`` (port
    of the JAX package's `_attention_chunked_jnp`).  Never materialises
    (Sq, Sk); Dv may differ from D.  q is scaled and the scores taken in
    q's dtype, then fp32 to the end; the output takes q's dtype."""
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    Dv = v.shape[-1]
    G = H // K
    block_k = min(block_k, Sk)
    pad = (-Sk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q * scale).reshape(B, Sq, K, G, D)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, Sq, K, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, K, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, K, G, Dv), dtype=torch.float32, device=q.device)
    for jb in range((Sk + pad) // block_k):
        kblk = k[:, jb * block_k : (jb + 1) * block_k]
        vblk = v[:, jb * block_k : (jb + 1) * block_k]
        s = torch.einsum("bqkgd,bskd->bqkgs", qg, kblk).float()
        if logit_cap is not None and logit_cap > 0:
            s = logit_cap * torch.tanh(s / logit_cap)
        k_pos = jb * block_k + torch.arange(block_k, device=q.device)
        mask = (k_pos < Sk)[None, :].expand(Sq, block_k)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None and window > 0:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgs,bskd->bqkgd", p, vblk.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, Sq, H, D) x (B, Sk, K, D) x (B, Sk, K, Dv) -> (B, Sq, H, Dv) in
    q's dtype.  Dv == D: the kernel's wrapper (the CUDA kernel on a CUDA
    tensor, through ``PlainBackwardFn`` where autograd needs its
    gradient; its plain version on a CPU one).  Dv != D: plain PyTorch on
    every device, the reference up to Sq * Sk <= 256^2, else the chunked
    scan."""
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    if v.shape[-1] == q.shape[-1]:
        return _launch(flash_attention_kernel, flash_attention_plain, dict(scale=scale, **kw),
                       q, k, v)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.shape[1] * k.shape[1] <= 256 * 256:
        return ref.mha_reference(q, k, v, scale=scale, **kw)
    return attention_chunked(q, k, v, scale=scale, **kw)


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32
    A: torch.Tensor,  # (H,) fp32
    Bmat: torch.Tensor,  # (B, S, G, N)
    Cmat: torch.Tensor,  # (B, S, G, N)
    D: Optional[torch.Tensor] = None,  # (H,) fp32
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """The SSD scan from a zero state -> y, and with ``return_state`` also
    the fp32 final state: the kernel's wrapper (the CUDA kernel on a CUDA
    tensor, through ``PlainBackwardFn`` where autograd needs its gradient;
    its plain version on a CPU one).  Under autograd on the card the state
    is refused: it would come back with no gradient."""
    if return_state and _grad_on_card(x, dt, A, Bmat, Cmat, D):
        raise RuntimeError("ssd: the final state has no gradient; under autograd the scan "
                           "returns y only (call it under torch.no_grad() for the state)")
    return _launch(ssd_kernel, ssd_plain, dict(chunk=chunk, return_state=return_state),
                   x, dt, A, Bmat, Cmat, D)


def mlstm_parallel(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, S, H)
    f_gate: torch.Tensor,  # (B, S, H)
) -> torch.Tensor:
    """The stabilized parallel mLSTM -> (B, S, H, D) in q's dtype: the
    kernel's wrapper (the CUDA kernels on a CUDA tensor, through
    ``PlainBackwardFn`` where autograd needs its gradient; its plain
    version on a CPU one)."""
    return _launch(mlstm_kernel, mlstm_plain, {}, q, k, v, i_gate, f_gate)


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N) fp32
    x_t: torch.Tensor,  # (B, H, P)
    dt_t: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    B_t: torch.Tensor,  # (B, G, N)
    C_t: torch.Tensor,  # (B, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step -> (new fp32 state, y (B, H, P) in x's dtype)."""
    rep = x_t.shape[1] // B_t.shape[1]
    Bh = B_t.float().repeat_interleave(rep, dim=1)  # (B,H,N)
    Ch = C_t.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(A.float()[None, :] * dt_t.float())  # (B,H)
    state = state * decay[..., None, None] + (
        (dt_t.float()[..., None] * x_t.float())[..., None] * Bh[:, :, None, :]
    )
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    if D is not None:
        y = y + x_t.float() * D.float()[None, :, None]
    return state, y.to(x_t.dtype)


def mlstm_decode_step(
    c: torch.Tensor,  # (B, H, D, D) fp32 matrix memory, contiguous
    n: torch.Tensor,  # (B, H, D) fp32 normalizer
    m: torch.Tensor,  # (B, H) fp32 stabilizer
    q_t: torch.Tensor,  # (B, H, D)
    k_t: torch.Tensor,
    v_t: torch.Tensor,
    i_t: torch.Tensor,  # (B, H)
    f_t: torch.Tensor,  # (B, H)
) -> torch.Tensor:
    """O(1) recurrent mLSTM step; updates (c, n, m) in place and returns h
    (B, H, D) in q's dtype.  ``ref.mlstm_recurrent_step`` is the same step
    with full-size temporaries; here c is scaled in place and takes one
    rank-1 update, (i v) k^T, so a step moves c through memory three times
    (scale, update, the read for h) and allocates nothing of its size."""
    B, H, D = q_t.shape
    logf = F.logsigmoid(f_t.float())
    i_t = i_t.float()
    m_new = torch.maximum(logf + m, i_t)
    fgate = torch.exp(logf + m - m_new)
    igate = torch.exp(i_t - m_new)
    kf = k_t.float()
    qs = q_t.float() * (1.0 / math.sqrt(D))
    c.mul_(fgate[..., None, None])
    cb = c.view(B * H, D, D)
    cb.baddbmm_((v_t.float() * igate[..., None]).reshape(B * H, D, 1), kf.reshape(B * H, 1, D))
    n.mul_(fgate[..., None]).add_(igate[..., None] * kf)
    m.copy_(m_new)
    h_num = torch.bmm(cb, qs.reshape(B * H, D, 1)).view(B, H, D)
    h_den = torch.maximum((n * qs).sum(dim=-1).abs(), torch.exp(-m_new))
    return (h_num / h_den[..., None]).to(q_t.dtype)
