"""Dispatch layer: models call these.

The rule is by the tensor's device, with no fallback: a CPU tensor goes to
the plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(or the call raises).  Each kernel name here is the kernel module's
wrapper, which makes that choice itself; tests that want the plain version
on any device call ``ref`` (or the kernel modules' ``*_plain``) directly.
``ssd_decode_step``, ``mlstm_decode_step`` and ``slstm_recurrence`` are plain
PyTorch on every device: the JAX package has no kernel for them either.

A CUDA call that autograd must differentiate (grad mode on and an input
requiring grad: the train step) of flash attention, the SSD scan or the
mLSTM runs the kernel inside ``_build.PlainBackwardFn``, whose backward
recomputes through the kernel's plain version; every other call goes to the wrapper as it is,
so serving launches are unchanged.  The SSD scan under autograd returns y
only (a ``return_state`` request raises); decode attention and the
wrappers called directly raise under autograd.  On the CPU the plain
versions are differentiable as they stand.

DTensor inputs (a sharded run, `models.sharding`) run each kernel, or on a
CPU shard its plain version, on every rank's local shards through
``local_map`` (`_local_launch` says which placements stay local): the
CUDA wrappers take raw pointers, so a DTensor never reaches them, and a
DTensor on the card never takes the plain version.

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

from repro_torch.util import is_dtensor, observer

from . import ref
from ._build import PlainBackwardFn
from .decode_attention import decode_attention as decode_attention_kernel
from .flash_attention import flash_attention as flash_attention_kernel
from .flash_attention import flash_attention_plain
from .mamba2_ssd import ssd as ssd_kernel
from .mamba2_ssd import ssd_plain
from .mlstm import mlstm as mlstm_kernel
from .mlstm import mlstm_plain

__all__ = [
    "attention_chunked", "decode_attention", "flash_attention", "mlstm_decode_step",
    "mlstm_parallel", "slstm_recurrence", "slstm_scan", "ssd_decode_step", "ssd_scan",
]

NEG_INF = -1e30


def _grad_on_card(*tensors) -> bool:
    """A CUDA call that autograd must differentiate: grad mode on and an
    input requiring grad."""
    return (tensors[0].device.type == "cuda" and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in tensors))


# The role of each dim of each kernel's inputs and outputs, as
# `_local_launch` reads them: "b" batch, "h" heads, "g" grouped heads
# (attention's KV heads, the SSD's B/C groups: head i reads group
# i // (H / G)); None is a dim the kernel reduces over or runs along.
_BSHD = ("b", None, "h", None)
_BSGD = ("b", None, "g", None)
_BSH = ("b", None, "h")
_BH_ = ("b", "h", None)
_ROLES = {
    "flash_attention": ((_BSHD, _BSGD, _BSGD), (_BSHD,)),
    "decode_attention": ((("b", "h", None), _BSGD, _BSGD, ("b",)), (("b", "h", None),)),
    "ssd": ((_BSHD, _BSH, ("h",), _BSGD, _BSGD, ("h",)), (_BSHD, ("b", "h", None, None))),
    "mlstm": ((_BSHD, _BSHD, _BSHD, _BSH, _BSH), (_BSHD,)),
    "ssd_decode_step": ((("b", "h", None, None), ("b", "h", None), ("b", "h"), ("h",),
                         ("b", "g", None), ("b", "g", None), ("h",)),
                        (("b", "h", None, None), ("b", "h", None))),
    "slstm_recurrence": ((("b", None, "h", None, None), ("h", None, None)) + (_BH_,) * 4,
                         (_BSHD,) + (_BH_,) * 4),
}


def local_split(shapes, roles, lead_split, sizes):
    """Which mesh axes a kernel keeps split on its local shards: the lead
    input's ``lead_split`` ({axis: "b" or "h"}, the role of the dim each
    axis splits) kept where it divides every input's dim of that role
    (``shapes`` and ``roles`` per input, ``sizes`` {axis: size}).  Grouped
    heads split with the heads where the axes divide them; where they do
    not but each rank's heads read one group (GQA with tp above the KV
    heads) they stay whole and each rank takes its own group locally.
    -> (``{axis: role}``, whole_groups), as `_local_launch` reads
    DTensor placements."""
    split = dict(lead_split)

    def ways(role) -> int:
        return math.prod(sizes[a] for a, r in split.items() if r == role)

    for role in ("b", "h"):
        if any(s[r.index(role)] % ways(role) for s, r in zip(shapes, roles) if role in r):
            split = {a: r for a, r in split.items() if r != role}
    whole_groups = False
    groups = [s[r.index("g")] for s, r in zip(shapes, roles) if "g" in r]
    if "h" in split.values() and groups:
        H, G, n = shapes[0][roles[0].index("h")], groups[0], ways("h")
        if G % n:
            if (H // G) % (H // n):
                split = {a: r for a, r in split.items() if r != "h"}
            else:
                whole_groups = True
    return split, whole_groups


def split_dim(r, axis, split, whole_groups) -> Optional[int]:
    """The dim of an input or output with roles ``r`` that ``axis`` splits
    on the local call, or None where it is replicated."""
    role = split.get(axis)
    if role is None:
        return None
    if role in r:
        return r.index(role)
    if role == "h" and "g" in r and not whole_groups:
        return r.index("g")
    return None


def _local_launch(call, name: str, tensors, n_out: int = 1):
    """``call(*tensors)`` on each rank's local shards through ``local_map``,
    for inputs that are DTensors, so each kernel runs on its shard as it
    runs on one card.

    The first input (q, x) decides what stays split (:func:`local_split`):
    batch over the mesh dims that shard its batch, heads over those that
    shard its heads.  Every other dim is replicated first by
    ``local_map``'s redistribution: attention's Sq and Sk, a
    sequence-sharded decode cache, the SSD's and the mLSTM's sequence
    (each kernel reduces or scans along it), and any partial sum.  An
    input whole along a split it does not take (the SSD's A and D under a
    batch split, a group taken per rank) gets a partial gradient from each
    rank."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    in_roles, out_roles = _ROLES[name]
    present = [i for i, t in enumerate(tensors) if t is not None]
    mesh = next(t.device_mesh for t in tensors if isinstance(t, DTensor))
    rep = [Replicate()] * mesh.ndim
    args = [t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, rep, run_check=False)
            for t in (tensors[i] for i in present)]
    roles = [in_roles[i] for i in present]

    lead, lead_roles = args[0], roles[0]
    split, whole_groups = local_split(
        [tuple(t.shape) for t in args], roles,
        {m: lead_roles[p.dim] for m, p in enumerate(lead.placements)
         if isinstance(p, Shard) and lead_roles[p.dim] in ("b", "h")},
        {m: mesh.size(m) for m in range(mesh.ndim)})
    group = None  # the KV group each rank takes, where groups stay whole
    if whole_groups:
        H, G = lead.shape[lead_roles.index("h")], next(
            t.shape[r.index("g")] for t, r in zip(args, roles) if "g" in r)
        h_dims = sorted(m for m, r in split.items() if r == "h")
        coord, rank, n = mesh.get_coordinate(), 0, 1
        for m in h_dims:
            rank, n = rank * mesh.size(m) + coord[m], n * mesh.size(m)
        group = rank * (H // n) // (H // G)

    def places(r):
        dims = [split_dim(r, m, split, whole_groups) for m in range(mesh.ndim)]
        return [Replicate() if d is None else Shard(d) for d in dims]

    in_pl = tuple(places(r) for r in roles)
    grad_pl = tuple([Partial() if m in split and isinstance(p, Replicate) else p
                     for m, p in enumerate(pl)] for pl in in_pl)
    out_pl = tuple(places(r) for r in out_roles[:n_out])

    def local_call(*local):
        full = [None] * len(tensors)
        for i, x, r in zip(present, local, roles):
            full[i] = x if group is None or "g" not in r else x.narrow(r.index("g"), group, 1)
        return call(*full)

    return local_map(local_call, out_pl if n_out > 1 else out_pl[0], in_pl, grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _launch(kernel, plain, kw, *tensors, name: str, n_out: int = 1):
    """``kernel(*tensors, **kw)``, inside ``PlainBackwardFn`` (the plain
    version's derivative) where autograd must differentiate a CUDA call;
    DTensor inputs run it on their local shards (:func:`_local_launch`)."""
    if any(is_dtensor(t) for t in tensors):
        return _local_launch(lambda *local: _launch(kernel, plain, kw, *local, name=name),
                             name, tensors, n_out)

    def run():
        if plain is not None and _grad_on_card(*tensors):
            return PlainBackwardFn.apply(kernel, plain, kw, *tensors)
        return kernel(*tensors, **kw)

    obs = observer()
    return run() if obs is None else obs.launch(name, tensors, kw, run)


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
    scan; DTensors run it on each rank's local shards (`_local_launch`),
    as the kernel runs."""
    kw = dict(causal=causal, window=window, logit_cap=logit_cap, q_offset=q_offset)
    if v.shape[-1] == q.shape[-1]:
        return _launch(flash_attention_kernel, flash_attention_plain, dict(scale=scale, **kw),
                       q, k, v, name="flash_attention")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])

    def plain(q, k, v):
        if q.shape[1] * k.shape[1] <= 256 * 256:
            return ref.mha_reference(q, k, v, scale=scale, **kw)
        return attention_chunked(q, k, v, scale=scale, **kw)

    if any(is_dtensor(t) for t in (q, k, v)):  # on local shards, as a kernel runs
        return _local_launch(plain, "flash_attention", (q, k, v))
    return plain(q, k, v)


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, K, D)
    v_cache: torch.Tensor,  # (B, S, K, D)
    cache_len: torch.Tensor,  # (B,) int32
    **kw,
) -> torch.Tensor:
    """One query token per row against its cache: the kernel's wrapper (the
    CUDA kernel on a CUDA tensor, its plain version on a CPU one; it raises
    under autograd).  ``kw``: ``logit_cap``, ``window``, ``scale``."""
    return _launch(decode_attention_kernel, None, kw, q, k_cache, v_cache, cache_len,
                   name="decode_attention")


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
                   x, dt, A, Bmat, Cmat, D, name="ssd", n_out=2 if return_state else 1)


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
    return _launch(mlstm_kernel, mlstm_plain, {}, q, k, v, i_gate, f_gate, name="mlstm")


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N) fp32
    x_t: torch.Tensor,  # (B, H, P)
    dt_t: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    B_t: torch.Tensor,  # (B, G, N)
    C_t: torch.Tensor,  # (B, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(1) recurrent step -> (new fp32 state, y (B, H, P) in x's dtype).
    DTensor inputs run it on each rank's rows and heads (`_local_launch`):
    DTensor cannot flatten the sharded (B, H) of its einsum (torch 2.11)."""
    args = (state, x_t, dt_t, A, B_t, C_t, D)
    if any(is_dtensor(t) for t in args):
        return _local_launch(_ssd_decode_step, "ssd_decode_step", args, n_out=2)
    return _ssd_decode_step(*args)


def _ssd_decode_step(state, x_t, dt_t, A, B_t, C_t, D=None):
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


def slstm_recurrence(
    gx: torch.Tensor,  # (B, S, nh, hd, 4) fp32 input gate pre-activations
    r: torch.Tensor,  # (nh, hd, 4 hd) recurrent weight, its last two axes flattened
    c: torch.Tensor,  # (B, nh, hd) fp32 carry: cell, normalizer, stabilizer, hidden
    n: torch.Tensor,
    m: torch.Tensor,
    h: torch.Tensor,
):
    """The sLSTM recurrence, one step per token -> (hidden states (B, S, nh,
    hd), final c, n, m, h).  DTensor inputs run it on each rank's rows and
    heads (`_local_launch`), one redistribution for the whole scan: DTensor
    has no rule for its log-sigmoid's backward (torch 2.13)."""
    args = (gx, r, c, n, m, h)
    if any(is_dtensor(t) for t in args):
        return _local_launch(_slstm_recurrence, "slstm_recurrence", args, n_out=5)
    return _slstm_recurrence(*args)


def _slstm_recurrence(gx, r, c, n, m, h):
    carry, hs = (c, n, m, h), []
    for t in range(gx.shape[1]):
        carry = _slstm_step(r, carry, gx[:, t])
        hs.append(carry[3])
    return (torch.stack(hs, dim=1),) + carry


def _slstm_step(r, carry, gx_t):
    """One step: ``r`` (nh, hd, 4 hd), ``gx_t`` (B, nh, hd, 4)."""
    c, n, m, h = carry
    B, nh, hd = h.shape
    rec = torch.bmm(h.transpose(0, 1), r).transpose(0, 1).reshape(B, nh, hd, 4)
    pre = gx_t + rec
    i_t, f_t = pre[..., 0], pre[..., 1]
    z_t = torch.tanh(pre[..., 2])
    o_t = torch.sigmoid(pre[..., 3])
    logf = F.logsigmoid(f_t)
    m_new = torch.maximum(logf + m, i_t)
    igate = torch.exp(i_t - m_new)
    fgate = torch.exp(logf + m - m_new)
    c_new = fgate * c + igate * z_t
    n_new = fgate * n + igate
    h_new = o_t * c_new / torch.clamp_min(n_new, 1.0)
    return c_new, n_new, m_new, h_new


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


# the sLSTM scan over (B, S, H, D) inputs and an (H, D, D, 4) recurrent
# weight, JAX's ``ops.slstm_scan``; the xLSTM block runs `slstm_recurrence`
slstm_scan = ref.slstm_reference
