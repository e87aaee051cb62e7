"""Memory-efficient (vocab-chunked) cross-entropy (port of
`repro.train.fused_ce`).

The plain LM loss materialises fp32 logits (N, V); for llama3-8b that is
N x 128256 x 4 bytes.  This computes

    nll_t = logsumexp_V(h_t W) - (h_t W)[y_t]

over vocab chunks of ``vocab_chunk`` columns with running (max, sum)
online-logsumexp statistics and a gold-logit accumulator, as the JAX scan
does; the padded tail of the last chunk is masked to -1e30.  The backward
pass recomputes each chunk's (N, c) logits (JAX checkpoints the scan body
with policy ``nothing``) and never holds (N, V): per chunk the logits'
gradient is ``dnll * (softmax - onehot)`` through the softcap's derivative.
The gold logit is a gather in the forward and a compare against the label
in the backward, so no scatter (no atomics) runs and the gradient is the
same bits on every run.  Plain PyTorch: the JAX package has no kernel for
it.  ``dh`` is accumulated over the chunks in fp32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.util import is_dtensor

IGNORE = -1
NEG = -1e30


def _chunk_logits(h, W, off, c, cap):
    """fp32 (N, c) logits of columns [off, off + c), softcapped, the
    columns past V at -1e30."""
    w = W[:, off : off + c]
    raw = (h @ w).to(torch.float32)
    logits = cap * torch.tanh(raw / cap) if cap else raw
    if w.shape[1] < c:  # the padded tail of the last chunk
        logits = F.pad(logits, (0, c - w.shape[1]), value=NEG)
    return logits


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, W, labels, cap, c):
        N, V = h.shape[0], W.shape[1]
        mask = labels != IGNORE
        safe = torch.where(mask, labels, 0)
        m = torch.full((N,), NEG, dtype=torch.float32, device=h.device)
        s = torch.zeros((N,), dtype=torch.float32, device=h.device)
        gold = torch.zeros((N,), dtype=torch.float32, device=h.device)
        for off in range(0, V, c):
            logits = _chunk_logits(h, W, off, c, cap)
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=1)
            in_chunk = (safe >= off) & (safe < off + c)
            idx = torch.clamp(safe - off, 0, c - 1)
            g = torch.gather(logits, 1, idx[:, None])[:, 0]
            gold = gold + torch.where(in_chunk, g, 0.0)
            m = m_new
        lse = torch.log(s) + m
        nll = torch.where(mask, lse - gold, 0.0)
        count = mask.sum()
        ctx.save_for_backward(h, W, safe, mask, lse)
        ctx.cap, ctx.c = cap, c
        ctx.mark_non_differentiable(count)
        return nll.sum(), count

    @staticmethod
    def backward(ctx, g_nll, _g_count):
        h, W, safe, mask, lse = ctx.saved_tensors
        cap, c = ctx.cap, ctx.c
        V = W.shape[1]
        dnll = torch.where(mask, g_nll.to(torch.float32), 0.0)  # (N,)
        need_h, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device) if need_h else None
        dW = torch.empty_like(W) if need_w else None
        cols = torch.arange(c, device=h.device)
        for off in range(0, V, c):
            w = W[:, off : off + c]
            cw = w.shape[1]
            raw = (h @ w).to(torch.float32)
            z = cap * torch.tanh(raw / cap) if cap else raw
            p = torch.exp(z - lse[:, None])
            onehot = (safe[:, None] - off) == cols[None, :cw]
            dz = dnll[:, None] * (p - onehot.to(torch.float32))
            if cap:
                t = z / cap
                dz = dz * (1 - t * t)
            dz = dz.to(h.dtype)
            if need_h:
                dh += (dz @ w.T).to(torch.float32)
            if need_w:
                dW[:, off : off + cw] = (h.T @ dz).to(W.dtype)
        return (None if dh is None else dh.to(h.dtype)), dW, None, None, None


def fused_cross_entropy(
    h: torch.Tensor,  # (N, D) final hidden states (already normed)
    W: torch.Tensor,  # (D, V) head weight
    labels: torch.Tensor,  # (N,) int, IGNORE = masked
    *,
    final_softcap: Optional[float] = None,
    vocab_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (summed nll fp32, token count); never materialises (N, V).
    DTensor inputs run it on each rank's rows (:func:`_on_local_rows`)."""
    c = min(vocab_chunk, W.shape[1])
    if any(is_dtensor(t) for t in (h, W, labels)):
        return _on_local_rows(h, W, labels, final_softcap or None, c)
    return _FusedCE.apply(h, W, labels, final_softcap or None, c)


def _on_local_rows(h, W, labels, cap, c):
    """The fused CE on a mesh: each rank's rows of ``h`` and ``labels``
    (split as ``h``'s first dim is, over whole mesh dims) against the whole
    head, through ``local_map``; both sums are partial over the mesh dims
    that split the rows, and so is the head's gradient.  DTensor cannot run
    the chunk loop's gathers and in-place sums on sharded operands."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t.device_mesh for t in (h, W, labels) if isinstance(t, DTensor))
    whole = [Replicate()] * mesh.ndim
    split = [isinstance(h, DTensor) and type(p) is Shard and p.dim == 0 for p in
             (h.placements if isinstance(h, DTensor) else whole)]
    rows = [Shard(0) if s else Replicate() for s in split]
    sums = [Partial() if s else Replicate() for s in split]
    fn = local_map(lambda h, W, y: _FusedCE.apply(h, W, y, cap, c), (sums, sums),
                   (rows, whole, rows), (rows, sums, rows), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(*(t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, whole,
                                                                    run_check=False)
                for t in (h, W, labels)))
