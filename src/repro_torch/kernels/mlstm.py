"""Stabilized parallel mLSTM (the xLSTM matrix-memory cell): the wrapper of
the CUDA kernel ``csrc/mlstm.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``mlstm_pallas`` (``repro/kernels/
mlstm_kernel.py``) and of the CPU paths behind
``repro.kernels.ops.mlstm_parallel``.  The source note in the ``.cu`` file
says what bounds it on the H100 and how the design answers.

:func:`mlstm` takes the Pallas function's arguments without ``interpret``
and without the block sizes (the kernel's tiles are its own).  It
dispatches on the tensor's device: a CPU tensor goes to
:func:`mlstm_plain`, a CUDA tensor to the kernel, anything the kernel does
not take raises.  There is no fallback.  The kernel library holds two
routes, picked by dtype (:data:`ROUTES`): bf16 (the serving path) runs the
two-pass tensor-core kernels, fp32 the scalar kernel (held to the JAX
package's fp32 bar).  The bf16 route forms the weights W once into a
scratch buffer the wrapper allocates, 4 bytes per (query, key) pair; above
:data:`SCRATCH_CAP_BYTES` it runs query-row chunks (:func:`plan_chunks`).
``mlstm.launches`` counts calls that launched the kernels (one per call,
whatever the number of chunks), ``mlstm.route_launches`` splits them by
route.  Any S is taken: the kernels mask the ragged tail themselves.

Both sides get the forget-gate cumsum ``F = cumsum(log sigmoid f)`` from
:func:`gate_cumsum`, as the Pallas wrapper computes it outside its kernel,
so the kernel and the plain version see the same bits of F (and the mLSTM
block's closed-form prefill state uses the same F).

The kernels are forward-only, as the Pallas kernel is (the JAX package has
no backward kernel).  Training reaches them through
:class:`~._build.PlainBackwardFn` (``ops.mlstm_parallel`` routes it), whose
backward recomputes the cell with :func:`mlstm_plain` and differentiates
that; the wrapper itself raises when autograd would need a gradient
through it.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .ref import mlstm_reference

NEG_INF = -1e30  # the Pallas kernels' masked-logit marker
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM_MULTIPLE = 64  # D: any multiple of the kernel's contraction chunk
ROUTES = {torch.float32: "scalar", torch.bfloat16: "mma"}  # the kernels each dtype runs
BLOCK = 64  # query and key rows of the bf16 kernels' tiles
SCRATCH_CAP_BYTES = 256 << 20  # the bf16 route's W scratch, per chunk of query rows (read per call)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = {
    "mlstm_launch": [_P] * 6 + [_I] * 4 + [_L] * 9 + [_I, _F, _P],
    "mlstm_stabilizer_launch": [_P] * 3 + [_I] * 3 + [_P],
    "mlstm_bf16_chunk_launch": [_P] * 10 + [_I] * 4 + [_L] * 9 + [_F, _I, _I, _P],
}


def _lib(name: str):
    fn = getattr(_build.load("mlstm"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def chunk_scratch_bytes(bh: int, a: int, b: int) -> int:
    """Bytes of the bf16 route's scratch for query rows [a, b) of ``bh``
    heads: W's hi and lo bf16 halves over rows [a, b') and keys [0, b'),
    and the fp32 row sums of each key block, with b' = b rounded up to
    :data:`BLOCK`."""
    bp = -(-b // BLOCK) * BLOCK
    return 4 * bh * (bp - a) * (bp + bp // BLOCK)


def plan_chunks(bh: int, S: int, cap: int) -> List[Tuple[int, int]]:
    """Query-row chunks [a, b) for the bf16 route: in order, covering
    [0, S), every boundary but S a multiple of :data:`BLOCK`, each as long
    as its scratch stays within ``cap`` (one chunk where it all fits).
    Raises if one block of rows alone exceeds ``cap``."""
    chunks, a = [], 0
    while a < S:
        b = min(S, a + BLOCK)
        if chunk_scratch_bytes(bh, a, b) > cap:
            raise ValueError(f"mlstm scratch cap {cap} B is below one block of "
                             f"{BLOCK} rows ({chunk_scratch_bytes(bh, a, b)} B)")
        while b < S and chunk_scratch_bytes(bh, a, min(S, b + BLOCK)) <= cap:
            b = min(S, b + BLOCK)
        chunks.append((a, b))
        a = b
    return chunks


def gate_cumsum(f_gate: torch.Tensor) -> torch.Tensor:
    """F = cumsum over S of log sigmoid(f), fp32 (B, S, H), contiguous.
    The scan runs along the last dim of a (B, H, S) copy: on the card a
    scan over the middle dim of a (B, S, H) tensor with few heads is an
    order of magnitude slower (CUDA's outer-dim scan); the sums and their
    order are the same."""
    ls = F.logsigmoid(f_gate.float().transpose(1, 2).contiguous())
    return torch.cumsum(ls, dim=-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# plain version: the reference for short S, the blockwise scan above that
# ---------------------------------------------------------------------------

def _mlstm_chunked(q, k, v, i_gate, f_gate, block_k: int):
    """Blockwise stabilized mLSTM with running (m, l, acc), the algorithm of
    ``repro.kernels.ops._mlstm_chunked_jnp``; S a multiple of ``block_k``.
    Key block j only touches query rows t >= j * block_k: the rows above
    would add exact zeros (their mask is empty), so they are not formed."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    Fc = gate_cumsum(f_gate)
    ig = i_gate.float()
    qf = q.float() * scale
    pos = torch.arange(S, device=q.device)
    m = torch.full((B, S, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    for r0 in range(0, S, block_k):
        blk = slice(r0, r0 + block_k)
        kb, vb, fb, ib = k[:, blk].float(), v[:, blk].float(), Fc[:, blk], ig[:, blk]
        mask = (pos[blk][None, :] <= pos[r0:, None])[None, :, :, None]  # (1,t,s,1)
        dmat = Fc[:, r0:, None, :] - fb[:, None, :, :] + ib[:, None, :, :]  # (B,t,s,H)
        dmat = torch.where(mask, dmat, NEG_INF)
        m_old = m[:, r0:]
        m_new = torch.maximum(m_old, dmat.amax(dim=2))
        dexp = torch.where(mask, torch.exp(dmat - m_new[:, :, None, :]), 0.0)
        w = torch.einsum("bqhd,bshd->bqsh", qf[:, r0:], kb) * dexp
        corr = torch.exp(m_old - m_new)
        # rows [r0:) take the new running values out of place (autograd
        # saves the old ones: a train step differentiates through here)
        l = torch.cat([l[:, :r0], l[:, r0:] * corr + w.sum(dim=2)], dim=1)
        acc = torch.cat(
            [acc[:, :r0], acc[:, r0:] * corr[..., None] + torch.einsum("bqsh,bshd->bqhd", w, vb)],
            dim=1)
        m = torch.cat([m[:, :r0], m_new], dim=1)
    denom = torch.maximum(l.abs(), torch.exp(-m))
    return (acc / denom[..., None]).to(q.dtype)


def mlstm_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, S, H)
    f_gate: torch.Tensor,  # (B, S, H)
    *,
    block_k: int = 2048,
) -> torch.Tensor:
    """What ``repro.kernels.ops.mlstm_parallel`` computes off the TPU: the
    reference for S <= 256, else the blockwise scan with ``block_k`` (or,
    when S is not a multiple of it, the largest power of two <= 128 that
    divides S)."""
    S = q.shape[1]
    if S <= 256:
        return mlstm_reference(q, k, v, i_gate, f_gate)
    if S % block_k:
        block_k = max(s for s in (128, 64, 32, 16, 8, 4, 2, 1) if S % s == 0)
    return _mlstm_chunked(q, k, v, i_gate, f_gate, min(block_k, S))


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _check(q, k, v, i_gate, f_gate):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, S, H, D = q.shape
    if i_gate.shape != (B, S, H) or f_gate.shape != (B, S, H):
        raise ValueError(f"gates i{tuple(i_gate.shape)} f{tuple(f_gate.shape)}, "
                         f"expected {(B, S, H)}")
    if min(B, S, H) < 1 or D < 1 or D % HEAD_DIM_MULTIPLE:
        raise ValueError(f"head_dim {D} not a multiple of {HEAD_DIM_MULTIPLE}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} (must match)")
    if not (i_gate.is_floating_point() and f_gate.is_floating_point()):
        raise TypeError(f"gate dtypes {i_gate.dtype}, {f_gate.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("i_gate", i_gate), ("f_gate", f_gate)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        es = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be contiguous")
        if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must be 16-byte aligned")


def mlstm(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    i_gate: torch.Tensor,  # (B, S, H)
    f_gate: torch.Tensor,  # (B, S, H)
) -> torch.Tensor:
    """Stabilized parallel mLSTM -> (B, S, H, D) in q's dtype.  q, k and v
    are read through their strides (the last dim contiguous)."""
    if q.device.type == "cpu":
        return mlstm_plain(q, k, v, i_gate, f_gate)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm: unsupported device {q.device}")
    _build.no_backward("mlstm", q, k, v, i_gate, f_gate)
    _check(q, k, v, i_gate, f_gate)
    B, S, H, D = q.shape
    Fc = gate_cumsum(f_gate)
    ig = i_gate.float().contiguous()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
               v.stride(0), v.stride(1), v.stride(2))
    scale = 1.0 / math.sqrt(D)
    route = ROUTES[q.dtype]
    if route == "scalar":
        _raise_on(_lib("mlstm_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), Fc.data_ptr(), ig.data_ptr(),
            out.data_ptr(), B, S, H, D, *strides, _DTYPES[q.dtype], scale, stream,
        ))
    else:
        chunks = plan_chunks(B * H, S, SCRATCH_CAP_BYTES)
        m = torch.empty((B * H, S), dtype=torch.float32, device=q.device)
        _raise_on(_lib("mlstm_stabilizer_launch")(
            Fc.data_ptr(), ig.data_ptr(), m.data_ptr(), B, S, H, stream))
        scratch = torch.empty(max(chunk_scratch_bytes(B * H, a, b) for a, b in chunks),
                              dtype=torch.uint8, device=q.device)
        for a, b in chunks:
            bp = -(-b // BLOCK) * BLOCK
            n_w = B * H * (bp - a) * bp  # bf16 elements of each of W_hi, W_lo
            _raise_on(_lib("mlstm_bf16_chunk_launch")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), Fc.data_ptr(), ig.data_ptr(),
                m.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 2 * n_w,
                scratch.data_ptr() + 4 * n_w, out.data_ptr(), B, S, H, D, *strides, scale,
                a, b, stream,
            ))
    mlstm.launches += 1
    mlstm.route_launches[route] += 1
    return out


def _raise_on(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"mlstm kernel launch failed: CUDA error {rc}")


mlstm.launches = 0
mlstm.route_launches = {"scalar": 0, "mma": 0}
