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
not take raises.  There is no fallback.  ``mlstm.launches`` counts kernel
launches.  Any S is taken: the kernel masks the ragged tail itself.

Both sides get the forget-gate cumsum ``F = cumsum(log sigmoid f)`` from
:func:`gate_cumsum`, as the Pallas wrapper computes it outside its kernel,
so the kernel and the plain version see the same bits of F (and the mLSTM
block's closed-form prefill state uses the same F).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _build
from .ref import mlstm_reference

NEG_INF = -1e30  # the Pallas kernels' masked-logit marker
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM_MULTIPLE = 64  # D: any multiple of the kernel's contraction chunk

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = [_P] * 6 + [_I] * 4 + [_L] * 9 + [_I, _F, _P]


def _lib():
    lib = _build.load("mlstm")
    fn = lib.mlstm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def gate_cumsum(f_gate: torch.Tensor) -> torch.Tensor:
    """F = cumsum over S of log sigmoid(f), fp32 (B, S, H), contiguous."""
    return torch.cumsum(F.logsigmoid(f_gate.float()), dim=1).contiguous()


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
        l[:, r0:] = l[:, r0:] * corr + w.sum(dim=2)
        acc[:, r0:] = acc[:, r0:] * corr[..., None] + torch.einsum("bqsh,bshd->bqhd", w, vb)
        m[:, r0:] = m_new
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
    _check(q, k, v, i_gate, f_gate)
    B, S, H, D = q.shape
    Fc = gate_cumsum(f_gate)
    ig = i_gate.float().contiguous()
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), Fc.data_ptr(), ig.data_ptr(), out.data_ptr(),
        B, S, H, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        _DTYPES[q.dtype], 1.0 / math.sqrt(D), stream,
    )
    if rc != 0:
        raise RuntimeError(f"mlstm kernel launch failed: CUDA error {rc}")
    mlstm.launches += 1
    return out


mlstm.launches = 0
