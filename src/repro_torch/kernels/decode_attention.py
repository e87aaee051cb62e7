"""Decode (one-token) attention: the wrapper of the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``decode_attention_pallas``
(``repro/kernels/decode_attention.py``).  The source note in the ``.cu``
file says what bounds it on the H100 (bytes) and how the design answers.

:func:`decode_attention` dispatches on the tensor's device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, anything the kernel
does not take raises.  There is no fallback.  ``decode_attention.launches``
counts launches of the kernel pair: each call on the card runs the split
kernel and then the combine kernel, and adds one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import decode_attention_reference as decode_attention_plain

GROUPS = (1, 2, 4, 7, 8, 16)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 32  # cache rows per tile (csrc/decode_attention.cu)
_TARGET_CTAS = 4 * 132  # four CTAs on each of the H100's 132 SMs

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_L] * 8 + [_I, _I, _F, _F, _I, _I, _I, _P]


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def split_plan(B: int, K: int, S: int):
    """(splits, chunk): cut S into splits of whole tiles so that
    B*K*splits CTAs fill the card."""
    n_tiles = -(-S // _TILE)
    splits = max(1, min(-(-_TARGET_CTAS // (B * K)), n_tiles))
    chunk = -(-n_tiles // splits) * _TILE
    return -(-S // chunk), chunk


def _check(q, k_cache, v_cache, cache_len):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k_cache.shape)} v{tuple(v_cache.shape)}")
    B, H, D = q.shape
    Bc, S, K, Dc = k_cache.shape
    if Bc != B or Dc != D or S < 1 or K < 1 or H % K:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k_cache.shape)}")
    if H // K not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(f"group {H // K} / head_dim {D} not supported by the kernel")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k_cache.dtype}, v {v_cache.dtype}")
    if cache_len.dtype != torch.int32 or cache_len.shape != (B,) or not cache_len.is_contiguous():
        raise TypeError(f"cache_len must be a contiguous ({B},) int32 tensor")
    dev = q.device
    for t in (k_cache, v_cache, cache_len):
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        es = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be contiguous")
        if name != "q" and (t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:-1])):
            raise ValueError(f"{name}: rows must be 16-byte aligned")


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, S, K, D)
    v_cache: torch.Tensor,  # (B, S, K, D)
    cache_len: torch.Tensor,  # (B,) int32, each <= S
    *,
    logit_cap: Optional[float] = None,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One query token per row against the cache -> (B, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, cache_len, logit_cap=logit_cap, window=window, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, cache_len)
    B, H, D = q.shape
    _, S, K, _ = k_cache.shape
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    splits, chunk = split_plan(B, K, S)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    part_ml = torch.empty((B * K * splits * G * 2,), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B * K * splits * G * D,), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
        out.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
        B, S, H, K, D,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
        float(scale), float(logit_cap or 0.0), int(window or 0), splits, chunk, stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
