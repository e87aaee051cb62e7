"""Decode (one-token) attention: the wrapper of the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``decode_attention_pallas``
(``repro/kernels/decode_attention.py``).  The source note in the ``.cu``
file says what bounds it on the H100 (bytes) and how the design answers.

:func:`decode_attention` dispatches on the tensor's device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, anything the kernel
does not take raises.  There is no fallback.  ``decode_attention.launches``
counts kernel launches: each call on the card is one launch of one kernel
(a cluster of ``splits`` CTAs per (row, kv head) that merge their partial
softmax states in distributed shared memory), and allocates only its
output.  :func:`cluster_splits` is the host's pick of ``splits``;
:func:`row_parts` mirrors the kernel's cut of a row's live range.
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
GRAIN = 16  # the kernel cuts a row's live range into whole tiles of 16 rows
CLUSTER_SIZES = (1, 2, 4, 8)  # the portable thread-block cluster sizes
_TARGET_CTAS = 2 * 132  # two CTAs on each of the H100's 132 SMs

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = [_P] * 5 + [_I] * 5 + [_L] * 8 + [_I, _I, _F, _F, _I, _I, _P]


def _lib():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def cluster_splits(B: int, K: int) -> int:
    """CTAs per (row, kv head), one cluster: the largest cluster size that
    keeps B*K*splits within about two CTAs per SM.  From the shapes alone:
    reading cache_len would synchronise the stream."""
    fit = max(1, _TARGET_CTAS // (B * K))
    return max(c for c in CLUSTER_SIZES if c <= fit)


def row_parts(L: int, S: int, window: Optional[int], splits: int):
    """[(start, end)] of each CTA of a cluster: the kernel's `row_part`.  The
    live range [lo, L) (L = min(cache_len, S), lo = max(0, L - window)) is
    cut into ``splits`` parts of equally many whole GRAIN-row tiles, the
    last part ragged; parts past the range are empty (start == end == L)."""
    L = min(L, S)
    lo = max(0, L - window) if window else 0
    n_tiles = -(-(L - lo) // GRAIN)
    per = -(-n_tiles // splits)
    parts = []
    for split in range(splits):
        start = min(L, lo + split * per * GRAIN)
        parts.append((start, min(L, start + per * GRAIN)))
    return parts


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
    _build.no_backward("decode_attention", q, k_cache, v_cache)
    _check(q, k_cache, v_cache, cache_len)
    B, H, D = q.shape
    _, S, K, _ = k_cache.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
        out.data_ptr(), B, S, H, K, D,
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
        float(scale), float(logit_cap or 0.0), int(window or 0), cluster_splits(B, K),
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
