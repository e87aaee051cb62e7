"""Flash attention forward: the wrapper of the CUDA kernel
``csrc/flash_attention.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``).  The source note in the ``.cu``
file says what bounds it on the H100 and how the design answers.

:func:`flash_attention` dispatches on the tensor's device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, anything the kernel
does not take raises.  There is no fallback.  The kernel library holds two
kernels and picks by dtype (:data:`ROUTES`): bf16 runs the tensor-core
kernel (the serving path), fp32 the scalar one (held to the fp32 bar).
``flash_attention.launches`` counts kernel launches, and
``flash_attention.route_launches`` splits them by route.  Any Sq/Sk is
taken (ragged tails are masked); Dv must equal D.

The kernel is forward-only, as the Pallas kernel is (the JAX package has no
backward kernel).  Training reaches it through
:class:`~._build.PlainBackwardFn` (``ops.flash_attention`` routes it), whose
backward recomputes attention with the plain version and differentiates
that; the wrapper itself raises when autograd would need a gradient through
it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .ref import mha_reference as flash_attention_plain

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "scalar", torch.bfloat16: "mma"}  # the kernel each dtype runs

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 6 + [_L] * 9 + [_I, _F, _F, _I, _I, _I, _P]


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if Bk != B or Dk != D or Sq < 1 or Sk < 1 or K < 1 or H % K:
        raise ValueError(f"shapes q{tuple(q.shape)} k{tuple(k.shape)} (Dv must equal D)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported by the kernel")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} (must match)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"tensors on {q.device} and {t.device}")
        es = t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be contiguous")
        if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must be 16-byte aligned")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, K, D)
    v: torch.Tensor,  # (B, Sk, K, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise online-softmax attention -> (B, Sq, H, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, logit_cap=logit_cap,
            q_offset=q_offset, scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _build.no_backward("flash_attention", q, k, v)
    _check(q, k, v)
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, K, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        _DTYPES[q.dtype], float(scale), float(logit_cap or 0.0),
        int(bool(causal)), int(window or 0), int(q_offset), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.route_launches[ROUTES[q.dtype]] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = {"scalar": 0, "mma": 0}
