"""Mamba2 SSD (state-space dual) scan: the wrapper of the CUDA kernel
``csrc/mamba2_ssd.cu`` and its plain PyTorch version.

Port of the Pallas TPU kernel ``ssd_pallas`` (``repro/kernels/mamba2_ssd.py``)
and of the chunked scan behind ``repro.kernels.ops.ssd_scan``.  The source
note in the ``.cu`` file says what bounds it on the H100 and how the design
answers.

:func:`ssd` takes the Pallas function's arguments (without ``interpret``)
plus ``return_state``: with it, the fp32 final state (B, H, P, N) comes back
beside y, which is what Mamba2 prefill needs (the Pallas kernel starts from
a zero state and returns y only, so the JAX serving path never reaches it).
It dispatches on the tensor's device: a CPU tensor goes to
:func:`ssd_plain`, a CUDA tensor to the kernel, anything the kernel does not
take raises.  There is no fallback.  The kernel library picks by dtype
(:data:`ROUTES`): bf16 runs the chunk-parallel tensor-core kernels (the
serving path: one launch up to :data:`CLUSTER_CHUNKS` chunks, else three,
with fp32 scratch for the chunks' states, padded to the kernels' tile
widths), fp32 the scalar kernel (held to the fp32 bar).  Both take the
(P, N) of :data:`WIDTHS`; others raise.  ``ssd.launches`` counts calls that launched,
``ssd.route_launches`` splits them by route.  Any S is taken: the kernels
mask the ragged last chunk themselves.

The kernel is forward-only, as the Pallas kernel is (the JAX package has no
backward kernel).  Training reaches it through
:class:`~._build.PlainBackwardFn` (``ops.ssd_scan`` routes it, y only),
whose backward recomputes y with :func:`ssd_plain` and differentiates that;
the wrapper itself raises when autograd would need a gradient through it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

# (P, N) the kernels take: zamba2-1.2b; the reduced configs; the JAX
# package's kernel tests; Mamba2's published state width.  The kernels pad
# P and N up to a multiple of 16 in shared memory (csrc/mamba2_ssd.cu).
WIDTHS = ((64, 64), (16, 16), (16, 8), (32, 16), (8, 4), (64, 128))
MAX_CHUNK = 128  # rows of the kernel's chunk tile (csrc/mamba2_ssd.cu)
CLUSTER_CHUNKS = 8  # up to this many chunks the bf16 route is one cluster launch, no scratch
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "scalar", torch.bfloat16: "mma"}  # the kernels each dtype runs

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_ARGTYPES = [_P] * 10 + [_I] * 7 + [_L] * 12 + [_I, _P]


def _tile(w: int) -> int:
    """A width padded up to the kernels' mma tile (16)."""
    return -(-w // 16) * 16


def _lib():
    lib = _build.load("mamba2_ssd")
    fn = lib.ssd_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# plain version: the chunked scan of ops.ssd_scan, state carried chunk by chunk
# ---------------------------------------------------------------------------

def _chunked_scan(x, dt, A, Bmat, Cmat, D, chunk: int):
    """S a multiple of ``chunk``; returns (y in x's dtype, fp32 final
    state).  Peak temporary: one chunk's (B, c, c, H) score tensor."""
    Bz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    rep = H // G
    nc = S // chunk
    xf = x.float().reshape(Bz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bz, nc, chunk, H)
    Bh = Bmat.float().repeat_interleave(rep, dim=2).reshape(Bz, nc, chunk, H, N)
    Ch = Cmat.float().repeat_interleave(rep, dim=2).reshape(Bz, nc, chunk, H, N)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    Af = A.float()
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for n in range(nc):
        xc, dtc, bc, cc = xf[:, n], dtf[:, n], Bh[:, n], Ch[:, n]
        a_cum = torch.cumsum(Af * dtc, dim=1)  # (B,c,H), inclusive
        a_tot = a_cum[:, -1, :]  # (B,H)
        seg = a_cum[:, :, None, :] - a_cum[:, None, :, :]  # (B,t,s,H)
        # masked before the exp: above the diagonal seg > 0 can overflow,
        # and exp's inf there would make the gradient 0 * inf = nan (the
        # forward is the same as masking after the exp)
        L = torch.exp(torch.where(tri[None, :, :, None], seg, -torch.inf))
        scores = torch.einsum("bthk,bshk->btsh", cc, bc) * L * dtc[:, None, :, :]
        y_intra = torch.einsum("btsh,bshp->bthp", scores, xc)
        y_inter = torch.einsum("bch,bchk,bhpk->bchp", torch.exp(a_cum), cc, h)
        w = torch.exp(a_tot[:, None, :] - a_cum) * dtc  # (B,c,H)
        h = h * torch.exp(a_tot)[..., None, None] + torch.einsum("bch,bchp,bchk->bhpk", w, xc, bc)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bz, S, H, P)
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_plain(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bmat: torch.Tensor,  # (B, S, G, N)
    Cmat: torch.Tensor,  # (B, S, G, N)
    D: Optional[torch.Tensor] = None,  # (H,)
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """The chunked scan of ``repro.kernels.ops.ssd_scan``: the chunk shrinks
    to S when S is shorter; otherwise S is padded to a chunk multiple with
    dt = 0 (identity steps: the state is unchanged) and y is cut back."""
    S = x.shape[1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
    y, h = _chunked_scan(x, dt, A, Bmat, Cmat, D, chunk)
    if pad:
        y = y[:, :S]
    return (y, h) if return_state else y


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _check(x, dt, A, Bmat, Cmat, D, chunk):
    if x.dim() != 4 or dt.dim() != 3 or Bmat.dim() != 4 or Bmat.shape != Cmat.shape:
        raise ValueError(f"shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
                         f"B{tuple(Bmat.shape)} C{tuple(Cmat.shape)}")
    Bz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    if (dt.shape != (Bz, S, H) or Bmat.shape[:2] != (Bz, S) or A.shape != (H,)
            or (D is not None and D.shape != (H,)) or S < 1 or G < 1 or H % G):
        raise ValueError(f"shapes x{tuple(x.shape)} dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(Bmat.shape)} D{None if D is None else tuple(D.shape)}")
    if (P, N) not in WIDTHS:
        raise ValueError(f"head_dim {P} / state_dim {N} not supported by the kernel "
                         f"(it takes (P, N) in {WIDTHS})")
    if not 1 <= min(chunk, S) <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if x.dtype not in _DTYPES or Bmat.dtype != x.dtype or Cmat.dtype != x.dtype:
        raise TypeError(f"dtypes x {x.dtype}, B {Bmat.dtype}, C {Cmat.dtype} (must match)")
    for name, t in (("dt", dt), ("A", A), ("D", D)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", Bmat), ("C", Cmat), ("D", D)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    for name, t in (("A", A), ("D", D)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("x", x), ("B", Bmat), ("C", Cmat)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dim must be contiguous")


def ssd(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32
    A: torch.Tensor,  # (H,) fp32, negative
    Bmat: torch.Tensor,  # (B, S, G, N)
    Cmat: torch.Tensor,  # (B, S, G, N)
    D: Optional[torch.Tensor] = None,  # (H,) fp32
    *,
    chunk: int = 128,
    return_state: bool = False,
):
    """SSD scan from a zero state -> y (B, S, H, P) in x's dtype, and with
    ``return_state`` also the fp32 final state (B, H, P, N).  x, B and C
    are read through their strides (views of the conv output are taken as
    they are); dt through its strides."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, Bmat, Cmat, D, chunk=chunk, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    _build.no_backward("ssd", x, dt, A, Bmat, Cmat, D)
    _check(x, dt, A, Bmat, Cmat, D, chunk)
    Bz, S, H, P = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    y = torch.empty((Bz, S, H, P), dtype=x.dtype, device=x.device)
    state = (torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
             if return_state else None)
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    d_state = a_tot = None
    if ROUTES[x.dtype] == "mma" and n_chunks > CLUSTER_CHUNKS:  # dS, then the entering states
        d_state = torch.empty((Bz, n_chunks, H, _tile(P), _tile(N)), dtype=torch.float32,
                              device=x.device)
        a_tot = torch.empty((Bz, n_chunks, H), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib()(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
        None if D is None else D.data_ptr(), y.data_ptr(),
        None if state is None else state.data_ptr(),
        None if d_state is None else d_state.data_ptr(),
        None if a_tot is None else a_tot.data_ptr(),
        Bz, S, H, G, P, N, chunk,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        Bmat.stride(0), Bmat.stride(1), Bmat.stride(2),
        Cmat.stride(0), Cmat.stride(1), Cmat.stride(2),
        _DTYPES[x.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {rc}")
    ssd.launches += 1
    ssd.route_launches[ROUTES[x.dtype]] += 1
    return (y, state) if return_state else y


ssd.launches = 0
ssd.route_launches = {"scalar": 0, "mma": 0}
