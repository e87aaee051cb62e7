"""AdamW with optional int8-quantized moments (port of
`repro.train.optimizer`).

The int8 moments matter doubly in this framework: optimizer state is
device-resident during a step and storage-resident between stateless tasks,
so int8 m/v with per-block scales cut both the device footprint and the
checkpoint bytes about 4x against fp32 moments.

The API follows the JAX package's:

    opt = adamw(lr_schedule, ...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Schedules and the optimizer are small classes (not closures), so the
runtime can ship them with the standard ``pickle``.  All arithmetic is fp32
as in JAX, the bias corrections ``1 - b ** step`` included; ``torch.round``
and ``jnp.round`` both round half to even.  Moments keep the parameter
tree's structure; with ``quantize_moments`` each leaf is a dict
``{"q": int8 (blocks, 256), "scale": fp32 (blocks, 1)}`` over the leaf's
elements in row-major order (a per-layer leaf here, where JAX's leaves are
stacked over layers: the blocks coincide wherever a per-layer leaf holds a
multiple of 256 elements).

:meth:`AdamW.update_` is the form for the card: leaf by leaf it updates the
moments and the parameter in place and drops the gradient, and never
builds the ``updates`` tree; it gives the bits ``update`` then
``apply_updates`` give.

DTensor leaves (a sharded state, `launch.shardings.state_pspec`) are
updated in their parameters' placements.  An int8 moment is encoded from
the whole leaf (replicated first), so its 256-blocks are an unsharded
run's, and it stays replicated, as JAX's ``state_pspec`` leaves it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import placed_like
from repro_torch.util import is_dtensor, tree_flatten, tree_map, tree_unflatten

_BLOCK = 256


# ---------------------------------------------------------------------------
# schedules: step (int tensor) -> fp32 0-d tensor on the step's device
# ---------------------------------------------------------------------------

class ConstantSchedule:
    def __init__(self, lr: float) -> None:
        self.lr = float(lr)

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)


class CosineSchedule:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``."""

    def __init__(self, peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> None:
        self.peak_lr, self.warmup, self.total, self.floor = float(peak_lr), warmup, total, floor

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        peak, warmup, floor = self.peak_lr, self.warmup, self.floor
        warm = peak * torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(self.total - warmup, 1), 0.0, 1.0)
        # cos of the fp32 angle, rounded once to fp32 (torch's fp32 cos is
        # an ulp off XLA's at some steps; the rounded fp64 value is not)
        c = torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32)
        cos = peak * (floor + (1 - floor) * 0.5 * (1 + c))
        return torch.where(step < warmup, warm, cos)


def constant_schedule(lr: float) -> ConstantSchedule:
    return ConstantSchedule(lr)


def cosine_schedule(peak_lr: float, warmup: int, total: int, floor: float = 0.1) -> CosineSchedule:
    return CosineSchedule(peak_lr, warmup, total, floor)


# ---------------------------------------------------------------------------
# int8 block quantization
# ---------------------------------------------------------------------------

def _q8_encode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    if is_dtensor(x):  # the blocks run over the whole leaf
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    blocks = F.pad(flat, (0, pad)).view(-1, _BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # divide by a tensor on amax's device: a CUDA kernel given a Python
    # scalar multiplies by its reciprocal, an ulp off the CPU's (and JAX's)
    # division
    scale = amax / torch.tensor(127.0, device=amax.device)
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def _q8_decode(enc: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    flat = (enc["q"].to(torch.float32) * enc["scale"]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape)


def _is_q8(x: Any) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 0-d
    m: Any  # the parameter tree (fp32 / moment_dtype, or q8-encoded leaves)
    v: Any


class AdamW:
    """Construct with :func:`adamw`."""

    def __init__(self, lr, b1: float, b2: float, eps: float, weight_decay: float,
                 quantize_moments: bool, moment_dtype: torch.dtype) -> None:
        self.sched = lr if callable(lr) else ConstantSchedule(lr)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.quantize_moments = quantize_moments
        self.moment_dtype = moment_dtype

    # v (second moment) is quantized in sqrt space: linear int8 on v zeroes
    # small entries within a block (one large |g| dominates the scale), and
    # sqrt(0)+eps in the denominator then produces huge updates.
    def _enc(self, x):
        return _q8_encode(x) if self.quantize_moments else x.to(self.moment_dtype)

    def _enc_v(self, x):
        return _q8_encode(torch.sqrt(x)) if self.quantize_moments else x.to(self.moment_dtype)

    def _dec(self, x, shape):
        return _q8_decode(x, shape) if self.quantize_moments else x.to(torch.float32)

    def _dec_v(self, x, shape):
        if self.quantize_moments:
            r = _q8_decode(x, shape)
            return r * r
        return x.to(torch.float32)

    def init(self, params) -> AdamWState:
        dev = tree_flatten(params)[0][0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m=tree_map(lambda p: self._enc(torch.zeros_like(p, dtype=torch.float32)), params),
            v=tree_map(lambda p: self._enc_v(torch.zeros_like(p, dtype=torch.float32)), params),
        )

    def _scalars(self, state: AdamWState):
        step = state.step + 1
        stepf = step.to(torch.float32)
        b1 = torch.tensor(self.b1, dtype=torch.float32, device=step.device)
        b2 = torch.tensor(self.b2, dtype=torch.float32, device=step.device)
        return step, self.sched(step), 1 - b1**stepf, 1 - b2**stepf

    def _leaf(self, g, m_enc, v_enc, p, lr_t, bc1, bc2):
        """-> (update in p's dtype, new fp32 m, new fp32 v) of one leaf."""
        b1, b2, eps = self.b1, self.b2, self.eps
        g = g.to(torch.float32)
        m = self._dec(m_enc, g.shape)
        v = self._dec_v(v_enc, g.shape)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if self.quantize_moments:
            # Adafactor-style update clipping guards against residual
            # quantization noise in near-zero blocks
            rms = torch.sqrt(torch.mean(delta * delta) + 1e-12)
            delta = delta / torch.clamp(rms, min=1.0)
        if self.weight_decay:
            delta = delta + self.weight_decay * p.to(torch.float32)
        return (-lr_t * delta).to(p.dtype), m, v

    def _moment_leaves(self, tree):
        return tree_flatten(tree, is_leaf=_is_q8)[0]

    def update(self, grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        step, lr_t, bc1, bc2 = self._scalars(state)
        flat_g, struct = tree_flatten(grads)
        flat_m, flat_v = self._moment_leaves(state.m), self._moment_leaves(state.v)
        flat_p = tree_flatten(params)[0]
        out = [self._leaf(g, m, v, p, lr_t, bc1, bc2)
               for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p)]
        updates = tree_unflatten(struct, [o[0] for o in out])
        new_m = tree_unflatten(struct, [self._enc(o[1]) for o in out])
        new_v = tree_unflatten(struct, [self._enc_v(o[2]) for o in out])
        return updates, AdamWState(step=step, m=new_m, v=new_v)

    @torch.no_grad()
    def update_(self, grads: List[Optional[torch.Tensor]], state: AdamWState, params,
                grad_scale: Optional[torch.Tensor] = None) -> AdamWState:
        """In-place ``update`` + ``apply_updates``: ``grads`` is the flat
        list of gradients in ``tree_flatten(params)`` order, which this
        consumes (each entry is set to None once its leaf is done, so the
        caller's list no longer holds it).  ``grad_scale`` (fp32 0-d) is
        the global-norm clip factor, applied as `clip_by_global_norm` does
        (``g.float() * factor``).  Parameter and moment tensors are
        overwritten; returns the state with the step advanced."""
        step, lr_t, bc1, bc2 = self._scalars(state)
        flat_p = tree_flatten(params)[0]
        flat_m, flat_v = self._moment_leaves(state.m), self._moment_leaves(state.v)
        for i, (p, m_enc, v_enc) in enumerate(zip(flat_p, flat_m, flat_v)):
            g = grads[i]
            grads[i] = None
            if grad_scale is not None:
                g = g.to(torch.float32) * grad_scale
            u, m, v = self._leaf(g, m_enc, v_enc, p, lr_t, bc1, bc2)
            del g
            p.copy_(placed_like((p + u).to(p.dtype), p))
            del u
            for old, new in ((m_enc, self._enc(m)), (v_enc, self._enc_v(v))):
                if self.quantize_moments:
                    old["q"].copy_(placed_like(new["q"], old["q"]))
                    old["scale"].copy_(placed_like(new["scale"], old["scale"]))
                else:
                    old.copy_(placed_like(new, old))
        return AdamWState(step=step, m=state.m, v=state.v)


def adamw(
    lr: Union[float, Any],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    quantize_moments: bool = False,
    moment_dtype: torch.dtype = torch.float32,
) -> AdamW:
    return AdamW(lr, b1, b2, eps, weight_decay, quantize_moments, moment_dtype)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for leaf in tree_flatten(tree)[0]:
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(total)


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads * factor, norm); the product is fp32, as JAX promotes a
    bf16 leaf times its fp32 factor."""
    norm = global_norm(grads)
    factor = clip_factor(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * factor, grads), norm
