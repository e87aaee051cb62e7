"""Dry-run of every (arch x shape x mesh) cell with no devices (port of
`repro.launch.dryrun`).

Says, before anyone rents 256 or 512 GPUs, whether a model and shape fit
each one and which of compute or HBM bounds its step, with a modelled
collective term beside them.  No
process group, no device mesh and no DTensor: the meshes are
`models.sharding.AbstractMesh` (axis names and sizes), which the port's
sharding rules read as they read a device mesh.

For each (arch, shape) the port's own program runs once at full depth and
width on fake CPU tensors (``FakeTensorMode``: shapes and dtypes, no
storage), with no mesh: ``make_train_step`` (remat on, as JAX's default
policy ``nothing``; AdamW with bf16 moments), ``prefill`` or
``decode_step``.  The fake tensors carry the CPU device, so each kernel
wrapper of `kernels.ops` takes its plain version: the count sees the
function each kernel computes, and nothing is allocated or launched on any
device.  That is how the count works, not a fallback.

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmul-class aten
    ops, the backward included).  XLA also counts elementwise FLOPs, so
    ``useful_ratio`` reads higher than JAX's would.
  * bytes: every aten op's operand and result bytes that is not a view
    (the definition of XLA's "bytes accessed" on an unfused module); a
    gather counts the rows it reads, a copy or scatter into a buffer the
    values it writes, as XLA counts a gather and a dynamic-update-slice.
    A launch of a kernel of `kernels.ops` (flash and decode attention, the
    SSD scan, the mLSTM) counts as the card runs it: its operands read
    once and its results written once, decode attention's cache only up
    to each row's length, and not the plain version's ops that compute it
    on the CPU.  A backward through a kernel is the plain version's
    backward, as ``PlainBackwardFn`` runs it on the card (its recompute
    of the plain forward is not counted).
  * per device: both counts divided by the cell's device count, JAX's rule
    (the unpartitioned module's totals over ``n_devices``).
  * collectives: a no-grad forward of the same program with an observer
    (`repro_torch.util.observe`) that prices, per mesh, an FSDP +
    Megatron program at the port's constraint sites: each parameter's FSDP
    all-gather where a forward op reads it; the tensor-parallel all-reduce
    of each row-parallel product and vocab-parallel lookup (reduce-scatter
    and all-gather under sequence parallelism); a partial sum where a
    product contracts a split dim (the MoE combine's sum over tp-split
    experts); the redistributions at the constraint sites ``shard``,
    ``residual_shard`` and ``placed_like`` from the layout each tensor last
    had; the stand-ins of ROADMAP Queue 3 (the tokens replicated for the
    embedding, the vocab-whole CE gather, the replicated MoE routing, and
    the split `ops.local_split` keeps for a kernel, the other dims
    replicated, such as a sequence-sharded decode cache).  A train step
    adds the remat recompute (the layers' collectives again, inside the
    scope "layer" that `transformer._call` sets), the backward (each
    forward collective's transpose: Megatron's f for its g, a
    reduce-scatter for an all-gather) and each parameter's gradient sync
    (reduce-scatter over the dp axes it is sharded on, all-reduce over
    those it is not).  Each collective is timed by the ring accounting of
    `analysis.roofline` at NVLink's rate where its group lies in one node
    of 8, else at the network's.  **This count is not DTensor's**: on a
    (2, 2) gloo mesh DTensor picks other placements op by op (it gathers
    weights over both mesh dims, reduce-scatters the partial sums that
    reach an RMSNorm and gathers them back, re-lays residual adds) and
    issues 1.02-2.2 x the wire bytes, per op kind in other counts
    (`tests/test_torch_distributed.py`).  So each cell reports
    ``collective_s`` but keeps it out of ``dominant`` and ``step_bound_s``
    (``collective_in_bound`` false).
  * memory per device: each argument and output leaf's local shard, a dim
    the mesh does not divide replicated (`models.sharding.placements`'s
    rule); ``alias_bytes`` is the donated state or cache.  ``temp_bytes`` is
    -1: with no compiler there is no buffer assignment.

Not ported: JAX's depth probes (``probe_plans``, ``_probe_metrics``,
``solve_stage_costs``) work around XLA counting a while-loop body once;
the port runs its layers as a Python loop, so the count at full depth is
exact and ``probe_s`` is 0.  ``rolled_flops_per_device`` and ``hlo_lines``
have no counterpart without a compiler and are left out.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multipod-only|--single-only]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-done   # resume
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
# torch._subclasses.fake_tensor.FakeTensorMode: private, the port's way to
# build full-size trees with no storage (train/checkpoint.py uses it too)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode
# torch.utils._python_dispatch.TorchDispatchMode: private, and the only mode
# that sees the aten ops autograd runs in the backward pass
# (``TorchFunctionMode`` does not); present on torch 2.11 and 2.13
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import roofline as rl
from repro_torch.configs import CONFIGS, SHAPES, applicable_shapes
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.shardings import batch_pspec, cache_pspec, state_pspec
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.kernels import ops
from repro_torch.models import sharding as sh
from repro_torch.models.layers import dtype_of
from repro_torch.train import TrainState, adamw, make_train_step
from repro_torch.train.train_step import make_loss_fn
from repro_torch.util import observe, scopes, tree_flatten, tree_map_with_path

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "dryrun_torch")

FLOPS_COUNTED = "matmul-class aten ops (torch.utils.flop_counter), backward included"
BYTES_COUNTED = ("operand and result bytes of every aten op that is not a view; gathers "
                 "count the rows read, copies and scatters the values written; a kernel "
                 "launch (flash_attention, decode_attention, ssd, mlstm) its operands and "
                 "results once, decode attention's cache to each row's length, and not "
                 "its plain version's ops")
COLLECTIVES_COUNTED = ("unvalidated, not in dominant or step_bound_s: FSDP all-gathers of "
                       "parameters per forward use (again in the remat recompute), "
                       "tensor-parallel reductions of row-parallel products, partial sums "
                       "of products over split dims, redistributions at the constraint "
                       "sites and kernel launches, the backward's transposes and the "
                       "gradient syncs; ring accounting")


def mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


# ---------------------------------------------------------------------------
# inputs: fake tensors built by the port's own constructors
# ---------------------------------------------------------------------------

def shape_adjusted_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Per-shape config tweaks that only affect table sizes, not structure."""
    kw: Dict[str, Any] = {}
    if cfg.pos_embedding == "learned" and shape.seq_len + 1 > cfg.max_target_positions:
        kw["max_target_positions"] = shape.seq_len + 1
    if cfg.moe is not None:
        # bound dispatch-tensor memory: small groups at scale
        gs = 512 if cfg.moe.num_experts >= 128 else 2048
        kw["moe"] = dataclasses.replace(cfg.moe, group_size=gs)
    return dataclasses.replace(cfg, **kw) if kw else cfg


def input_batch(cfg: ModelConfig, kind: str, B: int, S: int) -> Dict[str, torch.Tensor]:
    """The batch dict of one cell (JAX's ``input_specs``), as tensors of the
    ambient mode: int32 tokens, bf16 prefix embeddings and audio frames."""
    batch: Dict[str, torch.Tensor] = {}
    dt = torch.bfloat16
    if kind in ("train", "prefill"):
        S_text = S - (cfg.num_prefix_tokens if cfg.frontend == "vision_stub" else 0)
        batch["tokens"] = torch.zeros((B, S_text), dtype=torch.int32)
        if kind == "train":
            batch["labels"] = torch.zeros((B, S_text), dtype=torch.int32)
        if cfg.frontend == "vision_stub":
            batch["prefix_embed"] = torch.zeros((B, cfg.num_prefix_tokens, cfg.d_model), dtype=dt)
        if cfg.family == "encdec":
            batch["audio_frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=dt)
    else:  # decode / long_decode
        batch["tokens"] = torch.zeros((B, 1), dtype=torch.int32)
    return batch


def decode_cache(cfg: ModelConfig, B: int, max_len: int, cache_dtype=torch.bfloat16):
    """``init_cache`` plus, for whisper, each layer's cross K/V (what
    prefill adds; JAX's ``_cache_structs(with_cross=True)``)."""
    cache = init_cache(cfg, B, max_len, cache_dtype, "cpu")
    if cfg.family == "encdec":
        K, hd, dt = cfg.n_kv_heads, cfg.hd, dtype_of(cfg.dtype)
        for layer in cache["decoder"]:
            layer["cross"] = {"k": torch.zeros((B, cfg.encoder_seq, K, hd), dtype=dt),
                              "v": torch.zeros((B, cfg.encoder_seq, K, hd), dtype=dt)}
    return cache


# ---------------------------------------------------------------------------
# per-device memory from the specs
# ---------------------------------------------------------------------------

def layout(mesh, spec: Sequence, shape: Sequence[int]) -> Tuple[Tuple[str, ...], ...]:
    """Per tensor dim, the mesh axes that split it: a spec entry the dim
    does not divide is replicated (`sharding.placements`'s rule)."""
    out = []
    for d, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        if axes and shape[d] % math.prod(mesh.shape[a] for a in axes):
            axes = ()
        out.append(tuple(axes))
    return tuple(out)


def shard_bytes(mesh, spec, shape, itemsize: int) -> int:
    split = math.prod(mesh.shape[a] for axes in layout(mesh, spec, shape) for a in axes)
    return math.prod(shape) * itemsize // split


def tree_shard_bytes(mesh, tree, specs) -> int:
    leaves = tree_flatten(tree)[0]
    spec_leaves = tree_flatten(specs, is_leaf=lambda x: isinstance(x, sh.P))[0]
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    return sum(shard_bytes(mesh, s, tuple(t.shape), t.element_size())
               for t, s in zip(leaves, spec_leaves))


def cell_args(cfg: ModelConfig, kind: str, B: int, S: int, *, opt=None,
              cache_dtype=torch.bfloat16) -> Dict[str, Any]:
    """The cell's arguments as tensors of the ambient mode (fake tensors
    under ``FakeTensorMode``): train {"state", "batch", "opt"}; prefill and decode
    {"params", "cache", "batch"} (decode's cache with whisper's cross K/V)."""
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = input_batch(cfg, kind, B, S)
    if kind == "train":
        opt = opt if opt is not None else adamw(1e-4, moment_dtype=torch.bfloat16)
        return {"state": TrainState(params, opt.init(params)), "batch": batch, "opt": opt}
    cache = (init_cache(cfg, B, S, cache_dtype, "cpu") if kind == "prefill"
             else decode_cache(cfg, B, S, cache_dtype))
    return {"params": params, "cache": cache, "batch": batch}


def argument_bytes(mesh, cfg: ModelConfig, kind: str, args: Dict[str, Any]) -> Tuple[int, int]:
    """(per-device argument bytes, of which donated): the state or the
    params, cache and batch, each leaf's local shard; decode adds its
    int32 ``cache_len`` scalar, as JAX's lowered step takes one."""
    batch_b = tree_shard_bytes(mesh, args["batch"], batch_pspec(mesh, args["batch"]))
    if kind == "train":
        state = args["state"]
        donated = tree_shard_bytes(mesh, state, state_pspec(mesh, state))
        return donated + batch_b, donated
    params, cache = args["params"], args["cache"]
    donated = tree_shard_bytes(mesh, cache, cache_pspec(mesh, cfg, cache))
    scalar = 4 if kind != "prefill" else 0
    return tree_shard_bytes(mesh, params, state_pspec(mesh, params)) + donated + batch_b \
        + scalar, donated


def memory_stats(mesh, cfg: ModelConfig, kind: str, args: Dict[str, Any], outputs) -> Dict:
    """Per-device argument, output and aliased (donated) bytes of a cell."""
    arg_b, donated_b = argument_bytes(mesh, cfg, kind, args)
    if kind == "train":
        state, metrics = outputs
        out_b = tree_shard_bytes(mesh, state, state_pspec(mesh, state))
        out_b += sum(t.numel() * t.element_size() for t in tree_flatten(metrics)[0])
    else:
        logits, cache = outputs[0], outputs[1]
        dp, tp = sh.physical_axes(mesh, sh.DP), sh.physical_axes(mesh, sh.TP)
        out_b = shard_bytes(mesh, (dp, None, tp), tuple(logits.shape), logits.element_size())
        out_b += tree_shard_bytes(mesh, cache, cache_pspec(mesh, cfg, cache))
        if kind == "prefill":
            out_b += 4  # new_len, an int32 scalar in JAX
    return {"argument_bytes": arg_b, "output_bytes": out_b, "temp_bytes": -1,
            "alias_bytes": donated_b}


# ---------------------------------------------------------------------------
# bytes accessed
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _op_bytes(func, args, kwargs, out) -> int:
    name = func.overloadpacket.__name__
    if name in ("index", "embedding", "gather", "index_select"):
        idx = [t for t in _tensors(args[1:]) + _tensors(kwargs) if not t.is_floating_point()]
        return 2 * sum(_nbytes(t) for t in _tensors(out)) + sum(_nbytes(t) for t in idx)
    if name in ("copy_", "copy"):
        return 2 * _nbytes(args[1])
    if name in ("index_put_", "index_put", "scatter", "scatter_", "scatter_add",
                "scatter_add_", "index_copy_", "index_copy"):
        src = args[2] if len(args) > 2 else None
        rest = [t for t in _tensors(args[1:]) if t is not src]
        return 2 * _nbytes(src) + sum(_nbytes(t) for t in rest)
    return sum(_nbytes(t) for t in _tensors(args) + _tensors(kwargs) + _tensors(out))


def kernel_bytes(name: str, tensors, kw, out, attend=None) -> float:
    """A kernel's bytes accessed: each operand read once and each result
    written once.  Decode attention reads, per row, the cache rows it
    attends to (``attend``, per-row lengths; None: the whole cache), fewer
    under a sliding window."""
    total = sum(_nbytes(t) for t in tensors) + sum(_nbytes(t) for t in _tensors(out))
    if name == "decode_attention" and attend is not None:
        k, v = tensors[1], tensors[2]
        B, S = k.shape[0], k.shape[1]
        window = kw.get("window") or S
        rows = sum(min(S, n, window) for n in attend)
        total -= (1.0 - rows / (B * S)) * (_nbytes(k) + _nbytes(v))
    return float(total)


class ByteCounter(TorchDispatchMode):
    """Counts the aten ops that run under it and their bytes accessed; a
    kernel launch of `kernels.ops` (seen through :meth:`kernel`) counts as
    one op of its operand and result bytes, and the plain version's ops
    that compute it on the CPU are not counted."""

    def __init__(self, attend=None):
        super().__init__()
        self.bytes = 0.0
        self.ops = 0
        self.attend = attend
        self._inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten" or self._inside:  # metadata queries move nothing
            return out
        self.ops += 1
        if not func.is_view:
            self.bytes += _op_bytes(func, args, kwargs, out)
        return out

    def kernel(self, name: str, tensors, kw, run):
        self._inside += 1
        try:
            out = run()
        finally:
            self._inside -= 1
        self.ops += 1
        self.bytes += kernel_bytes(name, [t for t in tensors if t is not None], kw, out,
                                   self.attend)
        return out


# ---------------------------------------------------------------------------
# collectives: what the port's program moves on a mesh of each shape
# ---------------------------------------------------------------------------

def _in_layer() -> bool:
    """True inside a model layer (`transformer._call`'s scope), which the
    remat recompute runs again."""
    return "layer" in scopes()


Layout = Tuple[Tuple[Tuple[str, ...], ...], frozenset]  # (axes per dim, partial axes)


class MeshCount:
    """The collectives of one forward on one mesh: every event is
    ``(op, result bytes per device, group size, link, kind, in_layer)``,
    kind "param" (an FSDP gather), "tp" (a row-parallel reduction),
    "site" (a constraint site's or a launch's redistribution)."""

    def __init__(self, mesh, cfg: ModelConfig, params, cache=None, batch=None) -> None:
        self.mesh = mesh
        self.names = list(mesh.axis_names)
        self.dims = tuple(mesh.shape[a] for a in self.names)
        self.dp = tuple(sh.physical_axes(mesh, sh.DP) or ())
        tp = sh.physical_axes(mesh, sh.TP)
        self.tp = (tp,) if tp else ()
        self.events: List[Tuple[str, float, int, str, str, bool]] = []
        self.table: Dict[int, Tuple[torch.Tensor, Layout]] = {}
        self.params: Dict[int, Tuple[torch.Tensor, Tuple[Tuple[str, ...], ...]]] = {}
        for t, spec in self._pairs(params, sh.param_pspec(mesh, params)):
            self.params[id(t)] = (t, layout(mesh, spec, tuple(t.shape)))
        if cache is not None:
            for t, spec in self._pairs(cache, cache_pspec(mesh, cfg, cache)):
                self.track(t, layout(mesh, spec, tuple(t.shape)))
        if batch is not None:
            for t, spec in self._pairs(batch, batch_pspec(mesh, batch)):
                self.track(t, layout(mesh, spec, tuple(t.shape)))

    @staticmethod
    def _pairs(tree, specs):
        return zip(tree_flatten(tree)[0],
                   tree_flatten(specs, is_leaf=lambda x: isinstance(x, sh.P))[0])

    # -- layouts --
    def size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def link(self, axes) -> str:
        return rl.group_link(self.dims, [self.names.index(a) for a in axes])

    def track(self, t: torch.Tensor, lay, partial=frozenset()) -> None:
        self.table[id(t)] = (t, (tuple(lay), frozenset(partial)))

    def default(self, t: torch.Tensor) -> Layout:
        """An untracked activation: its batch (dim 0) over dp where dp
        divides it, as the residual stream lies."""
        shape = tuple(t.shape)
        lay = [()] * len(shape)
        if shape and self.dp and shape[0] % self.size(self.dp) == 0:
            lay[0] = self.dp
        return tuple(lay), frozenset()

    def current(self, t: torch.Tensor) -> Layout:
        hit = self.table.get(id(t))
        return hit[1] if hit is not None and hit[0] is t else self.default(t)

    def local_bytes(self, t: torch.Tensor, lay) -> float:
        return t.numel() * t.element_size() / self.size([a for axes in lay for a in axes])

    def emit(self, op, nbytes, axes, kind, in_layer) -> None:
        n = self.size(axes)
        if n > 1:
            self.events.append((op, float(nbytes), n, self.link(axes), kind, in_layer))

    def redistribute(self, t: torch.Tensor, dst, in_layer: bool) -> None:
        """Collectives that take ``t`` from its current layout to ``dst``
        (axes per dim, not partial), one mesh axis at a time as DTensor
        redistributes."""
        src, partial = self.current(t)
        cur = [list(axes) for axes in src]
        for a in self.names:
            s_dim = next((d for d, axes in enumerate(cur) if a in axes), None)
            d_dim = next((d for d, axes in enumerate(dst) if a in axes), None)
            if a in partial:
                if d_dim is not None:
                    cur[d_dim].append(a)
                    self.emit("reduce-scatter", self.local_bytes(t, cur), (a,), "site", in_layer)
                else:
                    self.emit("all-reduce", self.local_bytes(t, cur), (a,), "site", in_layer)
            elif s_dim is not None and d_dim is None:
                cur[s_dim].remove(a)
                self.emit("all-gather", self.local_bytes(t, cur), (a,), "site", in_layer)
            elif s_dim is not None and d_dim != s_dim:
                cur[s_dim].remove(a)
                cur[d_dim].append(a)
                self.emit("all-to-all", self.local_bytes(t, cur), (a,), "site", in_layer)
        self.track(t, dst)

    def view(self, x, out, where) -> None:
        """``out`` a view of ``x`` (or a copy in its layout): each split dim
        of a tracked ``x`` lands where ``where(dim)`` puts it."""
        hit = self.table.get(id(x))
        if hit is None or hit[0] is not x:
            return
        lay, partial = hit[1]
        new = [[] for _ in range(out.dim())]
        for d, axes in enumerate(lay):
            j = where(d) if axes else None
            if j is not None and 0 <= j < out.dim():
                new[j].extend(axes)
        self.track(out, tuple(tuple(a) for a in new), partial)

    # -- observer events --
    def shard(self, x, logical, in_layer) -> None:
        spec = sh.make_pspec(self.mesh, *logical)
        self.redistribute(x, layout(self.mesh, spec, tuple(x.shape)), in_layer)

    def residual(self, x, in_layer) -> None:
        tp = self.tp[0] if self.tp else None
        if sh.seq_parallel() and tp is not None and x.shape[1] % self.size(self.tp) == 0 \
                and x.shape[1] >= self.size(self.tp):
            return self.shard(x, (sh.DP, sh.TP, None), in_layer)
        self.shard(x, (sh.DP, None, None), in_layer)

    def placed_like(self, x, ref, in_layer) -> None:
        lay, _ = self.current(ref)
        self.redistribute(x, lay, in_layer)

    def launch(self, name: str, tensors, in_layer) -> None:
        """`ops._local_launch`'s redistributions on abstract layouts: the
        split that `ops.local_split` keeps, every other dim replicated
        first."""
        in_roles = ops._ROLES[name][0]
        present = [i for i, t in enumerate(tensors) if t is not None]
        args = [tensors[i] for i in present]
        roles = [in_roles[i] for i in present]
        lead = self.current(args[0])[0]
        split, whole = ops.local_split(
            [tuple(t.shape) for t in args], roles,
            {a: roles[0][d] for d, axes in enumerate(lead) for a in axes
             if roles[0][d] in ("b", "h")},
            dict(self.mesh.shape))
        for t, r in zip(args, roles):
            dst = [[] for _ in r]
            for a in self.names:
                d = ops.split_dim(r, a, split, whole)
                if d is not None:
                    dst[d].append(a)
            self.redistribute(t, tuple(tuple(x) for x in dst), in_layer)

    def contract(self, a, b, out) -> None:
        """A product ``out = a @ b`` (batched or not) of tracked operands:
        a contracted dim split over some axes makes ``out`` a partial sum
        over them (as the MoE combine's sum over tp-split experts); the
        batch and row dims keep ``a``'s axes."""
        ta, tb = self.table.get(id(a)), self.table.get(id(b))
        ta = ta[1][0] if ta is not None and ta[0] is a else None
        tb = tb[1][0] if tb is not None and tb[0] is b else None
        if ta is None and tb is None:
            return
        partial = set(ta[-1] if ta else ()) | set(tb[-2] if tb else ())
        lay = [()] * out.dim()
        if ta:
            lay[:-1] = [tuple(x for x in axes if x not in partial) for axes in ta[:-1]]
        self.track(out, tuple(lay), partial)

    def param_use(self, leaf, nbytes, in_layer) -> None:
        """An FSDP all-gather of what a forward op reads of ``leaf`` over
        the dp axes its spec splits it on."""
        lay = self.params[id(leaf)][1]
        axes = [a for dims in lay for a in dims]
        dp_axes = [a for a in axes if a in self.dp]
        if dp_axes:
            rest = self.size([a for a in axes if a not in self.dp])
            self.emit("all-gather", nbytes / rest, dp_axes, "param", in_layer)

    def tp_reduce(self, leaf, out, in_layer) -> None:
        """A row-parallel product's (or a vocab-parallel lookup's) output,
        partial over tp where the parameter is split on tp: an all-reduce,
        or under sequence parallelism a reduce-scatter and the all-gather
        before the next column-parallel product."""
        lay = self.params[id(leaf)][1]
        if not self.tp or self.tp[0] not in [a for dims in lay for a in dims]:
            return
        nbytes = self.local_bytes(out, self.default(out)[0])
        if sh.seq_parallel():
            self.emit("reduce-scatter", nbytes / self.size(self.tp), self.tp, "tp", in_layer)
            self.emit("all-gather", nbytes, self.tp, "tp", in_layer)
        else:
            self.emit("all-reduce", nbytes, self.tp, "tp", in_layer)

    def grad_syncs(self, params) -> List[Tuple[str, float, int, str]]:
        """Each parameter's gradient: a reduce-scatter over the dp axes its
        spec splits it on, an all-reduce over the dp axes it is whole on."""
        out = []
        for t in tree_flatten(params)[0]:
            lay = self.params[id(t)][1]
            axes = [a for dims in lay for a in dims]
            local = t.numel() * t.element_size() / self.size(axes)
            sharded = [a for a in axes if a in self.dp]
            whole = [a for a in self.dp if a not in axes]
            if sharded and self.size(sharded) > 1:
                out.append(("reduce-scatter", local, self.size(sharded), self.link(sharded)))
            if whole and self.size(whole) > 1:
                out.append(("all-reduce", local, self.size(whole), self.link(whole)))
        return out


# aten ops whose result keeps its input's layout (views, casts, copies)
_VIEWS = ("view", "_unsafe_view", "t", "transpose", "permute", "expand", "unsqueeze",
          "squeeze", "slice", "select", "_to_copy", "clone", "detach", "alias", "lift_fresh")


def _map_dim(in_shape, out_shape, d: Optional[int]) -> Optional[int]:
    """The output dim a reshape puts input dim ``d``'s outermost part in."""
    if d is None or in_shape[d] == 1:
        return None
    pre = math.prod(in_shape[:d])
    acc = 1
    for j, n in enumerate(out_shape):
        if acc <= pre < acc * n or (n > 1 and acc == pre):
            return j
        acc *= n
    return None


def _tp_dim_after(func, args, out, d: Optional[int]) -> Optional[int]:
    """Where a view-like op puts the input's dim ``d``."""
    name = func.overloadpacket.__name__
    x = args[0]
    if d is None or not isinstance(out, torch.Tensor):
        return None
    if name in ("view", "_unsafe_view", "squeeze"):
        return _map_dim(tuple(x.shape), tuple(out.shape), d)
    if name == "t":
        return 1 - d if x.dim() == 2 else d
    if name == "transpose":
        a, b = (int(args[1]) % x.dim(), int(args[2]) % x.dim())
        return b if d == a else a if d == b else d
    if name == "permute":
        perm = [int(p) % x.dim() for p in args[1]]
        return perm.index(d)
    if name == "unsqueeze":
        k = int(args[1]) % out.dim()
        return d + 1 if d >= k else d
    if name == "expand":  # new dims lead
        return d + out.dim() - x.dim()
    if name == "select":
        k = int(args[1]) % x.dim()
        return None if d == k else d - 1 if d > k else d
    return d


class ParamUses(TorchDispatchMode):
    """Tells the observer's counts where forward ops read a parameter (an
    FSDP gather), where a product contracts a parameter's tensor-parallel
    dim (a row-parallel reduction), and where a product of activations
    contracts a split dim (a partial sum)."""

    def __init__(self, counts: List[MeshCount], params) -> None:
        super().__init__()
        self.counts = counts
        self.leaves: Dict[int, Tuple[torch.Tensor, Optional[int]]] = {}
        for t, tp_dim in _leaves_with_tp_dim(params):
            self.leaves[id(t)] = (t, tp_dim)
        self.derived: Dict[int, Tuple[torch.Tensor, torch.Tensor, Optional[int]]] = {}

    def origin(self, t):
        """(parameter leaf, its tp dim in ``t``) where ``t`` is a leaf or
        a view of one, else None."""
        if not isinstance(t, torch.Tensor):
            return None
        hit = self.leaves.get(id(t))
        if hit is not None and hit[0] is t:
            return t, hit[1]
        hit = self.derived.get(id(t))
        if hit is not None and hit[0] is t:
            return hit[1], hit[2]
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace != "aten":  # metadata queries (prim.device) read nothing
            return out
        name = func.overloadpacket.__name__
        if name in _VIEWS and args and isinstance(out, torch.Tensor):
            for c in self.counts:  # a view keeps its source's layout
                c.view(args[0], out, lambda d: _tp_dim_after(func, args, out, d))
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        direct = [a for a in tensors if id(a) in self.leaves and self.leaves[id(a)][0] is a]
        origins = [self.origin(a) for a in tensors]
        if not direct and not any(origins):
            if name in ("mm", "bmm") and isinstance(out, torch.Tensor):
                for c in self.counts:
                    c.contract(args[0], args[1], out)
            return out
        in_layer = _in_layer()
        for leaf in direct:
            nbytes = _nbytes(out) if func.is_view else _nbytes(leaf)
            for c in self.counts:
                c.param_use(leaf, nbytes, in_layer)
        first = self.origin(args[0]) if args else None
        if name in _VIEWS and first is not None and isinstance(out, torch.Tensor):
            self.derived[id(out)] = (out, first[0], _tp_dim_after(func, args, out, first[1]))
            return out
        row = None
        if name in ("mm", "addmm"):
            a, b = (args[1], args[2]) if name == "addmm" else (args[0], args[1])
            oa, ob = self.origin(a), self.origin(b)
            if ob is not None and ob[1] == 0:
                row = ob[0]
            elif oa is not None and oa[1] == 1:
                row = oa[0]
        elif name in ("bmm", "baddbmm"):
            a, b = (args[1], args[2]) if name == "baddbmm" else (args[0], args[1])
            oa, ob = self.origin(a), self.origin(b)
            if ob is not None and ob[1] == 1:
                row = ob[0]
            elif oa is not None and oa[1] == 2:
                row = oa[0]
        elif name in ("embedding", "index"):  # a lookup in a vocab-parallel table
            ot = self.origin(args[0])
            if ot is not None and ot[1] == 0:
                row = ot[0]
        if row is not None:
            for c in self.counts:
                c.tp_reduce(row, out, in_layer)
        return out


def _leaves_with_tp_dim(params):
    """(leaf, the dim its rule puts on the logical tp axis or None) for
    every parameter leaf."""
    out = []

    def visit(path, t):
        logical = sh._match_logical(path, tuple(t.shape))
        out.append((t, logical.index(sh.TP) if sh.TP in logical else None))

    tree_map_with_path(visit, params)
    return out


class _Observer:
    """Fans the port's constraint sites and launches out to each mesh's
    count, and a kernel launch to the byte count."""

    def __init__(self, counts: List[MeshCount], nbytes: Optional[ByteCounter] = None) -> None:
        self.counts = counts
        self.nbytes = nbytes

    def shard(self, x, logical):
        for c in self.counts:
            c.shard(x, logical, _in_layer())

    def residual(self, x):
        for c in self.counts:
            c.residual(x, _in_layer())

    def placed_like(self, x, ref):
        for c in self.counts:
            c.placed_like(x, ref, _in_layer())

    def launch(self, name, tensors, kw, run, kernel: bool):
        for c in self.counts:
            c.launch(name, tensors, _in_layer())
        if kernel and self.nbytes is not None:
            return self.nbytes.kernel(name, tensors, kw, run)
        return run()


_TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
              "all-reduce": "all-reduce", "all-to-all": "all-to-all",
              "collective-permute": "collective-permute"}


def collective_stats(count: MeshCount, kind: str, *, remat: bool = True, microbatches: int = 1,
                     params=None) -> rl.CollectiveStats:
    """The step's collectives from one forward's events: a serving step is
    that forward; a train step runs it per microbatch, the layers' again
    under remat, each non-parameter collective's transpose in the backward,
    and the gradient syncs."""
    stats = rl.CollectiveStats()
    for op, nbytes, n, link, what, in_layer in count.events:
        if kind != "train":
            stats.add(op, nbytes, n, link)
            continue
        fwd = microbatches * (2 if remat and in_layer else 1)
        stats.add(op, nbytes, n, link, times=fwd)
        if what != "param":  # the parameters' gradients are the syncs below
            # the transpose of a reduce-scatter gathers its (n x larger) input
            back = nbytes * n if op == "reduce-scatter" else nbytes / n \
                if op == "all-gather" else nbytes
            stats.add(_TRANSPOSE[op], back, n, link, times=microbatches)
    if kind == "train":
        for op, nbytes, n, link in count.grad_syncs(params):
            stats.add(op, nbytes, n, link, times=microbatches)
    return stats


# ---------------------------------------------------------------------------
# the count
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramCount:
    """One program's totals (global, not per device) and, per mesh name,
    its collectives and memory."""

    flops: float
    bytes: float
    ops: int
    seconds: float
    collectives: Dict[str, rl.CollectiveStats]
    memory: Dict[str, Dict]


def count_program(cfg: ModelConfig, kind: str, B: int, S: int, meshes: Sequence, *,
                  opt=None, remat: bool = True, microbatches: int = 1,
                  fused_ce: Optional[bool] = None, inplace: bool = False,
                  cache_dtype=torch.bfloat16, cache_len=None) -> ProgramCount:
    """Run the port's program once on fake CPU tensors and count it: FLOPs,
    bytes, and per mesh of ``meshes`` the collectives and memory.  ``kind``
    "train": ``make_train_step`` on B x S tokens (``opt`` default: AdamW
    1e-4 with bf16 moments); "prefill": B x S prompt into a cache of S;
    "decode"/"long_decode": one token per row against a cache of S at
    ``cache_len`` (default S - 1; a list of B ints is the per-row form, as
    the continuous engine decodes)."""
    t0 = time.perf_counter()
    clen = S - 1 if cache_len is None else cache_len
    attend = ([n + 1 for n in clen] if isinstance(clen, (list, tuple)) else [clen + 1] * B) \
        if kind in ("decode", "long_decode") else None
    with FakeTensorMode():
        args = cell_args(cfg, kind, B, S, opt=opt, cache_dtype=cache_dtype)
        batch = args["batch"]
        flops, nbytes = FlopCounterMode(display=False), ByteCounter(attend)
        if kind == "train":
            state = args["state"]
            params = state.params
            step = make_train_step(cfg, args["opt"], remat=remat, microbatches=microbatches,
                                   fused_ce=fused_ce, inplace=inplace)
            with flops, nbytes, observe(_Observer([], nbytes)):
                outputs = step(state, batch)
            micro = {k: v[: B // microbatches] for k, v in batch.items()}
            counts = [MeshCount(m, cfg, params, batch=micro) for m in meshes]
            if any(math.prod(m.shape.values()) > 1 for m in meshes):  # else nothing moves
                loss_fn = make_loss_fn(cfg, remat=False, fused_ce=fused_ce)
                with torch.no_grad(), observe(_Observer(counts)), ParamUses(counts, params):
                    loss_fn(params, micro)
        else:
            params, cache = args["params"], args["cache"]
            counts = [MeshCount(m, cfg, params, cache=cache, batch=batch) for m in meshes]
            with torch.no_grad(), flops, nbytes, observe(_Observer(counts, nbytes)), \
                    ParamUses(counts, params):
                if kind == "prefill":
                    outputs = prefill(params, cfg, batch, cache)
                else:
                    if isinstance(clen, (list, tuple)):  # the per-row form
                        clen = torch.tensor(clen, dtype=torch.int32)
                    outputs = decode_step(params, cfg, batch["tokens"], cache, clen)
        memory = {mesh_name(m): memory_stats(m, cfg, kind, args, outputs) for m in meshes}
    collectives = {mesh_name(m): collective_stats(c, kind, remat=remat,
                                                  microbatches=microbatches, params=params)
                   for m, c in zip(meshes, counts)}
    return ProgramCount(flops=float(flops.get_total_flops()), bytes=float(nbytes.bytes),
                        ops=nbytes.ops, seconds=time.perf_counter() - t0,
                        collectives=collectives, memory=memory)


def _cell_config(arch: str, shape_name: str, moe_group: Optional[int]):
    shape = SHAPES[shape_name]
    cfg = shape_adjusted_config(CONFIGS[arch], shape)
    if moe_group is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, group_size=moe_group))
    return cfg, shape


def analyze(arch: str, shape_name: str, meshes: Sequence, *, microbatches: int = 1,
            remat: bool = True, moe_group: Optional[int] = None) -> Dict[str, Dict]:
    """The cell's JSON per mesh of ``meshes`` (one count serves them all)."""
    cfg, shape = _cell_config(arch, shape_name, moe_group)
    kind = "decode" if shape.kind == "long_decode" else shape.kind
    count = count_program(cfg, kind, shape.global_batch, shape.seq_len, meshes,
                          remat=remat, microbatches=microbatches)
    total_p, active_p = cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind in ("train", "prefill") else 1)
    mf = rl.model_flops_per_step(total_p, active_p, tokens,
                                 "train" if shape.kind == "train" else "serve")
    out = {}
    for mesh in meshes:
        name, n_dev = mesh_name(mesh), math.prod(mesh.shape.values())
        colls = count.collectives[name]
        link, link_bw = colls.link()
        roof = rl.Roofline(
            arch=arch, shape=shape_name, mesh=name, n_devices=n_dev,
            hlo_flops_per_device=count.flops / n_dev,
            hlo_bytes_per_device=count.bytes / n_dev,
            collective_bytes_per_device=colls.wire_bytes,
            model_flops=mf,
            collective_by_op=dict(colls.by_op),
            collective_counts=dict(colls.counts),
            memory_stats=count.memory[name],
            link=link, link_bw=link_bw, collective_in_bound=False,
        ).finalize()
        d = roof.to_dict()
        d.update({
            "compile_s": count.seconds, "probe_s": 0.0,
            "total_params": total_p, "active_params": active_p, "tokens_per_step": tokens,
            "collective_bytes_by_link": dict(colls.by_link),
            "aten_ops": count.ops,
            "flops_counted": FLOPS_COUNTED, "bytes_counted": BYTES_COUNTED,
            "collectives_counted": COLLECTIVES_COUNTED,
        })
        out[name] = d
        ms = d["memory_stats"]
        print(
            f"[{arch} x {shape_name} x {name}] compile={count.seconds:.1f}s "
            f"flops/dev={d['hlo_flops_per_device']:.3e} bytes/dev={d['hlo_bytes_per_device']:.3e} "
            f"coll/dev={d['collective_bytes_per_device']:.3e} dominant={d['dominant']} "
            f"args={ms['argument_bytes']/1e9:.2f}GB temp=-"
        )
        print(f"  terms: compute={d['compute_s']*1e3:.2f}ms memory={d['memory_s']*1e3:.2f}ms "
              f"collective={d['collective_s']*1e3:.2f}ms ({link}) "
              f"useful_ratio={d['useful_ratio']:.3f} "
              f"roofline_fraction={d['roofline_fraction']:.3f}")
    return out


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool, **kw) -> Dict[str, Any]:
    mesh = abstract_production_mesh(multi_pod)
    return analyze(arch, shape_name, [mesh], **kw)[mesh_name(mesh)]


def cell_path(arch: str, shape_name: str, name: str, report_dir: str = REPORT_DIR) -> str:
    os.makedirs(report_dir, exist_ok=True)
    return os.path.join(report_dir, f"{arch}__{shape_name}__{name}.json")


def run_all(args) -> int:
    cells = []
    for arch, cfg in CONFIGS.items():
        if args.arch and arch != args.arch:
            continue
        for shape in applicable_shapes(cfg):
            if args.shape and shape.name != args.shape:
                continue
            meshes = []
            if not args.multipod_only:
                meshes.append(False)
            if not args.single_only:
                meshes.append(True)
            cells.append((arch, shape.name, meshes))
    print(f"{sum(len(m) for _, _, m in cells)} cells to run")
    t0 = time.perf_counter()
    failures = []
    for arch, shape_name, mps in cells:
        todo = [abstract_production_mesh(mp) for mp in mps]
        if args.skip_done:
            for m in list(todo):
                if os.path.exists(cell_path(arch, shape_name, mesh_name(m), args.report_dir)):
                    print(f"skip done: {arch} x {shape_name} x {mesh_name(m)}")
                    todo.remove(m)
        if not todo:
            continue
        try:
            for name, out in analyze(arch, shape_name, todo).items():
                with open(cell_path(arch, shape_name, name, args.report_dir), "w") as f:
                    json.dump(out, f, indent=1)
        except Exception as e:  # noqa: BLE001
            for m in todo:
                print(f"FAILED: {arch} x {shape_name} x {mesh_name(m)}: {e}")
                failures.append((arch, shape_name, mesh_name(m), str(e)))
            traceback.print_exc()
    print(f"\ndone in {time.perf_counter() - t0:.1f}s; {len(failures)} failures")
    for f in failures:
        print("  FAIL:", f[:3])
    return 1 if failures else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true", help="single cell: use 2x16x16")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--single-only", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--report-dir", default=REPORT_DIR, help="where each cell's JSON goes")
    args = ap.parse_args()
    if args.all or (args.arch and not args.shape) or (args.shape and not args.arch):
        return run_all(args)
    if not args.arch:
        ap.error("give --arch and --shape, or --all")
    out = analyze_cell(args.arch, args.shape, multi_pod=args.multipod)
    with open(cell_path(args.arch, args.shape, out["mesh"], args.report_dir), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
