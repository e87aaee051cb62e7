"""Dry-run of every (arch x shape x mesh) cell with no devices (port of
`repro.launch.dryrun`).

Says, before anyone rents 256 or 512 GPUs, whether a model and shape fit
each one and which of compute, HBM or the network bounds its step.

For each (arch, shape) the port's own program runs once at full depth and
width on fake CPU tensors (``FakeTensorMode``: shapes and dtypes, no
storage), with no mesh and no process group: ``make_train_step`` (remat
on, as JAX's default policy ``nothing``; AdamW with bf16 moments),
``prefill`` or ``decode_step``.  The fake tensors carry the CPU device, so
each kernel wrapper of `kernels.ops` takes its plain version: the count
sees the function each kernel computes, and nothing is allocated or
launched on any device.  That is how the count works, not a fallback.

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
  * collectives: DTensor's own program.  For each mesh of more than one
    device a child process (:func:`count_collectives`) starts torch's
    built-in ``"fake"`` process group at the mesh's size (its collectives
    move nothing), builds the mesh (`launch.mesh`), places the cell's fake
    arguments by the port's specs (``state_pspec``, ``batch_pspec``,
    ``cache_pspec``) and runs the same program under ``use_mesh`` and
    :class:`CollectiveRecorder` (``CommDebugMode``), which records each
    functional collective: its op, its result bytes on rank 0 and its
    group's mesh dims.  Each is timed by the ring accounting of
    `analysis.roofline` at NVLink's rate where its group lies in one node
    of 8, else at the network's, and the term is in ``dominant`` and
    ``step_bound_s``, as JAX's is.  On a (2, 2) mesh the count equals the
    record of the same step on 4 gloo ranks op for op
    (`tests/test_torch_distributed.py`).  The hillclimb levers reach the
    child through its environment.
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
  --all runs one cell at a time; each mesh's collective count is a child
  process of its own (CPU, torch's "fake" process group, no devices).
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
from repro_torch.models import sharding as sh
from repro_torch.models.layers import dtype_of
from repro_torch.train import TrainState, adamw, make_train_step
from repro_torch.util import observe, tree_flatten

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports", "dryrun_torch")

FLOPS_COUNTED = "matmul-class aten ops (torch.utils.flop_counter), backward included"
BYTES_COUNTED = ("operand and result bytes of every aten op that is not a view; gathers "
                 "count the rows read, copies and scatters the values written; a kernel "
                 "launch (flash_attention, decode_attention, ssd, mlstm) its operands and "
                 "results once, decode attention's cache to each row's length, and not "
                 "its plain version's ops")
COLLECTIVES_COUNTED = ("DTensor's functional collectives of the same program on a fake "
                       "process group of the mesh's size (CommDebugMode), each at its result "
                       "bytes and group; a CPU mesh's all-gather for an all-to-all as the "
                       "all-to-all; ring accounting per group's link")


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

    def launch(self, name: str, tensors, kw, run):
        """A kernel launch of `kernels.ops` (its observer hook): ``run()``
        counted as one op of the kernel's bytes."""
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
# collectives: DTensor's own, of the same program on a fake process group
# ---------------------------------------------------------------------------

_FUNCOLS = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
            "all_reduce": "all-reduce", "all_to_all_single": "all-to-all"}


def _cpu_alltoall() -> bool:
    """True inside DTensor's ``shard_dim_alltoall`` on a CPU mesh, which
    issues an all-gather and keeps a chunk where NCCL issues one all-to-all
    (`torch/distributed/tensor/_collective_utils.py`)."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall" and \
                f.f_code.co_filename.endswith("_collective_utils.py"):
            return True
        f = f.f_back
    return False


def _recorder_class():
    """:class:`CollectiveRecorder`, built on first use: importing DTensor's
    debug module loads one of torch's test-support modules, which a process
    that counts no collectives never needs."""
    from torch._ops import HigherOrderOperator
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveRecorder(CommDebugMode):
        """``CommDebugMode`` that records every functional collective a
        DTensor program issues on ``mesh``: ``events`` holds (op, result
        bytes on this rank, the mesh dims of its group).  Like
        ``CommDebugMode`` it lets DTensor desugar each op into local ops
        and collectives first; it keeps none of ``CommDebugMode``'s per-op
        tables, which a count of 10^5 ops or more would fill.  A CPU mesh's
        all-gather that stands in for an all-to-all is recorded as the
        all-to-all a CUDA mesh issues, with its input's bytes.  A collective
        of another kind raises: the count drops none."""

        def __init__(self, mesh) -> None:
            super().__init__()
            self.dims = {mesh.get_group(d).group_name: (d,) for d in range(mesh.ndim)}
            self.events: List[Tuple[str, int, Tuple[int, ...]]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if isinstance(func, HigherOrderOperator):
                return func(*args, **kwargs)
            if any(t is DTensor for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            if getattr(func, "namespace", None) != "_c10d_functional":
                return out
            name = func.__name__.split(".")[0]
            if name.startswith(("wait", "_")):  # waits and autograd wrappers move nothing
                return out
            op = _FUNCOLS.get(name)
            if op is None:
                raise NotImplementedError(f"the collective count has no rule for {name}")
            nbytes = out.numel() * out.element_size()
            if op == "all-gather" and _cpu_alltoall():
                op, nbytes = "all-to-all", args[0].numel() * args[0].element_size()
            self.events.append((op, nbytes, self.dims[kwargs.get("group_name", args[-1])]))
            return out

    return CollectiveRecorder


def __getattr__(name: str):
    if name == "CollectiveRecorder":
        cls = globals()[name] = _recorder_class()
        return cls
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def event_stats(events, mesh_shape: Sequence[int]) -> rl.CollectiveStats:
    """Recorded (op, result bytes, group's mesh dims) events by ring
    accounting, each timed over its group's link."""
    stats = rl.CollectiveStats()
    for op, nbytes, dims in events:
        stats.add(op, nbytes, math.prod(mesh_shape[d] for d in dims),
                  rl.group_link(mesh_shape, dims))
    return stats


def _fake_mode_metadata() -> None:
    """Let DTensor compute its placement metadata under ``FakeTensorMode``.
    Two of its computations build small tensors: a strided shard's local
    sizes (an index tensor as long as the dim, split and read back with
    ``tolist``) and the strategies of an op it decomposes (traced on meta
    tensors).  Under the fake mode those tensors turn fake and both raise,
    where on real tensors they run; here they run with the fake mode
    suspended.  Two pure functions that DTensor's strategy search asks for
    again and again, a strided shard's sizes and the cost of a
    redistribution between two specs, are computed once per argument
    tuple (without it most of a 2 x 16 x 16 train step's count).  What the
    program computes, and every collective, is unchanged."""
    import copy

    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._decompositions import DecompShardingStrategy
    from torch.distributed.tensor._ops import utils as strategy_utils
    from torch.distributed.tensor.placement_types import _StridedShard

    def suspended(fn, memo=None):
        if getattr(fn, "_real_metadata", False):
            return fn

        def run(*args, **kwargs):
            key = None
            if memo is not None and not kwargs and all(isinstance(a, int) for a in args[1:]):
                key = (args[0].dim, args[0].split_factor) + tuple(int(a) for a in args[1:])
                if key in memo:
                    return copy.deepcopy(memo[key])
            with unset_fake_temporarily():
                out = fn(*args, **kwargs)
            if key is not None:
                memo[key] = copy.deepcopy(out)
            return out

        run._real_metadata = True
        return run

    _StridedShard.local_shard_size_and_offset = suspended(
        _StridedShard.local_shard_size_and_offset, memo={})
    DecompShardingStrategy.propagate_strategy = suspended(
        DecompShardingStrategy.propagate_strategy)
    # the cost model's price of one redistribution, a pure function of the
    # two specs, which each op's strategy search asks for again and again
    cost = strategy_utils.redistribute_cost
    if not getattr(cost, "_real_metadata", False):
        costs: Dict[Any, float] = {}

        def redistribute_cost(current, target):
            key = (current, target)
            if key not in costs:
                costs[key] = cost(current, target)
            return costs[key]

        redistribute_cost._real_metadata = True
        strategy_utils.redistribute_cost = redistribute_cost


def run_program(cfg: ModelConfig, kind: str, args: Dict[str, Any], *, remat: bool = True,
                microbatches: int = 1, fused_ce: Optional[bool] = None, inplace: bool = False,
                cache_len=None):
    """The cell's program on ``args`` (`cell_args`): a train step, a
    prefill or a decode step (``cache_len``: an int or B per-row ints)."""
    if kind == "train":
        step = make_train_step(cfg, args["opt"], remat=remat, microbatches=microbatches,
                               fused_ce=fused_ce, inplace=inplace)
        return step(args["state"], args["batch"])
    with torch.no_grad():
        if kind == "prefill":
            return prefill(args["params"], cfg, args["batch"], args["cache"])
        if isinstance(cache_len, (list, tuple)):  # the per-row form
            cache_len = torch.tensor(cache_len, dtype=torch.int32)
        return decode_step(args["params"], cfg, args["batch"]["tokens"], args["cache"],
                           cache_len)


def place_args(mesh, cfg: ModelConfig, kind: str, args: Dict[str, Any]) -> Dict[str, Any]:
    """``args`` placed on the device mesh by the port's specs."""
    from repro_torch.launch.shardings import to_shardings

    def put(tree, specs):
        return sh.distribute(tree, to_shardings(mesh, specs))

    out = dict(args, batch=put(args["batch"], batch_pspec(mesh, args["batch"])))
    if kind == "train":
        out["state"] = put(args["state"], state_pspec(mesh, args["state"]))
    else:
        out["params"] = put(args["params"], state_pspec(mesh, args["params"]))
        out["cache"] = put(args["cache"], cache_pspec(mesh, cfg, args["cache"]))
    return out


def _collectives_child(spec_path: str, out_path: str) -> None:
    """The counts of one mesh, in a process of its own: torch's built-in
    "fake" process group of the mesh's size (its collectives move
    nothing), the mesh, and per cell its fake arguments placed by the
    port's specs and its program under ``use_mesh`` and
    :class:`CollectiveRecorder`.  A cell that raises is reported, and the
    next one runs."""
    import pickle

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    shape = dict(zip(spec["axis_names"], spec["mesh_shape"]))
    _fake_mode_metadata()
    dist.init_process_group("fake", rank=0, world_size=math.prod(spec["mesh_shape"]))
    out = []
    try:
        mesh = make_mesh(shape["data"], shape["model"], shape.get("pod", 1), device="cpu")
        assert tuple(mesh.mesh_dim_names) == tuple(spec["axis_names"]), mesh
        for cell in spec["cells"]:
            t0 = time.perf_counter()
            try:
                with FakeTensorMode():
                    cfg, kind = cell["cfg"], cell["kind"]
                    args = cell_args(cfg, kind, cell["B"], cell["S"], opt=cell["opt"],
                                     cache_dtype=cell["cache_dtype"])
                    args = place_args(mesh, cfg, kind, args)
                    rec = _recorder_class()(mesh)
                    with sh.use_mesh(mesh), rec:
                        run_program(cfg, kind, args, cache_len=cell["cache_len"],
                                    **cell["levers"])
                out.append({"events": rec.events, "seconds": time.perf_counter() - t0})
            except Exception:  # noqa: BLE001 - reported for this cell
                out.append({"error": traceback.format_exc()[-4000:]})
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"cells": out}, f)


def collective_cell(cfg: ModelConfig, kind: str, B: int, S: int, *, opt=None,
                    cache_dtype=torch.bfloat16, cache_len=None, remat: bool = True,
                    microbatches: int = 1, fused_ce: Optional[bool] = None,
                    inplace: bool = False) -> Dict[str, Any]:
    """One program for :func:`count_collectives_many`, as `count_program`
    takes it."""
    kind = "decode" if kind == "long_decode" else kind
    if kind == "decode" and cache_len is None:
        cache_len = S - 1
    return {"cfg": cfg, "kind": kind, "B": B, "S": S, "opt": opt, "cache_dtype": cache_dtype,
            "cache_len": cache_len,
            "levers": dict(remat=remat, microbatches=microbatches, fused_ce=fused_ce,
                           inplace=inplace)}


def count_collectives_many(cells: Sequence[Dict[str, Any]], mesh, *,
                           timeout: Optional[float] = None) -> List[Any]:
    """DTensor's collectives of each program of ``cells``
    (:func:`collective_cell`) on ``mesh`` (axis names and sizes), counted
    one after another in one child process (:func:`_collectives_child`),
    which inherits this process's environment (the hillclimb levers
    ``REPRO_AXIS_MAP``, ``REPRO_SEQ_PARALLEL``, ``REPRO_FUSED_CE``).  ->
    per cell its ``rl.CollectiveStats``, or the ``RuntimeError`` it raised
    (with the child's traceback)."""
    import pickle
    import subprocess
    import tempfile

    import repro_torch

    names = tuple(mesh.axis_names)
    dims = [mesh.shape[a] for a in names]
    src = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        spec_path, out_path = os.path.join(tmp, "spec.pkl"), os.path.join(tmp, "out.json")
        with open(spec_path, "wb") as f:
            pickle.dump({"cells": list(cells), "axis_names": names, "mesh_shape": dims}, f)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--collectives-of", spec_path,
             out_path], env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0 or not os.path.exists(out_path):
            raise RuntimeError(f"the collective count on {mesh_name(mesh)} failed "
                               f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
        with open(out_path) as f:
            got = json.load(f)["cells"]
    return [RuntimeError(f"on {mesh_name(mesh)}:\n{c['error']}") if "error" in c
            else event_stats(c["events"], dims) for c in got]


def count_collectives(cfg: ModelConfig, kind: str, B: int, S: int, mesh, *,
                      timeout: Optional[float] = None, **kw) -> rl.CollectiveStats:
    """DTensor's collectives of one program on ``mesh`` (a child process,
    :func:`count_collectives_many`); ``kw`` as :func:`collective_cell`."""
    [got] = count_collectives_many([collective_cell(cfg, kind, B, S, **kw)], mesh,
                                   timeout=timeout)
    if isinstance(got, Exception):
        raise got
    return got


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
                  cache_dtype=torch.bfloat16, cache_len=None,
                  timeout: Optional[float] = None) -> ProgramCount:
    """Run the port's program once on fake CPU tensors and count it: FLOPs,
    bytes, and per mesh of ``meshes`` the memory and DTensor's collectives
    (:func:`count_collectives`, a child process per mesh of more than one
    device; ``timeout`` its limit in seconds).  ``kind``
    "train": ``make_train_step`` on B x S tokens (``opt`` default: AdamW
    1e-4 with bf16 moments); "prefill": B x S prompt into a cache of S;
    "decode"/"long_decode": one token per row against a cache of S at
    ``cache_len`` (default S - 1; a list of B ints is the per-row form, as
    the continuous engine decodes)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    kind = "decode" if kind == "long_decode" else kind
    clen = S - 1 if cache_len is None else cache_len
    attend = ([n + 1 for n in clen] if isinstance(clen, (list, tuple)) else [clen + 1] * B) \
        if kind == "decode" else None
    levers = dict(remat=remat, microbatches=microbatches, fused_ce=fused_ce, inplace=inplace)
    multi = [m for m in meshes if math.prod(m.shape.values()) > 1]  # one device moves nothing
    with ThreadPoolExecutor(max(1, len(multi))) as pool:  # the children run meanwhile
        pending = {mesh_name(m): pool.submit(
            count_collectives, cfg, kind, B, S, m, opt=opt, cache_dtype=cache_dtype,
            cache_len=clen, timeout=timeout, **levers) for m in multi}
        with FakeTensorMode():
            args = cell_args(cfg, kind, B, S, opt=opt, cache_dtype=cache_dtype)
            flops, nbytes = FlopCounterMode(display=False), ByteCounter(attend)
            with flops, nbytes, observe(nbytes):
                outputs = run_program(cfg, kind, args, cache_len=clen, **levers)
            memory = {mesh_name(m): memory_stats(m, cfg, kind, args, outputs) for m in meshes}
        collectives = {mesh_name(m): pending[mesh_name(m)].result() if mesh_name(m) in pending
                       else rl.CollectiveStats() for m in meshes}
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
            link=link, link_bw=link_bw,
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
    ap.add_argument("--collectives-of", nargs=2, metavar=("SPEC", "OUT"),
                    help="(a child of count_collectives) count one mesh's collectives")
    args = ap.parse_args()
    if args.collectives_of:
        _collectives_child(*args.collectives_of)
        return 0
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
