"""Mesh-aware logical sharding on a torch ``DeviceMesh`` (port of
`repro.models.sharding`).

Model code annotates activations with *logical* axes ("dp", "tp", None);
this module maps them onto whatever mesh is ambient:
  * production single-pod: (data=16, model=16)        dp=(data,) tp=model
  * production multi-pod:  (pod=2, data=16, model=16) dp=(pod,data) tp=model
  * one device, no mesh: every constraint is a no-op.

Parameter shardings are assigned by path-pattern rules (`param_pspec`, the
JAX package's ``_RULES`` verbatim), giving Megatron-style TP over "model"
and ZeRO-3/FSDP over the combined data axes.

A spec is a :class:`P`, one entry per tensor dim: None, a mesh axis name,
or a tuple of them (one tensor dim split over several mesh dims, the first
outermost, as JAX's ``PartitionSpec`` reads them).  :func:`placements`
turns it into DTensor placements.  The rules read a mesh only through
``axis_names`` and ``shape[name]``: :func:`describe` gives that view of a
``DeviceMesh`` or of an :class:`AbstractMesh` (axis names and sizes, no
devices), and the rules take any leaf with a ``.shape``, so they run on
full-size configs without allocating them.

The ambient mesh is a context variable set by :func:`use_mesh`, whose body
runs under DTensor's ``implicit_replication()``: the models make plain
tensors of their own (RoPE tables, positions, masks), which then join
DTensor arithmetic as replicated.  :func:`shard` and
:func:`residual_shard` return their input unchanged when no mesh is
ambient, and importing this module does not import
``torch.distributed.tensor``.

Where XLA would partition a line by itself, the port names the layout:
:func:`reshape` replicates a mesh dim whose shard a reshape cannot carry
(8 KV heads split off over 16), in the forward and the backward;
:func:`sublayer_input` and :func:`residual_shard` around each sublayer
give Megatron's layout, which keeps DTensor from sequence-sharding a
residual sum; :func:`whole_gradient` reduces a gradient before a backward
that cannot take it partial.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import os
import re
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.util import is_dtensor, tree_map_with_path

DP = "dp"  # data-parallel / FSDP logical axis -> ("pod","data") subset
TP = "tp"  # tensor/expert-parallel logical axis -> "model"

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


class AbstractMesh:
    """Axis names and sizes of a mesh, with no devices and no process group
    (JAX's ``AbstractMesh``): ``axis_names`` and ``shape[name]``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]) -> None:
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def describe(mesh) -> AbstractMesh:
    """The rules' view of a ``DeviceMesh`` (or an :class:`AbstractMesh`)."""
    if isinstance(mesh, AbstractMesh):
        return mesh
    return AbstractMesh(tuple(mesh.shape), mesh.mesh_dim_names)


def current_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make the ``DeviceMesh`` ``mesh`` ambient for the body, which runs
    under ``implicit_replication()``."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH.reset(token)


def axis_map() -> str:
    """Logical->physical mapping scheme (a hillclimb lever):
      tp_model (default): dp -> (pod, data), tp -> model   (FSDP+TP16)
      fsdp_all:           dp -> (pod, data, model), tp -> —  (pure ZeRO-3;
                          kills TP activation all-reduces; right for models
                          whose layer params fit HBM when gathered)
    """
    return os.environ.get("REPRO_AXIS_MAP", "tp_model")


def seq_parallel() -> bool:
    """Megatron-style sequence parallelism for the residual stream: hidden
    states (B, S, D) are sharded over tp on S between blocks, shrinking the
    per-layer saved activations tp-fold (a hillclimb lever)."""
    return os.environ.get("REPRO_SEQ_PARALLEL", "0") == "1"


def physical_axes(mesh, logical):
    if logical is None:
        return None
    if isinstance(logical, tuple):  # combined logical axes, e.g. ("dp","tp")
        out = []
        for l in logical:
            ax = physical_axes(mesh, l)
            if ax is None:
                continue
            out.extend(ax if isinstance(ax, tuple) else (ax,))
        return tuple(out) if out else None
    names = set(describe(mesh).axis_names)
    scheme = axis_map()
    if logical == DP:
        pool = ("pod", "data", "model") if scheme == "fsdp_all" else ("pod", "data")
        axes = tuple(a for a in pool if a in names)
        return axes if axes else None
    if logical == TP:
        if scheme == "fsdp_all":
            return None
        return "model" if "model" in names else None
    # literal mesh axis name passthrough
    return logical if logical in names else None


class P(tuple):
    """A partition spec: one entry per tensor dim (JAX's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def axis_size(mesh, ax) -> int:
    """Devices along one spec entry (1 for None)."""
    shape = describe(mesh).shape
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(shape[a] for a in ax)
    return shape[ax]


def make_pspec(mesh, *logical) -> P:
    return P(*(physical_axes(mesh, l) for l in logical))


def placements(mesh, spec: Sequence, shape: Optional[Sequence[int]] = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each mesh dim that tensor dim ``d`` names, else
    ``Replicate()``.  DTensor splits a dim sharded over several mesh dims
    in mesh order, so an entry must name its axes in that order (JAX's
    ``P(("pod", "data"))`` is pod-major, as the meshes are).  Given the
    tensor's ``shape``, a dim its entry does not divide is replicated:
    XLA pads such a dim, and DTensor's views refuse ragged shards."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(describe(mesh).axis_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None or (shape is not None and shape[d] % axis_size(mesh, entry)):
            continue
        dims = [names.index(a) for a in (entry if isinstance(entry, tuple) else (entry,))]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} is out of the mesh's axis order {names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def shard(x, *logical):
    """The DTensor ``x`` redistributed to ``logical`` on the ambient mesh
    (JAX's ``with_sharding_constraint``); with no mesh, or a plain tensor,
    ``x`` itself."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"spec {logical} does not match rank-{x.ndim} tensor")
    pl = placements(mesh, make_pspec(mesh, *logical), x.shape)
    return x if tuple(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def residual_shard(x):
    """Constraint for the (B, S, D) residual stream between blocks: batch
    over dp, and — under sequence parallelism — S over tp."""
    mesh = _MESH.get()
    if mesh is None or x.ndim != 3:
        return x
    tp_ax = physical_axes(mesh, TP)
    if seq_parallel() and tp_ax is not None:
        tp_size = axis_size(mesh, tp_ax)
        if x.shape[1] % tp_size == 0 and x.shape[1] >= tp_size:
            return shard(x, DP, TP, None)
    return shard(x, DP, None, None)


def _view_groups(in_shape, out_shape):
    """The dims of a reshape grouped where both shapes' prefix products
    meet: a list of (input dims, output dims), size-1 dims left out."""
    ins = [d for d, n in enumerate(in_shape) if n != 1]
    outs = [d for d, n in enumerate(out_shape) if n != 1]
    groups, i, j = [], 0, 0
    while i < len(ins) and j < len(outs):
        gi, go = [ins[i]], [outs[j]]
        a, b = in_shape[ins[i]], out_shape[outs[j]]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                gi.append(ins[i])
                a *= in_shape[ins[i]]
                i += 1
            else:
                go.append(outs[j])
                b *= out_shape[outs[j]]
                j += 1
        groups.append((gi, go))
    return groups


def _carried(x, shape):
    """``x`` replicated on each mesh dim whose shard a reshape to ``shape``
    cannot carry: one on a dim that is not the first of those the reshape
    merges or splits, or one that does not divide the first part the
    reshape splits that dim into (DTensor refuses a view that unflattens 8
    KV heads sharded over 16)."""
    from torch.distributed.tensor import Replicate, Shard

    first = {}
    for ins, outs in _view_groups(tuple(x.shape), tuple(shape)):
        for d in ins:
            first[d] = (d == ins[0], shape[outs[0]] if outs else 1)
    mesh, pl = x.device_mesh, list(x.placements)
    for m, p in enumerate(pl):
        if type(p) is Shard:
            lead, outer = first.get(p.dim, (True, mesh.size(m)))
            if not lead or outer % mesh.size(m) or x.shape[p.dim] % mesh.size(m):
                pl[m] = Replicate()
    return x if pl == list(x.placements) else x.redistribute(mesh, tuple(pl))


class _FitReshape(torch.autograd.Function):
    """A DTensor reshape whose input, and in the backward whose gradient,
    is first laid out so that the reshape can carry it."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _carried(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _carried(g, ctx.in_shape).reshape(ctx.in_shape), None


def reshape(x, shape):
    """``x.reshape(shape)``.  A DTensor is first replicated on each mesh
    dim whose shard the reshape cannot carry, and so is its gradient before
    the backward's reshape back: where a split head dim meets a mesh dim
    it does not divide (GQA's 8 KV heads, xLSTM's 4 heads, a grouped norm's
    2 groups over 16), XLA pads the dim and DTensor's views raise."""
    if not is_dtensor(x):
        return x.reshape(shape)
    return _FitReshape.apply(x, tuple(shape))


def sublayer_input(x):
    """A sublayer's (B, S, D) input laid out for its products: batch over
    dp, the rest whole (Megatron's gather of a sequence-parallel stream).
    With :func:`residual_shard` on each sublayer's output before its
    residual add, this keeps DTensor from laying a sum out sequence-sharded,
    which a product that flattens (B, S) turns into a strided shard in the
    forward or the backward: at the production meshes DTensor then prices
    each strategy over index tensors of B x S entries."""
    return shard(x, DP, None, None)


def whole_gradient(x):
    """``x``; a DTensor's gradient is brought to ``x``'s placements here in
    the backward, a partial sum reduced.  A vocab-parallel lookup's
    backward cannot take a partial gradient, which the first layer's
    products give."""
    return x.redistribute(x.device_mesh, x.placements) if is_dtensor(x) else x


def placed_like(x, ref):
    """``x`` in the placements of ``ref``, the destination of an in-place
    write, where both are DTensors; otherwise ``x``.  DTensor keeps an
    in-place op's destination placements and refuses a source that would
    change them, where JAX returns a new array."""
    if is_dtensor(ref) and is_dtensor(x) and tuple(x.placements) != tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


# ---------------------------------------------------------------------------
# parameter sharding rules (path-pattern based), the JAX package's verbatim
# ---------------------------------------------------------------------------
# Each rule: (regex over 'a/b/c' param path, logical spec builder given ndim).
# Conventions (dims AFTER the scan-stacking axes, which are always None):
#   embeddings (V, D)           -> (tp, dp)    vocab-sharded
#   attn wq (D, H, hd)          -> (dp, tp, None)
#   attn wk/wv (D, K, hd)       -> (dp, None, None)
#   attn wo (H, hd, D)          -> (tp, None, dp)
#   mlp w_gate/w_up (D, F)      -> (dp, tp)
#   mlp w_down (F, D)           -> (tp, dp)
#   moe experts (E, D, F)       -> (tp, dp, None)   expert-parallel
#   moe w_down (E, F, D)        -> (tp, None, dp)
#   router (D, E)               -> (dp, None)
#   mamba in/out proj           -> (dp, tp) / (tp, dp)
#   norms / scalars / biases    -> replicated
# FSDP ("dp") on the non-tp dim gives ZeRO-3.

_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/tok$", (TP, DP)),
    (r"embed/pos$", (None, None)),
    (r"lm_head$", (DP, TP)),
    (r"(wq|q_up)$", (DP, TP, None)),
    (r"(wk|wv)$", (DP, None, None)),
    (r"wo$", (TP, None, DP)),
    (r"(wq_b|wk_b|wv_b)$", (None, None)),
    (r"q_down$", (DP, TP)),
    (r"kv_down$", (DP, None)),
    (r"kv_up$", (DP, TP, None)),
    (r"(w_gate|w_up)$", (DP, TP)),
    (r"w_down$", (TP, DP)),
    (r"experts/(w_gate|w_up)$", (TP, DP, None)),
    (r"experts/w_down$", (TP, None, DP)),
    (r"router$", (DP, None)),
    (r"in_proj$", (DP, TP)),
    (r"out_proj$", (TP, DP)),
    (r"(conv_kernel|conv_bias)$", (None, TP)),
    (r"(A_log|D|dt_bias)$", (TP,)),
    (r"(w_q|w_k|w_v)hw$", (TP, None, None)),  # headwise xlstm projections
    (r"(w_i|w_f)gate$", (DP, TP)),
    (r"r_kernel$", (TP, None, None, None)),
    (r"gates_x$", (DP, TP, None)),
    (r"skip$", (TP,)),
)


def path_str(path: Tuple) -> str:
    """The JAX package's path of the port's leaf at ``path``: the port's
    list indices (its per-layer lists, where JAX stacks layers on leading
    axes) dropped, so ``decoder/0/attn/wq`` reads ``decoder/attn/wq`` and an
    xLSTM state ``decoder/0/m/2/c`` reads ``decoder/m/c``."""
    return "/".join(str(p) for p in path if not isinstance(p, int))


def _match_logical(path: Tuple, shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    # JAX's rule pads its spec with None over the leading dims, and
    # replicates a leaf with fewer dims than the spec.  A leaf of a
    # per-layer list is a JAX leaf without its one or two stacking axes;
    # two are counted, which gives JAX's specs for every config's leaves
    # (no leaf there is two dims shorter than its rule under one stacking
    # axis; `tests/test_torch_sharding.py` compares them all)
    stacked = 2 if any(isinstance(p, int) for p in path) else 0
    ps = path_str(path)
    for pat, spec in _RULES:
        if re.search(pat, ps):
            nlead = len(shape) + stacked - len(spec)
            if nlead < 0:
                return tuple([None] * len(shape))
            return tuple(([None] * nlead + list(spec))[stacked:])
    return tuple([None] * len(shape))  # replicate


def param_pspec(mesh, params_tree: Any, *, verify_divisible: bool = True) -> Any:
    """A :class:`P` per leaf of a parameter tree (tensors, or anything with
    ``.shape``)."""

    def spec_for(path, leaf):
        shape = tuple(leaf.shape)
        logical = _match_logical(path, shape)
        phys = []
        for dim, l in zip(shape, logical):
            ax = physical_axes(mesh, l)
            if ax is None:
                phys.append(None)
            elif verify_divisible and dim % axis_size(mesh, ax) != 0:
                phys.append(None)  # fall back to replication
            else:
                phys.append(ax)
        return P(*phys)

    return tree_map_with_path(spec_for, params_tree)


class NamedSharding(NamedTuple):
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def param_sharding(mesh, params_tree: Any) -> Any:
    return tree_map_with_path(lambda _, spec: NamedSharding(mesh, spec),
                              param_pspec(mesh, params_tree), is_leaf=lambda x: isinstance(x, P))


def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor leaf of ``tree`` placed by the :class:`NamedSharding` at
    the same path of ``shardings`` (JAX's ``device_put``).  Every rank
    holds the same full tensor and keeps its own shard, so nothing is sent;
    a DTensor leaf is redistributed."""
    from torch.distributed.tensor import distribute_tensor

    def place(x, s: NamedSharding):
        if is_dtensor(x):
            return x.redistribute(s.mesh, s.placements)
        return distribute_tensor(x, s.mesh, s.placements, src_data_rank=None)

    def at(tree, path):
        for k in path:
            tree = getattr(tree, k) if hasattr(tree, "_fields") and isinstance(k, str) else tree[k]
        return tree

    return tree_map_with_path(lambda path, x: place(x, at(shardings, path)), tree)
