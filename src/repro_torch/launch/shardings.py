"""Sharding spec trees for train state, caches, and batches (port of
`repro.launch.shardings`).  Leaf-path rules mirror models/sharding.py's
activation constraints so the placements agree with the in-model `shard`
calls.

The rules take a mesh (a ``DeviceMesh`` or a `sharding.AbstractMesh`) and
trees whose leaves have a ``.shape``.  Paths are read as the JAX package
writes them (`sharding.path_str`: the port's per-layer list indices
dropped), so each regex matches the leaf it matches in JAX's stacked tree.
"""

from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.models.sharding import (
    NamedSharding, P, describe, param_pspec, path_str, physical_axes,
)
from repro_torch.util import tree_map_with_path


def _dp_axes(mesh):
    return physical_axes(mesh, "dp")


def _tp_axis(mesh):
    return physical_axes(mesh, "tp")


def _dp_size(mesh) -> int:
    ax = _dp_axes(mesh)
    if ax is None:
        return 1
    return math.prod(describe(mesh).shape[a] for a in ax)


def _tp_size(mesh) -> int:
    ax = _tp_axis(mesh)
    return describe(mesh).shape[ax] if ax else 1


def batch_pspec(mesh, batch_tree: Any) -> Any:
    dp = _dp_axes(mesh)

    def rule(path, leaf):
        spec = [dp] + [None] * (len(leaf.shape) - 1)
        if leaf.shape[0] % max(_dp_size(mesh), 1) != 0:
            spec[0] = None
        return P(*spec)

    return tree_map_with_path(rule, batch_tree)


def cache_pspec(mesh, cfg: ModelConfig, cache_tree: Any) -> Any:
    """KV caches / SSM states.  Trailing-dims rules by leaf name; leading
    stacking dims are replicated.  Batch==1 long-decode shards sequence over
    dp as well."""
    shape_of = describe(mesh).shape
    dp = _dp_axes(mesh)
    tp = _tp_axis(mesh)
    dp_n, tp_n = _dp_size(mesh), _tp_size(mesh)

    def rule(path, leaf):
        ps = path_str(path)
        shape = leaf.shape
        nd = len(shape)

        def lead(spec):
            return P(*([None] * (nd - len(spec)) + list(spec)))

        def _flat(*axes):
            out = []
            for a in axes:
                if a is None:
                    continue
                out.extend(a if isinstance(a, tuple) else (a,))
            return tuple(out) if out else None

        def _size(ax) -> int:
            if ax is None:
                return 1
            if isinstance(ax, tuple):
                return math.prod(shape_of[a] for a in ax)
            return shape_of[ax]

        def _fit(dim: int, *candidates):
            """First candidate axis (or combo) whose size divides dim."""
            for c in candidates:
                if c is not None and dim % _size(c) == 0 and dim >= _size(c):
                    return c
            return None

        if re.search(r"/(k|v)$", ps):  # (B, S, K, hd)
            B, S, K, hd = shape[-4:]
            kv_tp = tp if (tp and K % tp_n == 0) else None
            if B % dp_n == 0 and B >= dp_n:
                if kv_tp:
                    return lead([dp, None, kv_tp, None])
                return lead([dp, _fit(S, tp), None, None])
            # tiny batch (long-decode): shard sequence over dp (and tp if no heads)
            if kv_tp:
                return lead([None, _fit(S, dp), kv_tp, None])
            return lead([None, _fit(S, _flat(dp, tp), dp, tp), None, None])
        if ps.endswith("c_kv") or ps.endswith("k_pe"):  # (B, S, r)
            B, S = shape[-3], shape[-2]
            if B % dp_n == 0 and B >= dp_n:
                return lead([dp, _fit(S, tp), None])
            return lead([None, _fit(S, _flat(dp, tp), dp, tp), None])
        if ps.endswith("conv"):  # (B, K-1, C)
            B, _, C = shape[-3:]
            bspec = dp if (B % dp_n == 0 and B >= dp_n) else None
            cspec = tp if C % tp_n == 0 else None
            return lead([bspec, None, cspec])
        if ps.endswith("ssm"):  # (B, H, P, N)
            B, H = shape[-4], shape[-3]
            bspec = dp if (B % dp_n == 0 and B >= dp_n) else None
            hspec = tp if H % tp_n == 0 else None
            return lead([bspec, hspec, None, None])
        m_state = re.search(r"/m/(c|n|m)$", ps)
        s_state = re.search(r"/s/(c|n|m|h)$", ps)
        if m_state or s_state:
            # xlstm states, trailing dims (B, H, ...): shard B over dp and
            # H over tp where divisible
            name = (m_state or s_state).group(1)
            rank = {"c": 4, "n": 3, "m": 2}[name] if m_state else 3
            tail = shape[-rank:]
            B, H = tail[0], tail[1]
            bspec = dp if (B % dp_n == 0 and B >= dp_n) else None
            hspec = tp if H % tp_n == 0 else None
            return lead([bspec, hspec] + [None] * (rank - 2))
        return P(*([None] * nd))

    return tree_map_with_path(rule, cache_tree)


def state_pspec(mesh, state_tree: Any) -> Any:
    """TrainState(params, AdamWState(step, m, v)) — params rules applied to
    params and to each moment tree (leaf names match)."""
    return param_pspec(mesh, state_tree)


def to_shardings(mesh, pspec_tree: Any) -> Any:
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), pspec_tree,
                              is_leaf=lambda x: isinstance(x, P))
