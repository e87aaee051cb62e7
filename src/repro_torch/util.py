"""Tree helpers for nested dict/list/tuple containers of leaves (the port's
stand-in for `jax.tree_util` on parameter and cache trees), and the hooks
an observer of a run sees (:func:`observe`)."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Iterator, List, Optional, Tuple


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None) -> Tuple[List[Any], Any]:
    """(leaves in a fixed order, structure); dict keys are taken sorted.
    ``is_leaf(node)`` true stops the descent at ``node`` (as in JAX).  The
    structure is plain Python (tuples of strings, lists and None); a named
    tuple is recorded as a tuple."""
    if is_leaf is not None and is_leaf(tree):
        return [tree], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            ls, s = tree_flatten(tree[k], is_leaf)
            leaves += ls
            subs.append(s)
        return leaves, ("dict", keys, subs)
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for x in tree:
            ls, s = tree_flatten(x, is_leaf)
            leaves += ls
            subs.append(s)
        return leaves, ("tuple" if isinstance(tree, tuple) else "list", None, subs)
    return [tree], None


def tree_unflatten(struct: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(keys, subs)}
        items = [build(sub) for sub in subs]
        return tuple(items) if kind == "tuple" else items

    return build(struct)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, struct = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(struct, [fn(*xs) for xs in zip(leaves, *others)])


def tree_map_with_path(fn: Callable, tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None,
                       path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree, keeping its containers (a named tuple
    stays one).  ``path`` is a tuple of keys: a dict key or a named tuple's
    field name as a string, a list or tuple index as an int."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, is_leaf, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        items = [tree_map_with_path(fn, v, is_leaf, path + (i,)) for i, v in enumerate(tree)]
        return tuple(items) if isinstance(tree, tuple) else items
    return fn(path, tree)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor, without importing ``torch.distributed.tensor``
    (a process that never made one has not loaded it)."""
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


# ---------------------------------------------------------------------------
# observation: the kernel launches of a run (`launch.dryrun` counts bytes)
# ---------------------------------------------------------------------------

_OBSERVER: contextvars.ContextVar = contextvars.ContextVar("repro_torch_observer", default=None)


@contextlib.contextmanager
def observe(obs) -> Iterator[Any]:
    """Make ``obs`` see the body's kernel launches on plain tensors:
    ``obs.launch(name, tensors, kw, run)`` (`kernels.ops`), which returns
    ``run()``, the launch itself."""
    token = _OBSERVER.set(obs)
    try:
        yield obs
    finally:
        _OBSERVER.reset(token)


def observer():
    """The observer of the innermost :func:`observe`, or None."""
    return _OBSERVER.get()
