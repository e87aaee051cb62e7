"""Value <-> bytes codecs for the storage layer (port of
`repro.storage.serialization`, with the port's own tree flattening in
place of `jax.tree_util`).

Blobs use the JAX package's header (``RWRN`` + codec number) and codecs.
A tree of dicts, lists, tuples and None over numpy leaves (shuffle
intermediates, sorted partitions) takes the raw codec with JAX's own
descriptor, byte for byte: JAX's ``PyTreeDef`` is written and read through
a stand-in (:class:`_JaxTreeDef`) that pickles under jaxlib's names, so
either package reads what the other wrote and equal values give equal
blobs.  Other trees whose leaves are all numpy arrays or torch tensors use
the raw codec with the port's own tree structure in the descriptor, read by
the port only; anything else is pickled.  A tensor leaf is copied to the
host and written as its numpy array; a bf16 tensor, which numpy cannot hold, is
written as its ``uint16`` bit pattern under the dtype name ``bfloat16`` (the
name numpy gives ``ml_dtypes.bfloat16``, which the JAX package reads).
Leaves come back as ``np.frombuffer`` views, and a ``bfloat16`` leaf as a
CPU bf16 tensor.  The legacy NPZ codec is not carried over.
"""

from __future__ import annotations

import copyreg
import hashlib
import io
import pickle
import struct
import sys
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.util import tree_flatten, tree_unflatten

_MAGIC = b"RWRN"
_CODEC_PICKLE = 1
_CODEC_RAW = 3
_HEADER = struct.Struct("<4sBQ")  # magic, codec, payload length
_LEN = struct.Struct("<Q")


BF16 = "bfloat16"  # the dtype name a bf16 leaf is written under


def _tensor_types() -> tuple:
    """``(torch.Tensor,)`` once torch is loaded, else ``()``: a process that
    never imported torch holds no tensor, and this module does not load it
    (the storage plane runs without torch)."""
    torch = sys.modules.get("torch")
    return (torch.Tensor,) if torch is not None else ()


def dtype_name(dtype: "torch.dtype") -> str:  # noqa: F821
    """The numpy dtype name a tensor of ``dtype`` is written under."""
    import torch

    return BF16 if dtype == torch.bfloat16 else str(torch.empty((), dtype=dtype).numpy().dtype)


# ---------------------------------------------------------------------------
# JAX's descriptor: a PyTreeDef of the default registry, without jax
# ---------------------------------------------------------------------------

_TREEDEF_REF = ("jaxlib._jax.pytree", "PyTreeDef")
_REGISTRY_REF = ("jax._src.tree_util", "default_registry")
# jaxlib's node kinds (PyTreeKind) of the containers the stand-in handles
_LEAF, _NONE, _TUPLE, _LIST, _DICT = 0, 1, 2, 4, 5


class _Registry:
    """Stand-in for ``jax._src.tree_util.default_registry``."""

    def __reduce__(self):
        return _REGISTRY_REF[1]


_REGISTRY = _Registry()


class _JaxTreeDef:
    """Stand-in for jaxlib's ``PyTreeDef`` over the default registry: its
    pickled state is (registry, nodes), the nodes in post-order, each
    ``(kind, arity, node_data, custom, num_leaves, num_nodes)`` with
    ``node_data`` a dict node's sorted keys."""

    def __init__(self, nodes: Optional[List[tuple]] = None) -> None:
        self.nodes = nodes

    def __reduce__(self):
        return (copyreg.__newobj__, (_JaxTreeDef,), (_REGISTRY, self.nodes))

    def __setstate__(self, state) -> None:
        self.nodes = state[1]

    def unflatten(self, leaves: List[Any]) -> Any:
        it, stack = iter(leaves), []
        for kind, arity, data, _custom, _nl, _nn in self.nodes:
            kids = stack[len(stack) - arity:]
            del stack[len(stack) - arity:]
            if kind == _LEAF:
                stack.append(next(it))
            elif kind == _NONE:
                stack.append(None)
            elif kind == _TUPLE:
                stack.append(tuple(kids))
            elif kind == _LIST:
                stack.append(kids)
            elif kind == _DICT:
                stack.append(dict(zip(data, kids)))
            else:
                raise ValueError(f"a JAX tree node of kind {kind} (a named tuple or a "
                                 "registered class) has no counterpart in the port")
        return stack[0]


def _jax_flatten(tree: Any, nodes: List[tuple], leaves: List[Any]) -> Tuple[int, int]:
    """JAX's flatten of ``tree`` over dict (sorted keys), list, tuple and
    None; anything else is a leaf.  Appends the post-order nodes as
    ``PyTreeDef`` pickles them (each a fresh tuple: the pickler memoizes
    by identity) and returns (leaves, nodes) under this one.  Raises
    TypeError at a leaf that is not a numpy array or scalar, and at a
    container JAX registers otherwise (a named tuple, an OrderedDict, a
    defaultdict): such a tree is not written in JAX's raw layout."""
    t = type(tree)
    if tree is None:
        nodes.append(tuple([_NONE, 0, None, None, 0, 1]))
        return 0, 1
    if t in (dict, list, tuple):
        keys = sorted(tree) if t is dict else None
        kids = [tree[k] for k in keys] if t is dict else tree
        n_leaves = n_nodes = 0
        for kid in kids:
            nl, nn = _jax_flatten(kid, nodes, leaves)
            n_leaves, n_nodes = n_leaves + nl, n_nodes + nn
        kind = {dict: _DICT, list: _LIST, tuple: _TUPLE}[t]
        nodes.append(tuple([kind, len(kids), keys, None, n_leaves, n_nodes + 1]))
        return n_leaves, n_nodes + 1
    if not isinstance(tree, (np.ndarray, np.generic)):
        raise TypeError(f"{t.__name__} is not a numpy leaf or a JAX built-in container")
    leaves.append(tree)
    nodes.append(tuple([_LEAF, 0, None, None, 1, 1]))
    return 1, 1


class _JaxPickler(pickle._Pickler):
    """The standard pickler's Python implementation, writing lists as the
    C pickler does (so the bytes are ``pickle.dumps``'s), and the two
    stand-ins under jaxlib's names."""

    _REFS = {id(_JaxTreeDef): _TREEDEF_REF, id(_REGISTRY): _REGISTRY_REF}

    def _batch_appends(self, items, *rest):
        """As the C pickler writes a list: one item as APPEND, more in
        MARK ... APPENDS batches, a last batch of one included."""
        items = list(items)
        if len(items) == 1:
            self.save(items[0])
            self.write(pickle.APPEND)
            return
        for i in range(0, len(items), self._BATCHSIZE):
            self.write(pickle.MARK)
            for x in items[i:i + self._BATCHSIZE]:
                self.save(x)
            self.write(pickle.APPENDS)

    def save_global(self, obj, name=None):
        ref = self._REFS.get(id(obj))
        if ref is None:
            return super().save_global(obj, name)
        self.save(ref[0])
        self.save(ref[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _JaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _REGISTRY_REF:
            return _REGISTRY
        if name == "PyTreeDef" and module.startswith("jaxlib"):
            return _JaxTreeDef
        return super().find_class(module, name)


def _jax_numpy_tree(value: Any):
    """(nodes, contiguous leaves) when JAX would write ``value`` with the raw
    codec and the port can write it the same way: a tree of JAX's built-in
    containers whose leaves (one at least) are all numpy arrays; else
    None."""
    nodes: List[tuple] = []
    leaves: List[Any] = []
    try:
        _jax_flatten(value, nodes, leaves)
    except TypeError:
        return None
    if not leaves:
        return None
    return nodes, [np.ascontiguousarray(np.asarray(l)) for l in leaves]


def _raw_blob(meta: bytes, arrays) -> bytes:
    views = [memoryview(a).cast("B") for a in arrays]
    payload_len = _LEN.size + len(meta) + sum(v.nbytes for v in views)
    head = _HEADER.pack(_MAGIC, _CODEC_RAW, payload_len) + _LEN.pack(len(meta)) + meta
    return b"".join([head, *views])


def _array_leaves(value: Any):
    leaves, struct_ = tree_flatten(value)
    if leaves and all(isinstance(l, (np.ndarray, np.generic, *_tensor_types())) for l in leaves):
        return leaves, struct_
    return None, None


def host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(contiguous host numpy array, numpy dtype name) of an array or tensor
    leaf; a bf16 tensor becomes its ``uint16`` bits under the name
    ``bfloat16``."""
    if isinstance(leaf, _tensor_types()):
        import torch

        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return np.ascontiguousarray(t.view(torch.int16).numpy().view(np.uint16)), BF16
        leaf = t.numpy()
    a = np.ascontiguousarray(leaf)  # as the JAX package: a 0-d leaf becomes (1,)
    return a, str(a.dtype)


def from_host(buf: Any, dtype_name: str, shape) -> Any:
    """Inverse of :func:`host_array` over a bytes-like ``buf``: a numpy view,
    or a CPU bf16 tensor (a copy) for ``bfloat16``."""
    if dtype_name == BF16:
        import torch

        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def dumps(value: Any) -> bytes:
    jax_tree = _jax_numpy_tree(value)
    if jax_tree is not None:  # JAX's bytes
        nodes, arrays = jax_tree
        buf = io.BytesIO()
        _JaxPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(
            (_JaxTreeDef(nodes), [(a.dtype.str, a.shape) for a in arrays]))
        return _raw_blob(buf.getvalue(), arrays)
    leaves, struct_ = _array_leaves(value)
    if leaves is not None:
        arrays, names = zip(*(host_array(leaf) for leaf in leaves))
        meta = pickle.dumps(
            (struct_, [(n, a.shape) for a, n in zip(arrays, names)]),
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        return _raw_blob(meta, arrays)
    payload = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    return _HEADER.pack(_MAGIC, _CODEC_PICKLE, len(payload)) + payload


def loads(blob: Any) -> Any:
    view = memoryview(blob)
    magic, codec, length = _HEADER.unpack_from(view, 0)
    if magic != _MAGIC:
        raise ValueError("bad magic: not a repro-serialized blob")
    payload = view[_HEADER.size : _HEADER.size + length]
    if codec == _CODEC_PICKLE:
        return pickle.loads(payload)
    if codec == _CODEC_RAW:
        (meta_len,) = _LEN.unpack_from(payload, 0)
        struct_, descs = _JaxUnpickler(
            io.BytesIO(payload[_LEN.size : _LEN.size + meta_len])).load()
        off = _LEN.size + meta_len
        leaves = []
        for dtype_str, shape in descs:
            itemsize = 2 if dtype_str == BF16 else np.dtype(dtype_str).itemsize
            nbytes = itemsize * int(np.prod(shape, dtype=np.int64))
            leaves.append(from_host(payload[off : off + nbytes], dtype_str, shape))
            off += nbytes
        if isinstance(struct_, _JaxTreeDef):
            return struct_.unflatten(leaves)
        return tree_unflatten(struct_, leaves)
    raise ValueError(f"unknown codec {codec}")


def digest(blob: Any) -> str:
    return hashlib.sha256(blob).hexdigest()


def content_key(prefix: str, blob: Any) -> str:
    """Deterministic, globally-unique key for a serialized value (PyWren's
    'globally unique keys in S3')."""
    return f"{prefix}/{digest(blob)[:32]}"


def dumps_with_key(prefix: str, value: Any) -> Tuple[str, bytes]:
    blob = dumps(value)
    return content_key(prefix, blob), blob

