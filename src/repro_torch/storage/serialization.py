"""Value <-> bytes codecs for the storage layer (port of
`repro.storage.serialization`, with the port's own tree flattening in
place of `jax.tree_util`).

Blobs use the JAX package's header (``RWRN`` + codec number) and codecs;
the raw codec's descriptor holds the port's own tree structure (JAX's holds
a ``PyTreeDef``), so a raw blob is read by the package that wrote it.  Trees whose leaves are all numpy arrays or
torch tensors use the raw codec (pickled descriptor + each leaf's raw
bytes); anything else is pickled.  A tensor leaf is copied to the host and
written as its numpy array; a bf16 tensor, which numpy cannot hold, is
written as its ``uint16`` bit pattern under the dtype name ``bfloat16`` (the
name numpy gives ``ml_dtypes.bfloat16``, which the JAX package reads).
Leaves come back as ``np.frombuffer`` views, and a ``bfloat16`` leaf as a
CPU bf16 tensor.  The legacy NPZ codec is not carried over.
"""

from __future__ import annotations

import hashlib
import pickle
import struct
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.util import tree_flatten, tree_unflatten

_MAGIC = b"RWRN"
_CODEC_PICKLE = 1
_CODEC_RAW = 3
_HEADER = struct.Struct("<4sBQ")  # magic, codec, payload length
_LEN = struct.Struct("<Q")


BF16 = "bfloat16"  # the dtype name a bf16 leaf is written under


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy dtype name a tensor of ``dtype`` is written under."""
    return BF16 if dtype == torch.bfloat16 else str(torch.empty((), dtype=dtype).numpy().dtype)


def _array_leaves(value: Any):
    leaves, struct_ = tree_flatten(value)
    if leaves and all(isinstance(l, (np.ndarray, np.generic, torch.Tensor)) for l in leaves):
        return leaves, struct_
    return None, None


def host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(contiguous host numpy array, numpy dtype name) of an array or tensor
    leaf; a bf16 tensor becomes its ``uint16`` bits under the name
    ``bfloat16``."""
    if isinstance(leaf, torch.Tensor):
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
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def dumps(value: Any) -> bytes:
    leaves, struct_ = _array_leaves(value)
    if leaves is not None:
        arrays, names = zip(*(host_array(leaf) for leaf in leaves))
        views = [memoryview(a).cast("B") for a in arrays]
        meta = pickle.dumps(
            (struct_, [(n, a.shape) for a, n in zip(arrays, names)]),
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        payload_len = _LEN.size + len(meta) + sum(v.nbytes for v in views)
        head = _HEADER.pack(_MAGIC, _CODEC_RAW, payload_len) + _LEN.pack(len(meta)) + meta
        return b"".join([head, *views])
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
        struct_, descs = pickle.loads(payload[_LEN.size : _LEN.size + meta_len])
        off = _LEN.size + meta_len
        leaves = []
        for dtype_str, shape in descs:
            itemsize = 2 if dtype_str == BF16 else np.dtype(dtype_str).itemsize
            nbytes = itemsize * int(np.prod(shape, dtype=np.int64))
            leaves.append(from_host(payload[off : off + nbytes], dtype_str, shape))
            off += nbytes
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

