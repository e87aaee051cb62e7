"""Value <-> bytes codecs for the storage layer (port of
`repro.storage.serialization`, with the port's own tree flattening in
place of `jax.tree_util`).

Blobs are byte-compatible with the JAX package's pickle and raw codecs: a
``RWRN`` header tags the codec.  Trees whose leaves are all numpy arrays use
the raw codec (pickled descriptor + each leaf's raw bytes; leaves come back
as ``np.frombuffer`` views); anything else is pickled.  The legacy NPZ
codec is not carried over.
"""

from __future__ import annotations

import pickle
import struct
from typing import Any

import numpy as np

from repro_torch.util import tree_flatten, tree_unflatten

_MAGIC = b"RWRN"
_CODEC_PICKLE = 1
_CODEC_RAW = 3
_HEADER = struct.Struct("<4sBQ")  # magic, codec, payload length
_LEN = struct.Struct("<Q")


def _array_leaves(value: Any):
    leaves, struct_ = tree_flatten(value)
    if leaves and all(isinstance(l, (np.ndarray, np.generic)) for l in leaves):
        return leaves, struct_
    return None, None


def dumps(value: Any) -> bytes:
    leaves, struct_ = _array_leaves(value)
    if leaves is not None:
        arrays = [np.ascontiguousarray(np.asarray(leaf)) for leaf in leaves]
        views = [memoryview(a).cast("B") for a in arrays]
        meta = pickle.dumps(
            (struct_, [(a.dtype.str, a.shape) for a in arrays]),
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
            dtype = np.dtype(dtype_str)
            nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
            leaves.append(np.frombuffer(payload[off : off + nbytes], dtype=dtype).reshape(shape))
            off += nbytes
        return tree_unflatten(struct_, leaves)
    raise ValueError(f"unknown codec {codec}")

