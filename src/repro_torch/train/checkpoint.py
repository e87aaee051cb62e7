"""Storage-backed checkpoints: the durable state plane of stateless training
(port of `repro.train.checkpoint`, with the JAX package's storage layout).

PyWren contract applied to training state:
  * every checkpoint is an immutable *version*: ``ckpt/<run>/v<NNNNNNNN>/...``;
  * leaves are chunked into objects of at most ``CHUNK_BYTES`` and written
    in one batched put;
  * the version becomes *visible* only when its manifest publishes via
    atomic ``put_if_absent``: a speculative or duplicate trainer task
    racing on the same step writes identical content and loses the publish
    harmlessly;
  * ``latest_version`` scans manifests, so any worker can recover the run
    state from storage alone.

Storage layout (as JAX's):
  ckpt/<run>/v<version>/manifest      {run, version, tree, descs, meta}
  ckpt/<run>/v<version>/leaf/<idx>/<chunk>

Each leaf desc is ``{shape, dtype, chunks, idx}`` with the numpy dtype name
(``bfloat16`` for bf16, whose bytes are its ``uint16`` bits); a 0-d leaf
is stored, and comes back, with shape (1,), as JAX's
``np.ascontiguousarray`` stores it.  Where JAX
pickles its ``PyTreeDef`` into the manifest, the port stores the plain
Python structure of `repro_torch.util.tree_flatten` under ``tree`` (nested
tuples of strings, lists and None; a ``TrainState``/``AdamWState`` is saved
as the plain tuple of its fields, as JAX's ``tuple(state)``), so the
manifest unpickles to nothing outside the standard library.  Reading a
checkpoint the JAX package wrote is not supported: its treedef needs jax,
and its layer stacks differ from the port's per-layer lists.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.storage import ObjectStore
from repro_torch.storage.serialization import from_host, host_array
from repro_torch.util import tree_flatten, tree_unflatten

CHUNK_BYTES = 64 * 1024 * 1024  # bounded object size


def _leaf_key(run: str, version: int, idx: int, chunk: int) -> str:
    return f"ckpt/{run}/v{version:08d}/leaf/{idx:05d}/{chunk:04d}"


def _manifest_key(run: str, version: int) -> str:
    return f"ckpt/{run}/v{version:08d}/manifest"


def save(
    store: ObjectStore,
    run: str,
    version: int,
    state: Any,
    *,
    meta: Optional[Dict[str, Any]] = None,
    worker: str = "ckpt",
) -> bool:
    """Write a checkpoint version; returns True if this call won the publish
    (False = another writer already published this version: idempotent).
    Each leaf is copied to the host once."""
    leaves, struct = tree_flatten(state)
    descs = []
    chunks: Dict[str, bytes] = {}
    for i, leaf in enumerate(leaves):
        arr, dtype_name = host_array(leaf)
        blob = arr.tobytes()  # the in-memory backend keeps references: a private copy
        n_chunks = max(1, math.ceil(len(blob) / CHUNK_BYTES))
        for c in range(n_chunks):
            chunks[_leaf_key(run, version, i, c)] = blob[c * CHUNK_BYTES : (c + 1) * CHUNK_BYTES]
        descs.append({"shape": tuple(arr.shape), "dtype": dtype_name, "chunks": n_chunks, "idx": i})
        del arr, blob
    store.put_many_bytes(chunks, worker=worker)
    manifest = {
        "run": run,
        "version": version,
        "tree": struct,
        "descs": descs,
        "meta": meta or {},
    }
    return store.put(_manifest_key(run, version), manifest, worker=worker, if_absent=True)


def latest_version(store: ObjectStore, run: str) -> Optional[int]:
    keys = store.list(f"ckpt/{run}/")
    versions = sorted(
        int(k.split("/v")[1].split("/")[0]) for k in keys if k.endswith("/manifest")
    )
    return versions[-1] if versions else None


def load(
    store: ObjectStore,
    run: str,
    version: Optional[int] = None,
    *,
    device=None,
    worker: str = "ckpt",
) -> Tuple[Any, Dict[str, Any], int]:
    """Returns (state, meta, version): the saved tree with tensor leaves on
    ``device`` (the CPU by default)."""
    if version is None:
        version = latest_version(store, run)
        if version is None:
            raise FileNotFoundError(f"no checkpoints for run '{run}'")
    manifest = store.get(_manifest_key(run, version), worker=worker)
    blobs = store.get_many_bytes(
        [
            _leaf_key(run, version, d["idx"], c)
            for d in manifest["descs"]
            for c in range(d["chunks"])
        ],
        worker=worker,
    )
    leaves = []
    for d in manifest["descs"]:
        blob = b"".join(
            blobs[_leaf_key(run, version, d["idx"], c)] for c in range(d["chunks"])
        )
        leaf = from_host(blob, d["dtype"], d["shape"])
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(leaf.copy())
        leaves.append(leaf.to(device) if device is not None else leaf)
    return tree_unflatten(manifest["tree"], leaves), manifest["meta"], version


def gc_old_versions(store: ObjectStore, run: str, keep: int = 3) -> int:
    """Delete all but the newest `keep` versions; returns #objects deleted."""
    keys = store.list(f"ckpt/{run}/")
    versions = sorted(
        {int(k.split("/v")[1].split("/")[0]) for k in keys if "/v" in k}
    )
    doomed = versions[:-keep] if keep else versions
    doomed_keys = [
        k for v in doomed for k in store.list(f"ckpt/{run}/v{v:08d}/")
    ]
    if doomed_keys:
        store.delete_many(doomed_keys)
    return len(doomed_keys)
