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
manifest unpickles to nothing outside the standard library.  The JAX
package cannot read the port's checkpoints: its ``load`` unpickles a
``PyTreeDef``, which only jax can make.

The port reads a train state the JAX package wrote (a manifest with
``treedef`` bytes and no ``tree``), given the model config and the
optimizer (``load(..., cfg=, opt=)``; the elastic chunk passes both).  The
``treedef`` bytes are never unpickled.  Instead :func:`jax_state_skeleton`
builds the expected state in JAX's layout, shapes and dtype names only:
`bridge.params_to_jax`'s layout of the port's parameters (made in
``FakeTensorMode``, so no weight is allocated), the AdamW moments in the
same stacking, and ``step``, as ``tuple(TrainState)``.  JAX flattens dict
keys sorted and named tuples in field order, as `repro_torch.util.
tree_flatten` does, so leaf ``i`` of the manifest is leaf ``i`` of the
skeleton; every desc's shape and dtype is checked against it, and a
mismatch names the leaf's path.  The leaves are then converted with
`bridge.params_from_jax` and `bridge.moments_from_jax` (which re-blocks
int8 moments where a per-layer leaf is not a multiple of 256 elements).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.bridge import _to_jax_layout, moments_from_jax, params_from_jax
from repro_torch.configs.base import ModelConfig
from repro_torch.storage import ObjectStore
from repro_torch.storage.serialization import dtype_name, from_host, host_array
from repro_torch.util import is_dtensor, tree_flatten, tree_map, tree_unflatten

CHUNK_BYTES = 64 * 1024 * 1024  # bounded object size


def _leaf_key(run: str, version: int, idx: int, chunk: int) -> str:
    return f"ckpt/{run}/v{version:08d}/leaf/{idx:05d}/{chunk:04d}"


def _manifest_key(run: str, version: int) -> str:
    return f"ckpt/{run}/v{version:08d}/manifest"


def _gathered(leaf: Any) -> Any:
    """A DTensor leaf as its full tensor (every rank takes part), so a
    sharded state's checkpoint holds an unsharded run's bytes."""
    return leaf.full_tensor() if is_dtensor(leaf) else leaf


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
    Each leaf is copied to the host once; a sharded (DTensor) leaf is
    gathered first, so every rank of its mesh must call this."""
    leaves, struct = tree_flatten(state)
    descs = []
    chunks: Dict[str, bytes] = {}
    # a backend that writes each put out before returning (files) takes
    # views of the host arrays; the in-memory one keeps references, so it
    # gets a private copy
    zero_copy = getattr(store.backend, "zero_copy_puts", False)
    for i, leaf in enumerate(leaves):
        arr, name = host_array(_gathered(leaf))
        blob = memoryview(arr).cast("B") if zero_copy else arr.tobytes()
        n_chunks = max(1, math.ceil(len(blob) / CHUNK_BYTES))
        for c in range(n_chunks):
            chunks[_leaf_key(run, version, i, c)] = blob[c * CHUNK_BYTES : (c + 1) * CHUNK_BYTES]
        descs.append({"shape": tuple(arr.shape), "dtype": name, "chunks": n_chunks, "idx": i})
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


class LeafSpec:
    """Shape and numpy dtype name of one leaf (a skeleton's leaf)."""

    def __init__(self, shape, dtype: str) -> None:
        self.shape, self.dtype = tuple(int(n) for n in shape), dtype

    @staticmethod
    def stack(specs: List["LeafSpec"]) -> "LeafSpec":
        return LeafSpec((len(specs),) + specs[0].shape, specs[0].dtype)

    def __repr__(self) -> str:
        return f"{self.dtype}{list(self.shape)}"


def jax_state_skeleton(cfg: ModelConfig, opt) -> Tuple[Any, Any]:
    """``(like, state)``: the JAX-layout parameter skeleton and the whole
    ``tuple(TrainState)`` skeleton the JAX package saves for ``cfg`` and the
    AdamW ``opt``, as :class:`LeafSpec` leaves."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import init_params

    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    like = _to_jax_layout(tree_map(lambda t: LeafSpec(t.shape, dtype_name(t.dtype)), fake),
                          cfg, LeafSpec.stack)
    moment_dtype = dtype_name(opt.moment_dtype)

    def moment(p: LeafSpec):
        if opt.quantize_moments:
            blocks = -(-math.prod(p.shape) // 256)
            return {"q": LeafSpec((blocks, 256), "int8"), "scale": LeafSpec((blocks, 1), "float32")}
        return LeafSpec(p.shape, moment_dtype)

    m = tree_map(moment, like)
    # step is 0-d int32, saved with shape (1,) (np.ascontiguousarray)
    return like, (like, (LeafSpec((1,), "int32"), m, m))


def _leaf_paths(tree: Any, path: str = "") -> List[str]:
    """Each leaf's path, in `tree_flatten` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in _leaf_paths(x, f"{path}[{i}]")]
    return [path]


def _from_jax_state(manifest: Dict[str, Any], leaves: List[torch.Tensor], cfg: ModelConfig,
                    opt, device) -> Any:
    like, skeleton = jax_state_skeleton(cfg, opt)
    specs, struct = tree_flatten(skeleton)
    _, (_, m_like, _) = skeleton
    paths = (_leaf_paths(like, "params") + ["opt_state.step"]
             + _leaf_paths(m_like, "opt_state.m") + _leaf_paths(m_like, "opt_state.v"))
    descs = manifest["descs"]
    if len(descs) != len(specs):
        raise ValueError(
            f"JAX checkpoint {manifest['run']} v{manifest['version']} holds {len(descs)} "
            f"leaves; a {cfg.name} train state with this optimizer has {len(specs)}"
        )
    for d, spec, path in zip(descs, specs, paths):
        if tuple(d["shape"]) != spec.shape or d["dtype"] != spec.dtype:
            raise ValueError(
                f"JAX checkpoint {manifest['run']} v{manifest['version']} leaf {d['idx']} "
                f"({path}) is {d['dtype']}{list(d['shape'])}; the {cfg.name} state expects {spec}"
            )
    params, (step, m, v) = tree_unflatten(struct, leaves)
    return (
        params_from_jax(params, cfg, device),
        (step.to(device), moments_from_jax(m, like, cfg, device),
         moments_from_jax(v, like, cfg, device)),
    )


def load(
    store: ObjectStore,
    run: str,
    version: Optional[int] = None,
    *,
    device=None,
    cfg: Optional[ModelConfig] = None,
    opt=None,
    shardings: Optional[Any] = None,
    worker: str = "ckpt",
) -> Tuple[Any, Dict[str, Any], int]:
    """Returns (state, meta, version): the saved tree with tensor leaves on
    ``device`` (the CPU by default).  A version the JAX package wrote is
    read as a train state of model ``cfg`` and optimizer ``opt``, and comes
    back in the port's layout, ``(params, (step, m, v))``.  With
    ``shardings`` (a tree of `models.sharding.NamedSharding` on the
    *reader's* mesh, `launch.shardings.to_shardings`) each leaf is placed
    on that mesh: checkpoint-level resharding for elasticity."""
    if version is None:
        version = latest_version(store, run)
        if version is None:
            raise FileNotFoundError(f"no checkpoints for run '{run}'")
    manifest = store.get(_manifest_key(run, version), worker=worker)
    from_jax = "tree" not in manifest and isinstance(manifest.get("treedef"), bytes)
    if from_jax and (cfg is None or opt is None):
        raise ValueError(
            f"checkpoint {run} v{version} was written by the JAX package: pass cfg= and "
            "opt= to read it as a train state"
        )
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
        leaves.append(leaf.to(device) if device is not None and not from_jax else leaf)
    if from_jax:
        state = _from_jax_state(manifest, leaves, cfg, opt, device or "cpu")
    else:
        state = tree_unflatten(manifest["tree"], leaves)
    if shardings is not None:
        from repro_torch.models.sharding import distribute

        state = distribute(state, shardings)
    return state, manifest["meta"], version


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
