"""Storage plane: object store (S3 semantics), KV store (Redis semantics),
shuffle, serialization and the paper-calibrated perf models (copies of
`repro.storage`; ``shuffle`` is imported as a module, as in the JAX
package).

Three substrates behind one API each: the in-memory ``KVStore`` and
``InMemoryBackend`` for one process; the file-backed ``FileKVStore`` and
``FileBackend`` for any number of processes sharing a directory (the JAX
package's on-disk format: a JAX engine and a torch engine can drain one
queue over the same roots); and the ``repro-kvd`` wire tier,
``NetKVStore`` and ``NetBackend``, clients of a daemon
(``python -m repro_torch.storage.net_server``) that JAX and torch clients
share.

Batched data-plane contract: N keys cost one amortized round-trip
(``ObjectStore.get_many``/``put_many``, ``KVStore.mget``/``mset``/
``rpush_many``/``eval_many``, charged once per shard touched on the KV); a
batch fires one ``notify_put`` (object store) or one sequence bump per
touched shard (KV), so waiters wake once per batch.  Every operation is
recorded in a :class:`~repro_torch.storage.object_store.Ledger`."""

from .file_kv import FileKVStore
from .kv_store import DELETE, KVStore, kv_pure
from .net_kv import NetBackend, NetKVStore
from .object_store import FileBackend, InMemoryBackend, Ledger, ObjectStore, OpRecord
from .perf_model import PROFILES, REDIS_2017, S3_2017, StorageProfile
from .serialization import dumps, loads

__all__ = [
    "KVStore",
    "FileKVStore",
    "NetKVStore",
    "NetBackend",
    "DELETE",
    "kv_pure",
    "ObjectStore",
    "InMemoryBackend",
    "FileBackend",
    "Ledger",
    "OpRecord",
    "StorageProfile",
    "PROFILES",
    "S3_2017",
    "REDIS_2017",
    "dumps",
    "loads",
]
