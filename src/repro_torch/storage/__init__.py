"""Storage plane, in memory: object store (S3 semantics), KV store (Redis
semantics), serialization and the paper-calibrated perf models.

Copies of the in-memory parts of `repro.storage`; the file-backed
`FileBackend`/`FileKVStore` and the `repro-kvd` wire tier come with a later
slice (see ROADMAP.md)."""

from .kv_store import DELETE, KVStore, kv_pure
from .object_store import InMemoryBackend, Ledger, ObjectStore, OpRecord
from .perf_model import PROFILES, REDIS_2017, S3_2017, StorageProfile
from .serialization import dumps, loads

__all__ = [
    "KVStore",
    "DELETE",
    "kv_pure",
    "ObjectStore",
    "InMemoryBackend",
    "Ledger",
    "OpRecord",
    "StorageProfile",
    "PROFILES",
    "S3_2017",
    "REDIS_2017",
    "dumps",
    "loads",
]
