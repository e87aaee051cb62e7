"""Lease-driven serving request plane over the KV (the PyWren premise:
clients and engines share only storage).  A copy of
`repro.serve.request_plane` over the port's own storage plane.

Replaces the PR-6-era `store.list("serve/req/")` scan: clients `rpush`
request ids onto a sharded queue and engines lease them with
`blpop`/`lpop_n` — watch-driven wakeups end to end, zero polling.  An
engine heartbeats a lease per in-flight request; if it is SIGKILLed the
lease lapses, a peer's `reap_expired` requeues the id, and the request is
re-served idempotently: greedy/per-request-keyed decode is deterministic,
stream chunks carry offsets so clients dedup replays, and the final
result publishes first-writer-wins.

Keyspace (KV unless noted):
  serve/q/{i}          list   request-id queue, shard ``i`` of ``n_queues``
  serve/lease/{req}    value  {"engine", "expires", "term"}
  serve/stream/{req}   list   {"off": o, "toks": [...]} chunks, then
                              a {"done": total} terminator (advisory
                              ``rpush_nowait`` — the result record below
                              is the authoritative completion signal)
  serve/req/{req}      store  {"prompt": [...], "ts": ..., "max_new": ...}
  serve/done/{req}     store  {"tokens": [...]} — first-writer-wins
"""

from __future__ import annotations

import time
import zlib
from functools import partial
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.storage import DELETE, kv_pure

QUEUE_PREFIX = "serve/q/"
LEASE_PREFIX = "serve/lease/"
STREAM_PREFIX = "serve/stream/"
REQ_PREFIX = "serve/req/"
DONE_PREFIX = "serve/done/"


def request_seed(req_id: str) -> int:
    """Deterministic per-request sampling seed (satellite fix for the
    fixed-PRNGKey engine): same request id -> same stream, which is what
    makes a SIGKILLed engine's re-serve byte-identical at temperature>0."""
    return zlib.crc32(req_id.encode("utf-8"))


def queue_key(i: int) -> str:
    return f"{QUEUE_PREFIX}{i}"


def queue_of(req_id: str, n_queues: int) -> int:
    return zlib.crc32(req_id.encode("utf-8")) % max(1, n_queues)


def lease_key(req_id: str) -> str:
    return f"{LEASE_PREFIX}{req_id}"


def stream_key(req_id: str) -> str:
    return f"{STREAM_PREFIX}{req_id}"


def req_key(req_id: str) -> str:
    return f"{REQ_PREFIX}{req_id}"


def done_key(req_id: str) -> str:
    return f"{DONE_PREFIX}{req_id}"


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

def submit(
    store,
    kv,
    req_id: str,
    prompt: Sequence[int],
    *,
    max_new_tokens: Optional[int] = None,
    n_queues: int = 1,
    worker: str = "client",
) -> str:
    """Write the request body, then enqueue the id (body-before-id means a
    leased id always has a readable body).  Returns the result key."""
    body: Dict[str, Any] = {"prompt": list(prompt), "ts": time.time()}
    if max_new_tokens is not None:
        body["max_new"] = int(max_new_tokens)
    store.put(req_key(req_id), body, worker=worker)
    kv.rpush(queue_key(queue_of(req_id, n_queues)), req_id, worker=worker)
    return done_key(req_id)


def submit_many(
    store,
    kv,
    requests: Dict[str, Sequence[int]],
    *,
    n_queues: int = 1,
    worker: str = "client",
) -> List[str]:
    """Batched submit: one store round-trip for every body, one KV
    round-trip per queue shard touched (each shard's blocked engines wake
    once for the whole batch)."""
    now = time.time()
    store.put_many(
        {req_key(r): {"prompt": list(p), "ts": now} for r, p in requests.items()},
        worker=worker,
    )
    pushes: Dict[str, List[Any]] = {}
    for r in requests:
        pushes.setdefault(queue_key(queue_of(r, n_queues)), []).append(r)
    kv.rpush_many(pushes, worker=worker)
    return [done_key(r) for r in requests]


def stream_result(
    store,
    kv,
    req_id: str,
    *,
    timeout_s: float = 60.0,
    worker: str = "client",
) -> Iterator[List[int]]:
    """Yield token chunks as the engine streams them, deduping replays.

    Chunks are offset-tagged, so a re-serving engine restarting the stream
    at offset 0 (after its predecessor was SIGKILLed) yields nothing the
    client has already seen — decode is deterministic per request, so the
    replayed prefix is byte-identical.  Terminates on the {"done": n}
    marker; since that marker is advisory (``rpush_nowait``), the
    authoritative result record is consulted as a fallback before timing
    out, and any tail the stream never carried is yielded from it."""
    skey, dkey = stream_key(req_id), done_key(req_id)
    deadline = time.monotonic() + timeout_s
    seen = 0  # tokens already yielded
    while True:
        seq = kv.shard_seq(skey)
        total: Optional[int] = None
        for chunk in kv.lrange(skey, worker=worker):
            if "done" in chunk:
                total = int(chunk["done"])
                continue
            off, toks = int(chunk["off"]), list(chunk["toks"])
            if off + len(toks) <= seen:
                continue  # replayed prefix
            fresh = toks[max(0, seen - off):]
            seen = off + len(toks)
            yield fresh
        if total is not None and seen >= total:
            return
        remaining = deadline - time.monotonic()
        if remaining <= 0 or total is not None:
            break  # done-marker with missing chunks, or timed out
        # event-driven wait for the next stream append (bounded slices so
        # the done-record fallback below stays reachable even if every
        # advisory stream append was dropped on a reconnect window).
        kv.wait_key(skey, seq, min(remaining, 1.0))
    # fall back to the authoritative result record (at most once per stream)
    try:
        store.wait_keys([dkey], timeout_s=max(0.05, deadline - time.monotonic()))
    except TimeoutError:
        raise TimeoutError(f"stream {req_id!r}: no result within {timeout_s}s")
    toks = store.get(dkey, worker=worker)["tokens"]
    if len(toks) > seen:
        yield toks[seen:]


def get_results(
    store,
    req_ids: Sequence[str],
    *,
    timeout_s: float = 60.0,
    worker: str = "client",
) -> Dict[str, Any]:
    """Block until every request's result record exists; one batched wait +
    one batched read."""
    keys = [done_key(r) for r in req_ids]
    store.wait_keys(keys, timeout_s=timeout_s)
    got = store.get_many(keys, worker=worker, missing="error")
    return {r: got[done_key(r)] for r in req_ids}


# ---------------------------------------------------------------------------
# engine side: leases (fenced, kv_pure — pickle-by-reference on the wire)
# ---------------------------------------------------------------------------

@kv_pure
def _lease_take(engine: str, now: float, expires: float, cur):
    """First-writer-wins within the expiry window; a lapsed lease is won at
    term+1 (the re-serve is a new term of the same request)."""
    if cur is not None and float(cur["expires"]) > now and cur["engine"] != engine:
        return cur  # live foreign lease: lose
    term = int(cur["term"]) + 1 if cur is not None else 1
    return {"engine": engine, "expires": expires, "term": term}


@kv_pure
def _lease_extend(engine: str, expires: float, cur):
    if cur is None:
        return DELETE  # released/reaped meanwhile: stay absent
    if cur["engine"] != engine:
        return cur  # stolen: do not revive
    return {**cur, "expires": expires}


@kv_pure
def _lease_free(engine: str, cur):
    if cur is None:
        return DELETE
    if cur["engine"] != engine:
        return cur  # not ours anymore
    return DELETE


@kv_pure
def _lease_reap(now: float, out: Dict[str, Any], cur):
    if cur is None:
        return DELETE  # already released
    if cur.get("requeued"):
        return cur  # a peer already requeued it; it awaits re-lease
    if float(cur["expires"]) > now:
        return cur  # revived by a heartbeat since we looked
    out["rec"] = cur
    # tombstone, not DELETE: concurrent reapers requeue exactly once, and
    # the term survives so the re-serving engine takes term+1.
    return {**cur, "expires": 0.0, "requeued": True}


def lease_requests(
    store,
    kv,
    engine_id: str,
    max_n: int,
    *,
    lease_timeout_s: float = 2.0,
    wait_s: float = 0.0,
    n_queues: int = 1,
) -> List[Tuple[str, Dict[str, Any]]]:
    """Pop up to ``max_n`` request ids off the queue shards and fence them.

    ``wait_s > 0`` blocks on the engine's home shard via ``blpop`` when the
    queues are empty — the idle engine parks on the KV watch condition and
    is *pushed* awake by a client's rpush (EVENT001: no sleep loop).  Ids
    whose result already exists are dropped (consumed, not requeued); ids
    whose lease is held live by another engine are dropped likewise.
    Returns [(req_id, body), ...] for the requests this engine now owns."""
    home = queue_of(engine_id, n_queues)
    order = [(home + j) % n_queues for j in range(n_queues)]
    ids: List[str] = []
    for qi in order:
        if len(ids) >= max_n:
            break
        ids.extend(kv.lpop_n(queue_key(qi), max_n - len(ids), worker=engine_id))
    if not ids and wait_s > 0:
        got = kv.blpop(queue_key(home), wait_s, worker=engine_id)
        if got is not None:
            ids = [got]
            ids.extend(kv.lpop_n(queue_key(home), max_n - 1, worker=engine_id))
    ids = list(dict.fromkeys(ids))
    if not ids:
        return []
    served = store.exists_many([done_key(r) for r in ids], worker=engine_id)
    live = [r for r in ids if done_key(r) not in served]
    if not live:
        return []
    now = time.time()
    expires = now + lease_timeout_s
    res = kv.eval_many(
        {lease_key(r): partial(_lease_take, engine_id, now, expires) for r in live},
        worker=engine_id,
    )
    won = [
        r for r in live
        if res[lease_key(r)]["engine"] == engine_id
        and float(res[lease_key(r)]["expires"]) >= expires
    ]
    if not won:
        return []
    bodies = store.get_many([req_key(r) for r in won], worker=engine_id, missing="error")
    return [(r, bodies[req_key(r)]) for r in won]


def heartbeat_leases(
    kv,
    engine_id: str,
    req_ids: Sequence[str],
    *,
    lease_timeout_s: float = 2.0,
) -> None:
    """Extend every in-flight lease in one batched eval."""
    if not req_ids:
        return
    expires = time.time() + lease_timeout_s
    kv.eval_many(
        {lease_key(r): partial(_lease_extend, engine_id, expires) for r in req_ids},
        worker=engine_id,
    )


def release_leases(kv, engine_id: str, req_ids: Sequence[str]) -> None:
    if not req_ids:
        return
    kv.eval_many(
        {lease_key(r): partial(_lease_free, engine_id) for r in req_ids},
        worker=engine_id,
    )


def reap_expired(
    store,
    kv,
    *,
    n_queues: int = 1,
    now: Optional[float] = None,
    worker: str = "reaper",
) -> int:
    """Requeue every request whose lease has lapsed (its engine died
    mid-serve).  The expired-compare-then-DELETE runs atomically per key,
    so concurrent reapers requeue each request exactly once; requests
    whose result landed before the reap are dropped instead of requeued.
    Returns the number requeued."""
    now = time.time() if now is None else now
    keys = kv.scan(LEASE_PREFIX, worker=worker)
    if not keys:
        return 0
    recs = kv.mget(keys, worker=worker)
    expired = {
        k[len(LEASE_PREFIX):]: rec
        for k, rec in zip(keys, recs)
        if rec is not None and float(rec["expires"]) <= now
    }
    if not expired:
        return 0
    served = store.exists_many([done_key(r) for r in expired], worker=worker)
    finished = [r for r in expired if done_key(r) in served]
    if finished:
        # lapsed leases of already-published requests (incl. tombstones a
        # done-filter consumed): drop the record, nothing to requeue
        kv.eval_many(
            {lease_key(r): partial(_lease_free, expired[r]["engine"]) for r in finished},
            worker=worker,
        )
    stale = [
        r for r in expired
        if done_key(r) not in served and not expired[r].get("requeued")
    ]
    if not stale:
        return 0
    outs: Dict[str, Dict[str, Any]] = {r: {} for r in stale}
    kv.eval_many(
        {lease_key(r): partial(_lease_reap, now, outs[r]) for r in stale},
        worker=worker,
    )
    requeue = [r for r in stale if "rec" in outs[r]]
    if requeue:
        pushes: Dict[str, List[Any]] = {}
        for r in requeue:
            pushes.setdefault(queue_key(queue_of(r, n_queues)), []).append(r)
        kv.rpush_many(pushes, worker=worker)
    return len(requeue)


# ---------------------------------------------------------------------------
# engine side: streaming + publish
# ---------------------------------------------------------------------------

def stream_chunks(kv, chunks: Dict[str, Tuple[int, List[int]]], *, worker: str) -> None:
    """Push one offset-tagged chunk per request — a single batched append
    (one round-trip / one wake per KV shard touched), so streaming N live
    slots does not cost N round-trips per chunk boundary."""
    if not chunks:
        return
    kv.rpush_many(
        {stream_key(r): [{"off": off, "toks": toks}] for r, (off, toks) in chunks.items()},
        worker=worker,
    )


def publish_results(
    store,
    kv,
    engine_id: str,
    results: Dict[str, Dict[str, Any]],
) -> None:
    """Finish a set of requests (each record carries at least "tokens"):
    results land first-writer-wins (a zombie predecessor's identical
    replay is silently discarded), the advisory done-markers ride
    fire-and-forget appends, and the leases drop."""
    if not results:
        return
    store.put_many(
        {done_key(r): {**rec, "engine": engine_id} for r, rec in results.items()},
        worker=engine_id,
        if_absent=True,
    )
    for r, rec in results.items():
        kv.rpush_nowait(stream_key(r), {"done": len(rec["tokens"])}, worker=engine_id)
    release_leases(kv, engine_id, list(results))
