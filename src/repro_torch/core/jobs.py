"""KV-resident job manifests: driver-crash-tolerant multi-stage jobs.

The scheduler makes the *task* plane stateless — any scheduler handle can lease,
reap, speculate, and GC any task — but the *job* plane (which stages exist,
which barriers passed, what still needs submitting) lived only in the
submitting driver's Python frames.  A driver dying mid-``mapreduce`` left a
half-shuffled job nobody else could finish.  This module puts that last
piece of driver state in the KV, under ``sched/job/{job}/``:

  ============================  ==============================================
  key                           contents
  ============================  ==============================================
  ``sched/job/{j}/manifest``    ``{job, kind, meta, term}`` — job type plus
                                everything needed to re-derive the stage
                                plans (e.g. terasort's input keys and
                                partition count)
  ``sched/job/{j}/stage/{i}``   the stage plan: registered function key/name,
                                staged input keys (in task-index order), the
                                stage's scheduler job id — enough to rebuild
                                the exact ``TaskSpec`` set deterministically
  ``sched/job/{j}/barrier/{i}`` ``{outputs, term}`` — the stage's results in
                                task order, written when the barrier passes;
                                presence means "stage done, outputs final"
  ``sched/job/{j}/driver``      the driver lease: ``{owner, term, expires}``
  ============================  ==============================================

Write discipline (what reprolint FENCE001 and the runtime sanitizer
enforce for this keyspace):

  * manifest / stage / barrier records are **immutable**: every write rides
    :func:`commit_records` — one first-writer-wins ``eval_many`` per batch.
    Two drivers racing the same record (a presumed-dead submitter limping
    on next to its adopter) both proceed with the *stored* value, so they
    submit identical task sets and converge on identical barriers; the
    records carry the writer's ``term`` for observability.
  * the **driver lease** is the one mutable key, and it is term-fenced the
    same way task leases are epoch-fenced: acquisition of an expired lease
    increments ``term`` (the fencing token), heartbeats extend only while
    owner *and* term match, and release keeps the record (expired, term
    intact) so a later adopter still draws a higher term — exactly the
    scheduler's burn-the-epoch rule.  ``time.monotonic()`` expiries compare
    across processes on one machine (CLOCK_MONOTONIC), the same contract
    task leases already rely on.
  * deletion happens in exactly one place: ``Scheduler.finish_job`` scans
    ``sched/job/{job}/`` behind the job's ``sched/finished/`` tombstone —
    the blessed tombstone-then-GC path.

Adoption protocol (driven by ``bsp.adopt_job``):

  1. **detect** — :func:`wait_for_driver_expiry` blocks on the driver key's
     shard watch until the lease is absent or past its expiry (no polling:
     each heartbeat advances the shard sequence and re-arms the wait).
  2. **fence** — :func:`acquire_driver` CASes the lease to the adopter at
     ``term + 1``; the dead driver's in-flight heartbeats now fail.
  3. **replay** — the adopter re-runs the manifest: recorded barriers
     return instantly, unplanned stages are re-planned from ``meta``, and
     planned-but-unfinished stages resubmit only tasks whose result keys
     don't exist (duplicates a dying driver left queued or leased converge
     through the task plane's epoch fencing).
  4. **barrier** — each completed stage writes its barrier record before
     its scheduler state is GC'd, so a crash at any point leaves a
     resumable prefix.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Dict, List, Optional

from repro_torch.storage import KVStore, kv_pure

_JOB = "sched/job/"
_FINISHED = "sched/finished/"  # the scheduler's job tombstone keyspace


def job_finished(kv: KVStore, job_id: str, *, worker: str = "driver") -> bool:
    """True once ``Scheduler.finish_job`` has tombstoned the job — the
    signal an adopter checks before fencing a lease that will never be
    heartbeated again because the job is simply *done*."""
    return kv.get(_FINISHED + job_id, worker=worker) is not None


def manifest_key(job_id: str) -> str:
    return f"{_JOB}{job_id}/manifest"


def driver_key(job_id: str) -> str:
    return f"{_JOB}{job_id}/driver"


def stage_key(job_id: str, idx: int) -> str:
    return f"{_JOB}{job_id}/stage/{idx}"


def barrier_key(job_id: str, idx: int) -> str:
    return f"{_JOB}{job_id}/barrier/{idx}"


# ---------------------------------------------------------------------------
# immutable records: manifest, stage plans, barriers
# ---------------------------------------------------------------------------

# Eval functions are module-level + functools.partial (not closures):
# partials of module functions serialize by reference under plain pickle,
# so a wire-backed KVStore ships a few bytes per eval instead of
# cloudpickling code objects both ways (see repro.storage.net_kv).

@kv_pure
def _first_writer_fn(value: Any, cur: Any) -> Any:
    return value if cur is None else cur


def _first_writer(value: Any):
    return partial(_first_writer_fn, value)


@kv_pure
def _driver_take(owner: str, timeout_s: float, now: float, cur: Optional[dict]) -> dict:
    if cur is None:
        return {"owner": owner, "term": 1, "expires": now + timeout_s}
    if cur.get("owner") == owner:
        rec = dict(cur)
        rec["expires"] = now + timeout_s
        return rec
    if float(cur.get("expires", 0.0)) <= now:
        return {
            "owner": owner,
            "term": int(cur.get("term", 0)) + 1,
            "expires": now + timeout_s,
        }
    return cur  # live foreign driver keeps it


@kv_pure
def _driver_extend(
    owner: str, term: int, expires: float, extended: dict, job_id: str,
    cur: Optional[dict],
):
    if cur is None:
        return None  # job GC'd: leave the key absent
    if cur.get("owner") != owner or int(cur.get("term", 0)) != term:
        return cur  # fenced: an adopter holds a higher term
    rec = dict(cur)
    rec["expires"] = expires
    extended[job_id] = True
    return rec


@kv_pure
def _driver_release(owner: str, term: int, out: dict, cur: Optional[dict]):
    if cur is None:
        return None
    if cur.get("owner") != owner or int(cur.get("term", 0)) != term:
        return cur
    rec = dict(cur)
    rec["expires"] = 0.0
    out["ok"] = True
    return rec


def commit_records(
    kv: KVStore, records: Dict[str, Any], *, worker: str = "driver"
) -> Dict[str, Any]:
    """THE manifest write path: land every record in one first-writer-wins
    ``eval_many`` (one pipelined transaction round-trip per shard touched).
    Returns the *stored* value per key — callers must proceed with these,
    not their inputs, so a lost race converges instead of diverging."""
    if not records:
        return {}
    return kv.eval_many(
        {k: _first_writer(v) for k, v in records.items()}, worker=worker
    )


def read_manifest(kv: KVStore, job_id: str, *, worker: str = "driver") -> Optional[dict]:
    return kv.get(manifest_key(job_id), worker=worker)


def read_stage(kv: KVStore, job_id: str, idx: int, *, worker: str = "driver") -> Optional[dict]:
    return kv.get(stage_key(job_id, idx), worker=worker)


def read_barrier(kv: KVStore, job_id: str, idx: int, *, worker: str = "driver") -> Optional[dict]:
    return kv.get(barrier_key(job_id, idx), worker=worker)


# ---------------------------------------------------------------------------
# the driver lease (term-fenced, mirroring task-lease epoch fencing)
# ---------------------------------------------------------------------------

def acquire_driver(
    kv: KVStore,
    job_id: str,
    owner: str,
    timeout_s: float,
    *,
    worker: str = "driver",
) -> Optional[dict]:
    """Take (or extend) the job's driver lease.  One atomic eval:

      * absent            → install at term 1;
      * already ours      → extend the expiry, same term;
      * expired / released → take over at ``term + 1`` (the fence);
      * live foreign owner → no-op.

    Returns the stored record — callers check ``rec["owner"] == owner`` to
    learn whether they hold the lease (two adopters racing a takeover both
    see the single winner's record)."""
    now = time.monotonic()
    return kv.eval(
        driver_key(job_id), partial(_driver_take, owner, timeout_s, now), worker=worker
    )


def heartbeat_drivers(
    kv: KVStore,
    owned: Dict[str, int],
    owner: str,
    timeout_s: float,
    *,
    worker: str = "driver",
) -> List[str]:
    """Extend every held driver lease in ONE ``eval_many`` (the control
    loop calls this every tick; per-job evals would be per-key round-trips).
    A lease is extended only while this owner still holds the recorded term
    — a takeover (higher term) or job GC (key gone) fences the extension.
    Returns the job ids whose lease was NOT extended (lost or finished)."""
    if not owned:
        return []
    expires = time.monotonic() + timeout_s
    extended: Dict[str, bool] = {}
    updates = {
        driver_key(j): partial(_driver_extend, owner, t, expires, extended, j)
        for j, t in owned.items()
    }
    kv.eval_many(updates, worker=worker)
    return [j for j in owned if not extended.get(j)]


def release_driver(
    kv: KVStore, job_id: str, owner: str, term: int, *, worker: str = "driver"
) -> bool:
    """Give the lease up cleanly: expire the record but KEEP it (term and
    all) so the next acquisition still draws ``term + 1`` — deleting it
    would reset the term counter and let a zombie's stale term collide with
    a fresh owner's.  The record itself is removed only by the job's
    tombstoned GC (``Scheduler.finish_job``)."""
    out: Dict[str, bool] = {}
    kv.eval(driver_key(job_id), partial(_driver_release, owner, term, out), worker=worker)
    return bool(out.get("ok"))


def driver_record(kv: KVStore, job_id: str, *, worker: str = "driver") -> Optional[dict]:
    return kv.get(driver_key(job_id), worker=worker)


def _driver_state(kv: KVStore, job_id: str, worker: str) -> Optional[dict]:
    return kv.get(driver_key(job_id), worker=worker)


def wait_for_driver_expiry(
    kv: KVStore,
    job_id: str,
    timeout_s: Optional[float] = None,
    *,
    worker: str = "driver",
) -> bool:
    """Block until the job's driver lease is absent, released, or past its
    expiry — the adoption trigger.  Event-driven *and* deadline-bounded:
    each pass snapshots the driver key's shard sequence, then waits until
    the recorded expiry instant (a live driver's heartbeat advances the
    sequence and re-arms the wait; a dead driver's silence lets the wait
    run out exactly at the expiry).  Returns False only if ``timeout_s``
    elapses with the lease still live."""
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    key = driver_key(job_id)
    while True:
        seq = kv.shard_seq(key)
        rec = _driver_state(kv, job_id, worker)
        now = time.monotonic()
        if rec is None or float(rec.get("expires", 0.0)) <= now:
            return True
        wake_at = float(rec["expires"])
        if deadline is not None:
            if now >= deadline:
                return False
            wake_at = min(wake_at, deadline)
        kv.wait_key(key, seq, max(wake_at - now, 0.001) + 0.01)
