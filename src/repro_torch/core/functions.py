"""Stateless functions: serialization, identity, idempotency.

PyWren's central trick: *one* registered Lambda is reused for every user
function by shipping the pickled function + datum through S3 under globally
unique keys, then invoking the generic entry point.  We reproduce exactly
that structure:

  * ``FunctionSpec``  — the pickled callable (content-addressed in the object
    store; identical functions dedupe to one object, the paper's mitigation
    for function-registration latency and code-size limits);
  * ``TaskSpec``      — one invocation = (function key, input key, task id);
    the task id is a *deterministic* hash of function + input + job, which is
    what makes re-execution idempotent;
  * ``run_task``      — the generic container entry point: fetch code, fetch
    datum, execute, publish result atomically (first writer wins).

The result envelope carries success/exception (pickled traceback string) and
per-phase virtual timings, mirroring the paper's Table 2 phase breakdown.

Port of `repro.core.functions`.  The one change: callables are serialized
with the standard library's ``pickle``, not cloudpickle (the card's
machine has no cloudpickle).  ``pickle`` stores a function by its import
path, so a mapped callable must be a module-level function or class
instance, or a ``functools.partial`` of one; a lambda or nested function
raises ``TypeError`` at registration.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pickle
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.storage import ObjectStore, serialization

# Bound on a warm container's deserialized-function cache (entries).
_CODE_CACHE_MAX = 32


@dataclass(frozen=True)
class FunctionSpec:
    """A content-addressed serialized callable."""

    key: str  # object-store key of the pickled callable
    name: str

    @staticmethod
    def register(store: ObjectStore, fn: Callable, *, worker: str = "-") -> "FunctionSpec":
        try:
            blob = pickle.dumps(fn, protocol=pickle.HIGHEST_PROTOCOL)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError(
                f"cannot ship {fn!r}: the runtime pickles functions with the standard "
                "library, which stores them by import path, so a lambda or nested "
                "function cannot be sent; map a module-level function, a module-level "
                f"class instance or a functools.partial of one ({e})"
            ) from e
        key = serialization.content_key("func", blob)
        store.put_bytes(key, blob, worker=worker, if_absent=True)
        return FunctionSpec(key=key, name=getattr(fn, "__name__", "<lambda>"))

    def load(self, store: ObjectStore, *, worker: str = "-") -> Callable:
        return pickle.loads(store.get_bytes(self.key, worker=worker))


@dataclass(frozen=True)
class TaskSpec:
    """One stateless invocation.

    ``epoch`` is the *fencing token* of the attempt holding this spec: 0 in
    the queue (no attempt owns it), assigned from the monotonically
    increasing ``sched/epoch/{task}`` counter at lease time.  Every
    authoritative mutation the attempt makes downstream — heartbeat, result
    publish, complete, release — is checked against the lease record's
    epoch, so a stale attempt (reaped as dead, preempted, or raced by a
    speculative duplicate) is rejected instead of clobbering the current
    attempt's state."""

    task_id: str
    job_id: str
    func_key: str
    func_name: str
    input_key: str
    result_key: str
    attempt: int = 0  # bumped on retry; same result_key (idempotent)
    epoch: int = 0  # fencing token of the owning attempt; 0 = unleased

    @staticmethod
    def make(
        job_id: str, func: FunctionSpec, input_key: str, index: int
    ) -> "TaskSpec":
        h = hashlib.sha256(
            f"{job_id}|{func.key}|{input_key}|{index}".encode()
        ).hexdigest()[:24]
        return TaskSpec(
            task_id=f"{job_id}/t{index:06d}-{h[:8]}",
            job_id=job_id,
            func_key=func.key,
            func_name=func.name,
            input_key=input_key,
            result_key=f"result/{job_id}/{h}",
        )

    def retry(self) -> "TaskSpec":
        return TaskSpec(
            task_id=self.task_id,
            job_id=self.job_id,
            func_key=self.func_key,
            func_name=self.func_name,
            input_key=self.input_key,
            result_key=self.result_key,
            attempt=self.attempt + 1,
            epoch=self.epoch,
        )

    def with_epoch(self, epoch: int) -> "TaskSpec":
        """The leased form of this spec, carrying its fencing token."""
        return dataclasses.replace(self, epoch=epoch)

    def unleased(self) -> "TaskSpec":
        """The queue form of this spec: no owner, epoch 0."""
        return dataclasses.replace(self, epoch=0) if self.epoch else self


@dataclass
class TaskResult:
    task_id: str
    success: bool
    value: Any = None
    error: Optional[str] = None
    phases: Dict[str, float] = field(default_factory=dict)  # virtual seconds
    worker: str = "-"
    attempt: int = 0
    # True when this attempt's result is not the visible one: its epoch was
    # stale at publish time (write suppressed — see TaskSpec.epoch) or a
    # concurrent duplicate won the if_absent publish race first.
    fenced: bool = False


def stage_input(store: ObjectStore, job_id: str, value: Any, *, worker: str = "-") -> str:
    """Place one serialized datum at a content-addressed key."""
    return store.put_content_addressed(f"input/{job_id}", value, worker=worker)


def stage_inputs(
    store: ObjectStore, job_id: str, values: "list[Any]", *, worker: str = "-"
) -> "list[str]":
    """Stage a whole map's input data in one batched write.

    Each datum still gets its own content-addressed key (identical items
    dedupe to one object, preserving ``stage_input``'s idempotency), but
    the batch lands via a single ``put_many_bytes`` — one amortized
    round-trip for N items instead of N modeled PUT requests, the driver-
    side half of the Fig 5/6 request-count fix.  Returns one key per input,
    in order."""
    keyed = [
        serialization.dumps_with_key(f"input/{job_id}", v) for v in values
    ]
    store.put_many_bytes(dict(keyed), worker=worker, if_absent=True)
    return [key for key, _ in keyed]


def run_task(
    store: ObjectStore,
    task: TaskSpec,
    *,
    worker: str = "-",
    setup_vtime: float = 0.0,
    compute_time_fn: Optional[Callable[[float], float]] = None,
    fence: Optional[Callable[[], bool]] = None,
    code_cache: Optional[Dict[str, Callable]] = None,
    input_cache: Optional[Dict[str, Any]] = None,
) -> TaskResult:
    """The generic container entry point (the single registered Lambda).

    Executes the task; returns the result envelope *and* publishes it
    atomically at ``task.result_key``.  A concurrent duplicate (speculative
    copy or lease-expired retry) publishing first simply wins; this copy's
    publish becomes a no-op — the paper's exactly-once-visibility contract.

    ``fence`` is the epoch check: called immediately before the result
    publish, and if it returns False the publish is suppressed and the
    result is marked ``fenced`` — a zombie attempt (lease reaped or
    superseded by a speculative duplicate's lease) cannot clobber the
    current attempt's result.  The fence narrows, rather than replaces, the
    ``if_absent`` first-writer-wins guard: results are deterministic, so
    the residual check-to-publish window is benign.

    ``compute_time_fn`` maps real compute seconds to virtual seconds (the
    Lambda-core calibration used by the paper-figure benchmarks).
    """
    phases: Dict[str, float] = {"setup": setup_vtime}

    ledger = store.ledger

    def _span(op: str):
        before = len(ledger.records())

        class _Ctx:
            def __enter__(self_inner):
                return self_inner

            def __exit__(self_inner, *exc):
                recs = ledger.records()[before:]
                phases[op] = phases.get(op, 0.0) + sum(
                    r.vtime_s for r in recs if r.worker == worker
                )
                return False

        return _Ctx()

    try:
        with _span("fetch_code"):
            # Warm-container code cache (paper §4: container reuse keeps the
            # deserialized function around).  Safe because func keys are
            # content-addressed and immutable — a hit is byte-identical to a
            # re-fetch, it just skips the storage round trip (and its
            # charge: a cached fetch moves no wire bytes).
            fn = code_cache.get(task.func_key) if code_cache is not None else None
            if fn is None:
                fn = pickle.loads(store.get_bytes(task.func_key, worker=worker))
                if code_cache is not None:
                    code_cache[task.func_key] = fn
                    while len(code_cache) > _CODE_CACHE_MAX:
                        code_cache.pop(next(iter(code_cache)))
        with _span("fetch_input"):
            # A worker that leased a batch prefetched all its inputs in one
            # multi-get (already charged there).  The cache holds serialized
            # bytes: deserializing here gives this task a private object, so
            # sibling tasks sharing a content-addressed input can't observe
            # each other's mutations.  Absent entries fall back to an
            # individual fetch.
            if input_cache is not None and task.input_key in input_cache:
                arg = serialization.loads(input_cache[task.input_key])
            else:
                arg = store.get(task.input_key, worker=worker)
        t0 = time.perf_counter()
        value = fn(arg)
        real_compute = time.perf_counter() - t0
        phases["compute"] = (
            compute_time_fn(real_compute) if compute_time_fn else real_compute
        )
        with _span("write_output"):
            result = TaskResult(
                task_id=task.task_id,
                success=True,
                value=value,
                phases=phases,
                worker=worker,
                attempt=task.attempt,
            )
            if fence is not None and not fence():
                result.fenced = True  # stale epoch: suppress the publish
            elif not store.publish_result(task.result_key, result, worker=worker):
                result.fenced = True  # a concurrent duplicate published first
        return result
    except Exception:  # noqa: BLE001 — a task may raise anything
        result = TaskResult(
            task_id=task.task_id,
            success=False,
            error=traceback.format_exc(),
            phases=phases,
            worker=worker,
            attempt=task.attempt,
        )
        # Failures are also published atomically, but under an attempt-scoped
        # key so a later successful attempt can still win the result key.
        store.put(
            f"{task.result_key}.err{task.attempt}", result, worker=worker, if_absent=True
        )
        return result
