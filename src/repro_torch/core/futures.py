"""Futures over storage keys.

A PyWren future is just 'does the result key exist yet?'.  The future does
not talk to workers or the scheduler — completion is signalled purely by the
atomic existence of the result object, so futures survive scheduler restarts
and work across processes (anyone with the store handle can wait).

Event-driven waiting: ``result()``/``wait()`` block on the store's key-watch
condition (see ``ObjectStore.notify_put``) instead of sleep-polling.  A
publish through the same store handle wakes waiters immediately, and a
publish from *another process* over a shared ``FileBackend`` is relayed by
the backend's watch thread — no built-in backend needs a fallback tick
anymore.  The ``poll_s`` parameters are retained for backward compatibility
and force one (counted in ``ObjectStore.fallback_tick_waits``); waiting
over *multiple distinct backends* in one ``wait`` call is the only other
tick user left.

Batched resolution: ``get_all`` waits for every result key, then fetches
all uncached results in a *single* ``ObjectStore.get_many`` — one amortized
round-trip for the whole fan-in instead of one modeled request per future.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.storage import ObjectStore
from repro_torch.storage.object_store import WATCH_FALLBACK_TICK_S

from .functions import TaskResult, TaskSpec

ALL_COMPLETED = "ALL_COMPLETED"
ANY_COMPLETED = "ANY_COMPLETED"
ALWAYS = "ALWAYS"


class ResultFuture:
    def __init__(self, store: ObjectStore, task: TaskSpec) -> None:
        self.store = store
        self.task = task
        self._cached: Optional[TaskResult] = None
        self._seen_done = False  # result key observed present (sticky:
        # publishes are if_absent, so a done future can never un-done)

    @property
    def result_key(self) -> str:
        return self.task.result_key

    def done(self) -> bool:
        if self._cached is not None or self._seen_done:
            return True
        if self.store.backend.exists(self.task.result_key):
            self._seen_done = True
            return True
        return False

    def peek(self) -> Optional[TaskResult]:
        if self._cached is None and self.done():
            self._cached = self.store.get(self.task.result_key)
        return self._cached

    def _unwrap(self, res: TaskResult) -> Any:
        if not res.success:
            raise RuntimeError(
                f"task {self.task.task_id} failed after attempt {res.attempt}:\n{res.error}"
            )
        return res.value

    def result(self, timeout_s: float = 120.0, poll_s: Optional[float] = None) -> Any:
        try:
            self.store.wait_keys(
                [self.task.result_key], timeout_s=timeout_s, poll_s=poll_s
            )
        except TimeoutError:
            raise TimeoutError(
                f"task {self.task.task_id} not done in {timeout_s}s"
            ) from None
        res = self.peek()
        assert res is not None
        return self._unwrap(res)

    def errors(self) -> List[TaskResult]:
        """All published failed attempts (for diagnostics), fetched in one
        batched round-trip."""
        keys = self.store.backend.list(self.task.result_key + ".err")
        got = self.store.get_many(keys, worker="driver")
        return [got[k] for k in keys if k in got]


def wait(
    futures: Sequence[ResultFuture],
    return_when: str = ALL_COMPLETED,
    timeout_s: float = 120.0,
    poll_s: Optional[float] = None,
) -> Tuple[List[ResultFuture], List[ResultFuture]]:
    """PyWren-style wait: returns (done, not_done).  Blocks on the store's
    put notifications, so a completing task re-evaluates the condition
    immediately instead of after a poll interval.  Purely event-driven for
    in-process backends; cross-process backends re-check on the store's
    fallback tick (see ``ObjectStore.watch_tick_s``).

    Each wake re-checks only the still-pending futures, in ONE batched
    existence probe per store handle (``ObjectStore.exists_many``) — a
    completion burst over an N-task map costs O(N) probes total, not
    O(N²) per-key stats (a real round-trip each on a file/network
    backend).  Doneness is sticky on the future (publishes are
    ``if_absent``), so nothing already seen done is ever probed again."""
    deadline = time.monotonic() + timeout_s
    store = futures[0].store if futures else None
    backends = {id(f.store.backend) for f in futures}
    if len(backends) > 1:
        # Watch state is per *backend*; we can only block on one backend's
        # condition, and completions landing in the others never advance
        # its sequence — a fallback re-check tick is required for liveness.
        # (Distinct store handles over one shared backend stay event-driven.)
        tick = WATCH_FALLBACK_TICK_S if poll_s is None else poll_s
    else:
        tick = store.watch_tick_s(poll_s) if store is not None else poll_s
    pending = [f for f in futures if not (f._cached is not None or f._seen_done)]
    seq: Optional[int] = None
    single_store = len({id(f.store) for f in futures}) <= 1 and len(backends) <= 1
    while True:
        landed = None
        if store is not None and single_store and tick is None and seq is not None:
            # Incremental: recent put events name their keys, so pending
            # futures retire with no backend probe at all (puts_since).
            seq, landed = store.puts_since(seq)
        elif store is not None:
            seq = store.put_seq()
        by_store: dict = {}
        for f in pending:
            by_store.setdefault(id(f.store), (f.store, []))[1].append(f)
        still = []
        for st, group in by_store.values():
            if landed is not None:
                present = landed
            else:
                present = st.exists_many(
                    [f.result_key for f in group], worker="driver"
                )
            for f in group:
                if f.result_key in present:
                    f._seen_done = True
                else:
                    still.append(f)
        pending = still
        if (
            return_when == ALWAYS
            or (return_when == ANY_COMPLETED and len(pending) < len(futures))
            or (return_when == ALL_COMPLETED and not pending)
        ):
            done = [f for f in futures if f._cached is not None or f._seen_done]
            not_done = [f for f in futures if not (f._cached is not None or f._seen_done)]
            return done, not_done
        now = time.monotonic()
        if now > deadline:
            raise TimeoutError(
                f"wait timed out with {len(pending)}/{len(futures)} pending"
            )
        remaining = deadline - now
        if store is not None:
            if tick is None:
                store.wait_put(seq, remaining)
            else:
                store.fallback_tick_waits += 1
                store.wait_put(seq, min(tick, remaining))
        else:
            # reprolint: disable=EVENT001(no store handle to watch in the storeless path; bounded fallback tick)
            time.sleep(min(tick or 0.05, remaining))


def get_all(futures: Sequence[ResultFuture], timeout_s: float = 120.0) -> List[Any]:
    """Resolve every future; results in submission order.

    Batched: after the barrier, all uncached results are fetched in one
    ``get_many`` per store handle — the whole fan-in costs one amortized
    round-trip instead of one modeled request per future (the numpywren
    multi-get lesson; dominant for large maps)."""
    wait(futures, ALL_COMPLETED, timeout_s=timeout_s)
    by_store: dict = {}
    for f in futures:
        if f._cached is None:
            by_store.setdefault(id(f.store), (f.store, []))[1].append(f)
    for store, group in by_store.values():
        try:
            fetched = store.get_many(
                [f.result_key for f in group], worker="driver", missing="error"
            )
        except KeyError as e:
            # A result that passed the completion barrier and then vanished
            # means the job was GC'd underneath us — the signature of a
            # zombie driver racing its adopter's finish_job.  Surface the
            # adoption story instead of a bare missing-key error.
            raise RuntimeError(
                f"result {e.args[0]!r} disappeared after completing: the job "
                "was finished (GC'd) by another driver — this handle's lease "
                "was likely adopted after a presumed crash"
            ) from e
        for f in group:
            f._cached = fetched[f.result_key]
    return [f._unwrap(f._cached) for f in futures]
