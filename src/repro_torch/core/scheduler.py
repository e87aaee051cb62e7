"""Stateless scheduler handle: queue, fenced epoch leases, retries,
quantile-adaptive straggler speculation — all authoritative state in the KV.

The paper's architecture (Fig 1) has a *global scheduler* dispatching
stateless functions to containers.  We take the paper at its word: the
scheduler is not a stateful server but a **handle over the KV store** — any
number of ``Scheduler`` objects (in one process or, over
``FileKVStore``/``FileBackend``, in many) may submit, lease, reap,
speculate, and GC the *same* job concurrently, and any of them can be
restarted at any time and recover from storage, the same property the
paper demands of workers.

Epoch-fencing protocol (the exactly-once-per-attempt contract):
  * ``sched/epoch/{task}`` — a monotonically increasing counter (KV
    ``incr``), the *fencing-token generator*.  Each lease acquisition draws
    the next epoch; a release-invalidated epoch is also burned here.
  * ``sched/lease/{task}`` — the **single source of truth** for the current
    attempt: ``{worker, epoch, expires, started, attempt, spec}``.  The
    spec rides inside the record so *any* handle (including one that never
    saw the submit) can requeue or speculate the task.
  * every authoritative mutation is an epoch-compared ``eval`` (Redis
    server-side script analogue) on the lease record, atomic under the
    shard lock — machine-wide for ``FileKVStore``:
      - ``heartbeat`` extends ``expires`` only if the caller's epoch is
        current;
      - ``complete``/``release`` delete the record only if the epoch is
        current (compare-then-``DELETE`` in one eval) — a stale attempt's
        complete pushes no duration sample and frees nothing;
      - ``reap`` re-checks both epoch *and* expiry inside the eval, so a
        heartbeat landing between the scheduler's read and its delete
        keeps the lease alive;
      - the worker's **result publish** is fenced too: ``run_task`` calls
        back into :meth:`Scheduler.owns_lease` immediately before
        ``publish_result``, so a zombie (presumed-dead worker whose lease
        was reaped, or a straggler superseded by a speculative duplicate's
        lease) cannot clobber the owning attempt's result.
    Two handles racing the same transition: exactly one eval wins; the
    loser observes a mismatch and does nothing.  That is what makes
    concurrent ``reap``/``speculate`` from N drivers safe.
  * job state is KV-resident as well: ``sched/jobtasks/{job}`` (task-id
    membership, written with the submit push), ``sched/specmark/{task}``
    (``setnx`` speculation marks — two drivers cannot double-duplicate),
    and ``sched/finished/{job}`` (GC tombstones, written *before* the
    state deletes so a concurrent lease in any process observes them).

Local heaps are **rebuildable caches**, never authority: ``_try_lease``
pushes ``(expires, task_id)`` / ``(started, task_id)`` hints, and a
time-gated ``kv.scan("sched/lease/")`` (``_maybe_refresh_index``, at most
once per lease timeout) folds in leases granted through *other* handles —
so if a peer driver dies, this one's reaper picks up its expired leases.
Every hint is lazily re-validated against the KV record before acting
(extended leases are re-pushed with their real expiry; completed ones are
dropped): the heaps are not
"indexes of my state" but "hints about shared state".

Straggler speculation (paper §3.1) is now **quantile-adaptive** by
default: a task is duplicated when its elapsed time exceeds
``max(min_speculation_age_s, speculation_k × q(speculation_quantile))``
over its job's completed-duration distribution (``sched/durations/{job}``)
— the tail quantile tracks the job's own spread instead of a static
multiple of the median, so tight distributions speculate aggressively and
naturally long-tailed ones don't thrash.  Setting the legacy
``speculation_factor`` restores the old ``factor × median`` rule
(``benchmarks/microbench.py speculation_sweep`` measures both).

Notification contract (event-driven control plane):
per-shard queue watch for ``lease_batch`` (any producer's ``rpush``
through the shared KV wakes waiting workers — now including producers in
other *processes* via ``FileKVStore``'s watch thread), an in-process
activity event for the control loop, and a deadline-based
``next_wakeup_s`` fallback tick bounded by the earliest hinted lease
expiry.
"""

from __future__ import annotations

import heapq
import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from functools import partial
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch.storage import DELETE, KVStore, ObjectStore, kv_pure

from .functions import TaskSpec

_Q = "sched/queue"
_LEASE = "sched/lease/"
_ATTEMPTS = "sched/attempts/"
_DURATION = "sched/durations/"  # per-job list: sched/durations/<job_id>
_EPOCH = "sched/epoch/"  # fencing-token generator: sched/epoch/<task_id>
_SPECMARK = "sched/specmark/"  # speculation dedupe marks (setnx)
_FINISHED = "sched/finished/"  # per-job GC tombstones
_JOBTASKS = "sched/jobtasks/"  # per-job task-id membership list
_SPECCOUNT = "sched/speccount/"  # per-job duplicates enqueued (budget gate)
_FENCED = "sched/fenced/"  # per-job fenced-zombie completions (feedback)
_JOBMANIFEST = "sched/job/"  # job manifests + driver leases (core/jobs.py)

# Cap for an untimed lease wait; workers are woken by writes/wake_workers,
# so this only bounds how long a fully idle, never-notified wait can hold.
_UNBOUNDED_WAIT_S = 3600.0

# Finished-job tombstones cached locally before FIFO eviction (the KV
# tombstone stays authoritative; the local set only saves the exists probe).
_MAX_TOMBSTONES = 1024


# ---------------------------------------------------------------------------
# KV eval functions (hot path).  Module-level + functools.partial rather
# than closures: partials of module functions serialize by REFERENCE under
# plain pickle, so a wire-backed KVStore ships a few bytes per eval instead
# of cloudpickling a code object both ways.  Captured-dict outputs (``out``)
# ride as partial args; the eval replay contract lands their mutations on
# the caller's side exactly as a closure would.
# ---------------------------------------------------------------------------

@kv_pure
def _incr_counter(cur: object) -> int:
    return int(cur or 0) + 1


@kv_pure
def _decr_counter(cur: object) -> int:
    return int(cur or 0) - 1


@kv_pure
def _lease_install(record: dict, cur: Optional[dict]) -> dict:
    # Two handles can pop duplicate queue entries of one task concurrently;
    # the higher epoch wins the record (it fenced the lower at the epoch
    # counter), never the later writer.
    if cur is not None and int(cur.get("epoch", 0)) > record["epoch"]:
        return cur
    return record


@kv_pure
def _lease_drop(
    epoch: int,
    require_expired_before: Optional[float],
    out: dict,
    cur: Optional[dict],
):
    if cur is None:
        return DELETE  # nothing to drop (key untouched)
    if epoch and int(cur.get("epoch", 0)) != epoch:
        return cur  # fenced: a different attempt owns the task
    if require_expired_before is not None and cur["expires"] > require_expired_before:
        return cur  # extended in the meantime: not reapable
    out["rec"] = cur
    return DELETE


@kv_pure
def _lease_extend(epoch: int, expires: float, out: dict, cur: Optional[dict]):
    if cur is None:
        return DELETE  # no record: leave the key absent
    if epoch and int(cur.get("epoch", 0)) != epoch:
        return cur  # fenced
    cur = dict(cur)
    cur["expires"] = expires
    out["ok"] = True
    return cur


@kv_pure
def _fenced_decay(decay: float, v: object):
    cur = float(v or 0) - decay
    return cur if cur > 1e-9 else DELETE


@kv_pure
def _probe_keep(out: dict, cur):
    # Read-only probe riding an eval_many batch: reports the stored value
    # without changing presence (DELETE on an absent key is a no-op pop, so
    # the key stays absent; a present value is stored back unchanged).
    if cur is None:
        return DELETE
    out["rec"] = cur
    return cur


def quantile(samples: List[float], q: float) -> float:
    """Upper empirical quantile (nearest-rank): smallest sample with at
    least ``q`` of the distribution at or below it."""
    s = sorted(samples)
    rank = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
    return s[rank]


@dataclass
class SchedulerConfig:
    """Knobs for leases, retries, and straggler speculation.

    Speculation threshold (elapsed time before a running task gets a
    duplicate enqueued):

      * default (``speculation_factor=None``): the quantile rule
        ``max(min_speculation_age_s, speculation_k × q(speculation_quantile))``
        over the job's completed durations — adaptive to each job's own
        distribution;
      * legacy (``speculation_factor=f``): ``max(min_age, f × median)``,
        the static PR-1/2 rule, kept for comparability and for the
        microbench sweep.

    ``min_speculation_age_s`` floors both rules: with no-op tasks the
    distribution is microseconds wide and a millisecond-scale threshold
    would duplicate any task that merely hit a scheduler blip.

    The duplicate *budget* (``speculation_budget_frac``) caps how many
    duplicates one job may ever enqueue — ``max(1, frac × job size)`` —
    across every driver (the count is a shared KV counter), so a sick job
    cannot turn the cluster into a duplicate factory.  And fenced zombies
    feed back: every attempt whose completion was fenced (it had been
    reaped or superseded while actually still running) multiplies the
    job's threshold by ``(1 + speculation_zombie_backoff × count)`` — a
    job that keeps producing zombies was speculating on tasks that were
    *alive*, so its threshold was too tight, and backing it off stops the
    thrash.

    The backoff also *heals*: each subsequent completion that wins its
    fence un-fenced decays the job's zombie counter by
    ``speculation_zombie_decay`` (deleting the key at zero), so a
    transient blip — one slow heartbeat that fenced a batch of live
    attempts — doesn't suppress speculation for the rest of a long job.
    Set the decay to 0 to keep the counter sticky (the pre-decay
    behavior).
    """

    lease_timeout_s: float = 1.0
    max_attempts: int = 4
    speculation_factor: Optional[float] = None
    speculation_quantile: float = 0.95
    speculation_k: float = 1.5
    min_completed_for_speculation: int = 5
    min_speculation_age_s: float = 0.05
    speculation_budget_frac: float = 0.10
    speculation_zombie_backoff: float = 1.0
    speculation_zombie_decay: float = 1.0
    heartbeat_interval_s: float = 0.2
    idle_tick_s: float = 0.5  # control-loop fallback when no work in flight
    # Job-manifest driver lease (sched/job/{job}/driver): how long a job
    # survives without a driver heartbeat before adopters may take over.
    # Must comfortably exceed the control-loop cadence; the executor
    # heartbeats registered jobs at most every driver_lease_timeout_s / 4.
    driver_lease_timeout_s: float = 2.0

    def straggler_threshold_s(self, durations: List[float], fenced: int = 0) -> float:
        if self.speculation_factor is not None:
            base = self.speculation_factor * quantile(durations, 0.5)
        else:
            base = self.speculation_k * quantile(durations, self.speculation_quantile)
        backoff = 1.0 + self.speculation_zombie_backoff * max(0, fenced)
        return max(base, self.min_speculation_age_s) * backoff

    def speculation_budget(self, n_tasks: int) -> int:
        """Max duplicates a job of ``n_tasks`` may enqueue (≥ 1 so small
        jobs can still hedge one straggler)."""
        return max(1, int(self.speculation_budget_frac * n_tasks))


class Scheduler:
    """A stateless handle over shared scheduler state in the KV.

    Construct as many as you like over the same ``kv``/``store`` pair —
    including in other processes via ``FileKVStore``/``FileBackend``.  All
    mutating operations are epoch-fenced KV transactions (module
    docstring), so handles cannot corrupt each other; the in-memory fields
    below are caches and advisory counters only."""

    def __init__(
        self,
        kv: KVStore,
        store: ObjectStore,
        config: Optional[SchedulerConfig] = None,
    ) -> None:
        self.kv = kv
        self.store = store
        self.config = config or SchedulerConfig()
        self._lock = threading.Lock()
        # Spec cache (authoritative copy rides in queue entries and lease
        # records): serves pending() and avoids KV reads on requeue paths.
        self._specs: Dict[str, TaskSpec] = {}
        self._speculated: set = set()  # local mirror of sched/specmark/*
        self._jobs: Dict[str, Set[str]] = {}  # cache of sched/jobtasks/*
        # Local mirror of sched/finished/* tombstones (bounded FIFO): saves
        # the per-lease KV probe for jobs this handle already saw finish.
        self._finished_jobs: Set[str] = set()
        self._finished_order: Deque[str] = deque()
        # Jobs this handle saw fence a zombie: gates the decay eval in
        # complete() so the common zero-fenced path pays no extra KV op.
        self._fenced_hint: Set[str] = set()
        # Per-job (durations, fenced-zombie count) cache for speculate():
        # one KV read set per heartbeat interval per job, not one per
        # control-loop pass.  Entries: (read_at, durations, fenced).
        self._dur_cache: Dict[str, Tuple[float, List[float], int]] = {}
        # Lease-index caches (lazy heaps; see module docstring).  Guarded by
        # self._lock.  KV lease records remain the source of truth.
        self._lease_heap: List[Tuple[float, str]] = []  # (expires, task_id)
        self._start_heaps: Dict[str, List[Tuple[float, str]]] = {}
        self._hinted: Set[str] = set()  # task_ids with a live expiry hint
        self._last_index_refresh = 0.0
        # Event plane (in-process; see module docstring for the contract).
        self._activity_evt = threading.Event()
        # Advisory count of leases granted through *this* handle — drives
        # the control loop's fallback tick only, never correctness.
        self._active_leases = 0

    # ---- event plane ----------------------------------------------------
    def _signal_work(self) -> None:
        """Producers made the queue non-empty.  Worker wakeups already
        happened inside the queue ``rpush`` (per-shard notify); this only
        arms the control-loop activity event."""
        self._activity_evt.set()

    def wake_workers(self) -> None:
        """Wake workers blocked on the queue shard (virtual touch) so they
        re-check stop predicates."""
        self.kv.notify_key(_Q)

    def signal_activity(self) -> None:
        """Wake the control loop (used by executor shutdown too)."""
        self._activity_evt.set()

    def clear_activity(self) -> None:
        self._activity_evt.clear()

    def wait_activity(self, timeout_s: float) -> bool:
        return self._activity_evt.wait(timeout_s)

    def next_wakeup_s(self) -> float:
        """Deadline-based fallback tick for the control loop.  While leases
        are outstanding — this handle's or, via index hints, any handle's —
        sleep until the earliest hinted expiry (capped at heartbeat
        granularity so straggler detection still runs); while work is merely
        queued, heartbeat granularity; otherwise idle long."""
        now = time.monotonic()
        with self._lock:
            busy = self._active_leases > 0 or bool(self._lease_heap)
            next_expiry = self._lease_heap[0][0] if self._lease_heap else None
        if busy or self.queue_depth() > 0:
            tick = min(
                self.config.heartbeat_interval_s,
                max(self.config.lease_timeout_s / 4.0, 0.01),
            )
            if next_expiry is not None:
                tick = min(tick, max(next_expiry - now, 0.01))
            return tick
        return self.config.idle_tick_s

    # ---- submission -----------------------------------------------------
    def _index_tasks(self, tasks: List[TaskSpec]) -> None:
        with self._lock:
            for t in tasks:
                self._specs[t.task_id] = t
                self._jobs.setdefault(t.job_id, set()).add(t.task_id)

    def submit(self, task: TaskSpec) -> None:
        self.submit_many([task])

    def submit_many(self, tasks: List[TaskSpec]) -> None:
        """Batch-submit: the task list and the per-job membership index
        land in one pipelined push (``KVStore.rpush_many`` — one round-trip
        and one coalesced wakeup per shard touched).  Membership in
        ``sched/jobtasks/{job}`` is what lets *any* handle GC the job."""
        if not tasks:
            return
        self._index_tasks(tasks)
        pushes: Dict[str, List] = {_Q: [t.unleased() for t in tasks]}
        for t in tasks:
            pushes.setdefault(_JOBTASKS + t.job_id, []).append(t.task_id)
        self.kv.rpush_many(pushes, worker="scheduler")
        self._signal_work()

    # ---- fenced lease transactions --------------------------------------
    def _job_finished(self, job_id: str) -> bool:
        """Has any handle GC'd this job?  Local tombstone cache first, then
        the authoritative KV tombstone (cached on hit)."""
        with self._lock:
            if job_id in self._finished_jobs:
                return True
        if self.kv.get(_FINISHED + job_id, worker="scheduler") is None:
            return False
        self._remember_finished(job_id)
        return True

    def _jobs_finished(self, job_ids: Set[str]) -> Set[str]:
        """Batched :meth:`_job_finished`: ONE ``mget`` for every job id the
        local tombstone cache can't answer (a lease batch is per-round-trip
        sensitive on wire substrates — per-task gets were the single
        hottest op on the net backend's map path)."""
        finished: Set[str] = set()
        unknown: List[str] = []
        with self._lock:
            for j in job_ids:
                if j in self._finished_jobs:
                    finished.add(j)
                else:
                    unknown.append(j)
        if unknown:
            vals = self.kv.mget(
                [_FINISHED + j for j in unknown], worker="scheduler"
            )
            for j, v in zip(unknown, vals):
                if v is not None:
                    self._remember_finished(j)
                    finished.add(j)
        return finished

    def _remember_finished(self, job_id: str) -> None:
        with self._lock:
            if job_id not in self._finished_jobs:
                self._finished_jobs.add(job_id)
                self._finished_order.append(job_id)
                while len(self._finished_order) > _MAX_TOMBSTONES:
                    self._finished_jobs.discard(self._finished_order.popleft())

    def _fenced_drop_lease(
        self,
        task_id: str,
        epoch: int,
        worker: str,
        *,
        require_expired_before: Optional[float] = None,
    ) -> Tuple[bool, Optional[dict]]:
        """Atomically delete the lease record iff the caller's epoch is
        current (and, for reaping, iff it is still expired at the given
        instant — a heartbeat racing the reaper keeps the lease).  Epoch 0
        is the legacy unfenced wildcard.  Returns (won, record)."""
        out: Dict[str, dict] = {}
        self.kv.eval(
            _LEASE + task_id,
            partial(_lease_drop, epoch, require_expired_before, out),
            worker=worker,
        )
        rec = out.get("rec")
        if rec is not None:
            with self._lock:
                self._active_leases = max(0, self._active_leases - 1)
                self._hinted.discard(task_id)
        return rec is not None, rec

    def owns_lease(self, task: TaskSpec) -> bool:
        """Is ``task.epoch`` still the current attempt?  This is the fence
        ``run_task`` checks immediately before publishing a result."""
        rec = self.kv.get(_LEASE + task.task_id, worker="scheduler")
        if rec is None:
            return False
        return task.epoch == 0 or int(rec.get("epoch", 0)) == task.epoch

    # ---- worker protocol --------------------------------------------------
    def _try_lease(self, worker: str) -> Optional[TaskSpec]:
        """Non-blocking: pop a task and take a fenced lease, or None."""
        batch = self._try_lease_batch(worker, 1)
        return batch[0] if batch else None

    def _try_lease_batch(self, worker: str, max_n: int) -> List[TaskSpec]:
        """Non-blocking: pop up to ``max_n`` tasks and take fenced leases,
        in THREE pipelined KV round-trips per batch — ``lpop_n`` (one queue
        transaction), one ``eval_many`` drawing every attempt counter and
        fencing epoch, one ``eval_many`` installing every lease record —
        plus one batched result-existence probe.  The pre-PR-5 path paid
        four round-trips per *task*; on a file substrate each round-trip is
        a real disk transaction, so batch leasing is what keeps worker
        wake-to-running latency flat as batches widen.  Fencing semantics
        are unchanged: every lease still draws its own epoch and installs
        via the same higher-epoch-wins CAS, and a lost install race refunds
        the attempt charge exactly as before."""
        while True:
            popped: List[TaskSpec] = self.kv.lpop_n(_Q, max_n, worker=worker)
            if not popped:
                return []
            # A batch can pop two queue entries of ONE task (a straggler and
            # its speculative duplicate): one lease is enough, the extra
            # entry is simply consumed.
            seen: Set[str] = set()
            live: List[TaskSpec] = []
            gone = self._jobs_finished({t.job_id for t in popped})
            for t in popped:
                if t.task_id in seen or t.job_id in gone:
                    continue  # stale duplicate of a GC'd job: drop, don't resurrect
                seen.add(t.task_id)
                live.append(t)
            if not live:
                continue

            counters: Dict[str, Callable] = {}
            for t in live:
                counters[_ATTEMPTS + t.task_id] = _incr_counter
            for t in live:
                counters[_EPOCH + t.task_id] = _incr_counter
            res = self.kv.eval_many(counters, default=0, worker=worker)
            # Result-existence probe, for RETRIES AND DUPLICATES ONLY (one
            # batched round-trip): a first attempt (attempts == 1) cannot
            # have a published result — releases refund their charge and GC
            # tombstones drop stale entries above — so the common fresh-task
            # path skips the probe entirely.
            maybe_done = [
                t for t in live if int(res[_ATTEMPTS + t.task_id]) > 1
            ]
            done = (
                self.store.backend.exists_many([t.result_key for t in maybe_done])
                if maybe_done
                else set()
            )
            now = time.monotonic()
            expires = now + self.config.lease_timeout_s
            candidates = []
            installs: Dict[str, Callable] = {}
            for t in live:
                attempts = int(res[_ATTEMPTS + t.task_id])
                if t.result_key in done:
                    # already done (speculative duplicate became moot): undo
                    # the attempt charge — nothing will execute
                    self.kv.incr(_ATTEMPTS + t.task_id, -1, worker=worker)
                    continue
                if attempts > self.config.max_attempts:
                    # dropped; driver will surface missing-result error (the
                    # epoch drawn above is burned, which fences nothing real)
                    continue
                epoch = int(res[_EPOCH + t.task_id])
                spec = t.unleased()
                record = {
                    "worker": worker,
                    "epoch": epoch,
                    "expires": expires,
                    "started": now,
                    "attempt": attempts - 1,
                    "spec": spec,
                }

                installs[_LEASE + t.task_id] = partial(_lease_install, record)
                candidates.append((t, spec, epoch, attempts))
            leased: List[TaskSpec] = []
            if installs:
                out = self.kv.eval_many(installs, worker=worker)
                refunds = []
                for t, spec, epoch, attempts in candidates:
                    if int(out[_LEASE + t.task_id].get("epoch", 0)) != epoch:
                        # Lost the duplicate race; that attempt owns it.
                        # Undo the attempt charge — this pop executed
                        # nothing, and burned charges would let race losses
                        # push a task over max_attempts without max_attempts
                        # real executions.
                        refunds.append(t.task_id)
                        continue
                    with self._lock:
                        self._specs[t.task_id] = spec
                        self._jobs.setdefault(t.job_id, set()).add(t.task_id)
                        self._active_leases += 1
                        self._hinted.add(t.task_id)
                        heapq.heappush(self._lease_heap, (expires, t.task_id))
                        heapq.heappush(
                            self._start_heaps.setdefault(t.job_id, []),
                            (now, t.task_id),
                        )
                    won = t if attempts == 1 else t.retry()
                    leased.append(won.with_epoch(epoch))
                if refunds:
                    self.kv.eval_many(
                        {_ATTEMPTS + tid: _decr_counter for tid in refunds},
                        default=0,
                        worker=worker,
                    )
            if leased:
                return leased

    def lease_next(self, worker: str) -> Optional[TaskSpec]:
        """Atomically pop a task and take its lease (non-blocking)."""
        return self._try_lease(worker)

    def lease_batch(
        self,
        worker: str,
        max_n: int = 1,
        timeout_s: Optional[float] = None,
        should_stop: Optional[Callable[[], bool]] = None,
    ) -> List[TaskSpec]:
        """Lease up to ``max_n`` tasks, blocking on the *queue shard's* watch
        condition until at least one is available (or ``timeout_s`` elapses /
        ``should_stop`` returns True).  Any producer's ``rpush`` through the
        shared KV wakes this — other handles, and over ``FileKVStore`` other
        *processes*.  Returning an empty list means "no work" — the caller
        re-checks its own state and may call again."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            batch = self._try_lease_batch(worker, max_n)
            if batch:
                return batch
            # Snapshot the shard sequence *before* checking should_stop and
            # queue emptiness: a push — or a wake_workers() stop signal,
            # which sets the stop flag *then* touches the shard — landing
            # after the snapshot advances the sequence, so the wait below
            # returns immediately instead of missing it.
            seq = self.kv.shard_seq(_Q)
            if should_stop is not None and should_stop():
                return []
            if self.kv.llen(_Q, worker=worker) == 0:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self.kv.wait_key(_Q, seq, remaining)
                else:
                    self.kv.wait_key(_Q, seq, _UNBOUNDED_WAIT_S)
            if should_stop is not None and should_stop():
                return []

    def release(self, task: TaskSpec, worker: str) -> None:
        """Cleanly return a leased-but-unstarted task to the queue (graceful
        worker shutdown / scale-down preemption).  Fenced: only the current
        epoch holder can hand the task back, the released epoch is burned
        (``sched/epoch`` incr) so any in-flight heartbeat or publish from it
        is rejected, and the attempt charge is undone so a preempted task is
        not penalized toward ``max_attempts``."""
        won, rec = self._fenced_drop_lease(task.task_id, task.epoch, worker)
        if not won:
            return  # reaped/completed/superseded meanwhile: nothing to return
        if self._job_finished(task.job_id):
            return  # job GC'd while leased: don't re-create attempts/queue state
        self.kv.incr(_EPOCH + task.task_id, 1, worker=worker)  # invalidate
        self.kv.incr(_ATTEMPTS + task.task_id, -1, worker=worker)
        spec = rec.get("spec") if rec else None
        self.kv.rpush(_Q, spec if spec is not None else task.unleased(), worker=worker)
        self._signal_work()

    def heartbeat(self, task: TaskSpec, worker: str) -> bool:
        """Extend the lease iff ``task.epoch`` is still current.  A zombie's
        heartbeat (reaped, released, or superseded) is rejected — it cannot
        keep a lease alive that another attempt now owns.  Returns whether
        the extension applied."""
        epoch = task.epoch
        expires = time.monotonic() + self.config.lease_timeout_s
        out: Dict[str, bool] = {}
        self.kv.eval(
            _LEASE + task.task_id,
            partial(_lease_extend, epoch, expires, out),
            worker=worker,
        )
        return bool(out.get("ok"))

    def complete(self, task: TaskSpec, worker: str, duration_s: float) -> bool:
        """Fenced completion: drop the lease iff ``task.epoch`` is current.
        Only the winning attempt's duration enters the job's straggler
        distribution — a zombie's wall time (it sat reaped or superseded)
        would poison the quantile.  Returns whether this attempt won."""
        # The lease drop and the finished-tombstone probe ride ONE
        # ``eval_many`` (one pipelined round-trip — this pair is the per-task
        # hot path, and on a wire substrate a separate tombstone get doubled
        # completion's trip count).
        out: Dict[str, dict] = {}
        probe: Dict[str, dict] = {}
        with self._lock:
            cached_finished = task.job_id in self._finished_jobs
        updates: Dict[str, Callable] = {
            _LEASE + task.task_id: partial(_lease_drop, task.epoch, None, out)
        }
        if not cached_finished:
            updates[_FINISHED + task.job_id] = partial(_probe_keep, probe)
        self.kv.eval_many(updates, worker=worker)
        won = out.get("rec") is not None
        if won:
            with self._lock:
                self._active_leases = max(0, self._active_leases - 1)
                self._hinted.discard(task.task_id)
        finished = cached_finished or probe.get("rec") is not None
        if finished and not cached_finished:
            self._remember_finished(task.job_id)
        # An in-flight duplicate finishing after its job was GC'd must not
        # re-create state finish_job just deleted: skip the duration push
        # and scrub the result/.err objects its publish re-created (the
        # result key was absent again, so its if_absent publish won).
        if finished:
            self.store.delete_prefix(task.result_key, worker=worker)
            won = False
        elif won:
            # Advisory sample: a lost entry only nudges the speculation
            # quantile, so it is not worth a blocking round trip per task.
            self.kv.rpush_nowait(_DURATION + task.job_id, duration_s, worker=worker)
            self._maybe_decay_fenced(task.job_id, worker)
        else:
            # A fenced zombie ran to completion: it was reaped or superseded
            # while actually alive.  Count it per job — the speculation rule
            # reads this back and raises the job's threshold, so a job that
            # keeps fencing zombies stops speculating (see SchedulerConfig).
            self.kv.incr(_FENCED + task.job_id, 1, worker=worker)
            with self._lock:
                self._fenced_hint.add(task.job_id)
        self._activity_evt.set()
        return won

    def _maybe_decay_fenced(self, job_id: str, worker: str) -> None:
        """Decay the job's fenced-zombie counter on a clean (won) completion
        — the backoff heals once attempts stop getting fenced while alive
        (see ``SchedulerConfig``).  Gated on having *seen* a fence for this
        job (local hint, or a nonzero count in the speculate() cache, which
        covers fences raised by other drivers) so the common zero-fenced
        path costs no extra KV round-trip per completion."""
        decay = self.config.speculation_zombie_decay
        if decay <= 0:
            return
        with self._lock:
            hinted = job_id in self._fenced_hint
            cached = self._dur_cache.get(job_id)
        if not hinted and not (cached is not None and cached[2] > 0):
            return

        new = self.kv.eval(_FENCED + job_id, partial(_fenced_decay, decay), worker=worker)
        if new is None:
            with self._lock:
                self._fenced_hint.discard(job_id)

    # ---- index cache maintenance ----------------------------------------
    def refresh_index(self) -> int:
        """Rebuild lease-index hints from the KV (`scan` over lease
        records): fold in leases granted through *other* handles — or
        before this handle existed — so reap/speculate cover them.  Safe to
        call any time; hints are always re-validated before acting.
        One scan + one batched ``mget`` for the unknown records (the PR-2
        multi-get lesson — never one round-trip per key).  Returns the
        number of new hints added."""
        keys = self.kv.scan(_LEASE, worker="scheduler")
        with self._lock:
            unknown = [k for k in keys if k[len(_LEASE):] not in self._hinted]
        if not unknown:
            return 0
        added = 0
        records = self.kv.mget(unknown, worker="scheduler")
        for key, rec in zip(unknown, records):
            if rec is None:
                continue  # consumed between the scan and the mget
            task_id = key[len(_LEASE):]
            spec = rec.get("spec")
            with self._lock:
                if task_id in self._hinted:
                    continue
                self._hinted.add(task_id)
                heapq.heappush(self._lease_heap, (rec["expires"], task_id))
                if spec is not None:
                    self._specs.setdefault(task_id, spec)
                    self._jobs.setdefault(spec.job_id, set()).add(task_id)
                    heapq.heappush(
                        self._start_heaps.setdefault(spec.job_id, []),
                        (rec["started"], task_id),
                    )
            added += 1
        return added

    def _maybe_refresh_index(self) -> None:
        """Time-gated :meth:`refresh_index` — at most one KV scan per lease
        timeout, so a control loop ticking every heartbeat doesn't turn the
        O(shards) scan into per-tick traffic."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_index_refresh < self.config.lease_timeout_s:
                return
            self._last_index_refresh = now
        self.refresh_index()

    # ---- control loop -----------------------------------------------------
    def reap(self) -> int:
        """Re-enqueue tasks whose lease expired (worker death). Returns count.

        Heap-indexed with lazy re-validation, over *shared*
        state: the hint heap covers every handle's leases (via
        ``_maybe_refresh_index``), and the actual requeue is a fenced
        epoch+expiry CAS-delete — two drivers reaping the same lease race
        at the eval and exactly one wins the requeue."""
        n = 0
        self._maybe_refresh_index()
        now = time.monotonic()
        while True:
            with self._lock:
                if not self._lease_heap or self._lease_heap[0][0] > now:
                    break
                _, task_id = heapq.heappop(self._lease_heap)
            # reprolint: disable=BATCH001(lazy heap revalidation is inherently per-candidate: each pop's read gates the next pop)
            lease = self.kv.get(_LEASE + task_id, worker="scheduler")
            if lease is None:
                with self._lock:
                    self._hinted.discard(task_id)
                continue  # completed, released, or job GC'd — stale hint
            if lease["expires"] > now:
                # Heartbeat extended the lease after our hint was pushed.
                with self._lock:
                    heapq.heappush(self._lease_heap, (lease["expires"], task_id))
                continue
            won, rec = self._fenced_drop_lease(
                task_id,
                int(lease.get("epoch", 0)),
                "scheduler",
                require_expired_before=now,
            )
            if not won:
                # Another driver reaped it first, the worker completed, or a
                # heartbeat slipped in — re-hint if a record is still there;
                # otherwise drop the hint marker too, or refresh_index would
                # skip every future lease of this task on this handle.
                # reprolint: disable=BATCH001(per-candidate re-hint after a lost reap race; no batch exists)
                fresh = self.kv.get(_LEASE + task_id, worker="scheduler")
                with self._lock:
                    if fresh is not None:
                        heapq.heappush(self._lease_heap, (fresh["expires"], task_id))
                    else:
                        self._hinted.discard(task_id)
                continue
            spec = rec.get("spec") if rec else None
            if spec is None:
                with self._lock:
                    spec = self._specs.get(task_id)
            if (
                spec is None
                or self._job_finished(spec.job_id)
                # reprolint: disable=BATCH001(one probe per actually-expired lease, gated by the eval win above)
                or self.store.backend.exists(spec.result_key)
            ):
                continue
            # reprolint: disable=BATCH001(requeue must be visible before the next pop's revalidation; one push per won reap)
            self.kv.rpush(_Q, spec, worker="scheduler")
            self._signal_work()
            n += 1
        return n

    def speculate(self) -> int:
        """Enqueue duplicates of straggling tasks. Returns count.

        Per-job start heaps pop exactly the candidates whose elapsed time
        crossed the straggler threshold (quantile-adaptive, multiplied by
        the job's fenced-zombie backoff; see ``SchedulerConfig``).  The
        duplicate mark is a KV ``setnx`` — N drivers speculating the same
        job enqueue each straggler once — and the per-job duplicate BUDGET
        is a shared KV counter gated by an atomic ``incr``, so all drivers
        together never exceed ``speculation_budget(job size)``."""
        n = 0
        now = time.monotonic()
        with self._lock:
            job_ids = list(self._start_heaps.keys())
        for job_id in job_ids:
            with self._lock:
                # Empty heap = nothing leased for this job; prune it so a
                # long-lived executor doesn't pay an lrange+sort per *ever
                # submitted* job on every control tick (_try_lease re-creates
                # the heap on the next lease).
                if not self._start_heaps.get(job_id):
                    self._start_heaps.pop(job_id, None)
                    self._dur_cache.pop(job_id, None)  # don't leak foreign jobs
                    continue
            cached = self._dur_cache.get(job_id)
            if cached is not None and now - cached[0] < self.config.heartbeat_interval_s:
                durations, fenced = cached[1], cached[2]
            else:
                durations = self.kv.lrange(_DURATION + job_id, worker="scheduler")
                # reprolint: disable=BATCH001(time-gated cache refill: one read per heartbeat interval per job, not per tick)
                fenced = int(self.kv.get(_FENCED + job_id, 0, worker="scheduler") or 0)
                self._dur_cache[job_id] = (now, durations, fenced)
            if len(durations) < self.config.min_completed_for_speculation:
                continue
            cutoff = now - self.config.straggler_threshold_s(durations, fenced=fenced)
            budget: Optional[int] = None  # resolved lazily, on first candidate
            while True:
                with self._lock:
                    heap = self._start_heaps.get(job_id)
                    if not heap or heap[0][0] > cutoff:
                        break
                    started, task_id = heapq.heappop(heap)
                    already = task_id in self._speculated
                # reprolint: disable=BATCH001(lazy heap revalidation is inherently per-candidate: each pop's read gates the next pop)
                lease = self.kv.get(_LEASE + task_id, worker="scheduler")
                if lease is None:
                    continue  # finished or reaped; a re-lease pushes a fresh hint
                if lease["started"] > started:
                    with self._lock:
                        heapq.heappush(heap, (lease["started"], task_id))
                    continue  # stale hint from an earlier attempt
                spec = lease.get("spec")
                if spec is None or already:
                    continue
                # reprolint: disable=BATCH001(one probe per straggler candidate that survived revalidation)
                if self.store.backend.exists(spec.result_key):
                    continue
                if budget is None:
                    # Resolved once per job pass (two KV reads), on the first
                    # real candidate; within the pass the atomic incr below
                    # is the only gate — it alone is what's race-free across
                    # drivers anyway.
                    n_tasks = self.kv.llen(_JOBTASKS + job_id, worker="scheduler")
                    budget = self.config.speculation_budget(n_tasks)
                    used = int(
                        # reprolint: disable=BATCH001(resolved once per job pass, on the first real candidate only)
                        self.kv.get(_SPECCOUNT + job_id, 0, worker="scheduler") or 0
                    )
                    if used >= budget:
                        break  # job's duplicate budget spent (across all drivers)
                if not self.kv.setnx(_SPECMARK + task_id, 1, worker="scheduler"):
                    # Another driver already duplicated this straggler.
                    with self._lock:
                        self._speculated.add(task_id)
                    continue
                # The atomic incr is the budget gate across drivers: whoever
                # pushes the count past the budget undoes its own duplicate.
                if self.kv.incr(_SPECCOUNT + job_id, 1, worker="scheduler") > budget:
                    self.kv.incr(_SPECCOUNT + job_id, -1, worker="scheduler")
                    break
                with self._lock:
                    self._speculated.add(task_id)
                # reprolint: disable=BATCH001(each duplicate push is individually gated by its setnx mark and budget incr)
                self.kv.rpush(_Q, spec, worker="scheduler")
                self._signal_work()
                n += 1
        return n

    # ---- per-job GC -------------------------------------------------------
    def finish_job(self, job_id: str) -> int:
        """Free everything a completed job left behind — callable from *any*
        handle, not just the submitter, because task membership lives in
        ``sched/jobtasks/{job}``.  The KV tombstone (``sched/finished/``)
        is written **before** the deletes, so a concurrent lease in any
        process drops the job's queued duplicates instead of resurrecting
        the state being freed.  Returns the number of tasks freed.  Futures
        for the job become unresolvable (their result keys are deleted) —
        call only after results have been retrieved."""
        already = self.kv.get(_FINISHED + job_id, worker="scheduler") is not None
        self.kv.set(_FINISHED + job_id, 1, worker="scheduler")
        self._remember_finished(job_id)
        kv_ids = self.kv.lrange(_JOBTASKS + job_id, worker="scheduler")
        with self._lock:
            task_ids = set(self._jobs.pop(job_id, set()))
            task_ids.update(kv_ids)
            for tid in task_ids:
                self._specs.pop(tid, None)
                self._speculated.discard(tid)
            self._start_heaps.pop(job_id, None)
            self._dur_cache.pop(job_id, None)
        # The job's manifest keyspace (manifest/stage/barrier records and
        # the driver lease, core/jobs.py) goes behind the same tombstone —
        # and is scrubbed on EVERY call, not just the first: an adopter that
        # lost the finish race has just re-created the driver record via its
        # fencing takeover, and its own finish_job must remove it again.
        manifest_keys = self.kv.scan(_JOBMANIFEST + job_id + "/", worker="scheduler")
        if manifest_keys:
            self.kv.mdel(manifest_keys, worker="scheduler")
        if already:
            return 0  # another handle (or an earlier call) already freed it
        # Batched KV cleanup: one amortized round-trip per shard, and the
        # removed-lease count settles the advisory lease accounting that
        # per-task fenced drops would otherwise pay a get+eval per task for.
        removed = self.kv.mdel([_LEASE + tid for tid in task_ids], worker="scheduler")
        with self._lock:
            self._active_leases = max(0, self._active_leases - removed)
            self._hinted.difference_update(task_ids)
        self.kv.mdel(
            [_ATTEMPTS + tid for tid in task_ids]
            + [_EPOCH + tid for tid in task_ids]
            + [_SPECMARK + tid for tid in task_ids]
            + [_DURATION + job_id, _JOBTASKS + job_id]
            + [_SPECCOUNT + job_id, _FENCED + job_id],
            worker="scheduler",
        )
        self.store.delete_prefix(f"result/{job_id}/", worker="scheduler")
        # Trailing slash: 'input/train' must not also match job 'train2'.
        self.store.delete_prefix(f"input/{job_id}/", worker="scheduler")
        return len(task_ids)

    def pending(self) -> int:
        with self._lock:
            specs = list(self._specs.values())
        done = self.store.backend.exists_many([s.result_key for s in specs])
        return sum(1 for s in specs if s.result_key not in done)

    def queue_depth(self) -> int:
        return self.kv.llen(_Q, worker="scheduler")

    def attempts(self, task: TaskSpec) -> int:
        return int(self.kv.get(_ATTEMPTS + task.task_id, 0, worker="scheduler"))

    def epoch(self, task: TaskSpec) -> int:
        """Current fencing epoch of a task (0 = never leased)."""
        return int(self.kv.get(_EPOCH + task.task_id, 0, worker="scheduler"))
