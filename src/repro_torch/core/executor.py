"""Elastic worker pool: Lambda-container emulation with fault injection.

Each worker thread emulates one serverless container:

  * **cold start** — first task on a fresh container pays the paper's
    measured start latency (Table 2: 9.7 s start + 14.2 s setup, as virtual
    time, deterministic per worker seed); warm containers pay ~0.1 s.
    Container *reuse* across tasks is the paper's §4 caching mitigation.
  * **statelessness** — the container scratch dict is wiped between jobs;
    nothing a task leaves behind is visible to the next (paper §3.1: "none
    of the state created by the function will be retained").
  * **resource limits** — Lambda 2017 limits enforced per task.
  * **fault injection** — test hooks: die_before_publish (instance loss →
    lease expiry → retry), slowdown factors (stragglers → speculation),
    kill switches (elastic scale-down).

Workers heartbeat their lease from a side thread while the user function
runs, so long tasks are not falsely reaped, but a *dead* worker stops
heartbeating and is.

Epoch fencing threads through here: a leased ``TaskSpec`` carries the
attempt's fencing token (``task.epoch``), heartbeats are epoch-checked
extensions, and ``_execute`` hands ``run_task`` a fence callback
(``Scheduler.owns_lease``) checked immediately before the result publish —
a zombie container (reaped as dead, or superseded by a speculative
duplicate's lease) finishes its work but cannot publish over the owning
attempt's result or extend a lease it no longer holds.

The same token discipline is what makes *driver* death recoverable:
an adopter replaying a job manifest (``core/jobs.py``, ``core/bsp.py``)
resubmits any task the dead driver had in flight, and the duplicate
attempts converge here exactly as speculative duplicates do — first
publish wins, the loser is fenced at the result boundary.

Event-driven dispatch: workers do not poll the queue.  ``Worker.run``
blocks in ``Scheduler.lease_batch`` on the *queue shard's* KV watch
condition and is woken by any producer's ``rpush`` (submit, reap requeue,
speculation duplicate) — including producers on other scheduler handles
sharing the KV — leasing tasks in small batches to amortize queue lock
traffic.  ``stop()``/``kill()`` wake any blocked lease wait via
``Scheduler.wake_workers()`` so shutdown never waits out a poll interval.  On *graceful* stop, leased-but-unstarted batch
tasks are handed back via ``Scheduler.release``; on hard kill (or injected
death) their leases are left dangling for the reaper, exactly like a lost
Lambda instance.

Note the stop flag is named ``_stop_evt``: ``threading.Thread`` has a
private ``_stop()`` *method* in CPython, and shadowing it with an Event
makes ``Thread.join()`` raise ``TypeError: 'Event' object is not
callable``.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.storage import ObjectStore

from .functions import TaskSpec, run_task
from .resources import LAMBDA_2017, ResourceLimits
from .scheduler import Scheduler

# Paper Table 2 constants (seconds, virtual).
COLD_START_MEAN_S = 9.7
COLD_SETUP_MEAN_S = 14.2
WARM_START_S = 0.1

# How long a blocked lease wait lasts before re-checking the stop flag —
# a defensive backstop only; stop/kill wake the wait explicitly.
_LEASE_WAIT_S = 0.25


@dataclass
class FaultPlan:
    """Deterministic fault-injection plan for tests/benchmarks."""

    die_before_publish_tasks: set = field(default_factory=set)  # task ids die once
    slowdown: Dict[str, float] = field(default_factory=dict)  # worker -> factor
    max_tasks_per_worker: Optional[int] = None
    _fired: set = field(default_factory=set)  # faults fire once *globally*
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def should_die(self, task_id: str) -> bool:
        with self._lock:
            if task_id in self.die_before_publish_tasks and task_id not in self._fired:
                self._fired.add(task_id)
                return True
            return False


@dataclass
class WorkerStats:
    tasks_ok: int = 0  # attempts whose result is the task's visible one
    tasks_failed: int = 0
    # Attempts that ran to completion but whose result was fenced or beaten
    # to the publish by a duplicate — the price of speculation/retries.
    # Invariant: Σ tasks_ok across workers == number of visible results.
    tasks_superseded: int = 0
    cold_starts: int = 0
    vtime_busy_s: float = 0.0


class Worker(threading.Thread):
    def __init__(
        self,
        name: str,
        store: ObjectStore,
        scheduler: Scheduler,
        limits: ResourceLimits = LAMBDA_2017,
        fault_plan: Optional[FaultPlan] = None,
        compute_time_fn: Optional[Callable[[float], float]] = None,
        seed: int = 0,
        poll_s: float = 0.002,
        lease_batch_size: int = 4,
    ) -> None:
        super().__init__(name=name, daemon=True)
        self.worker_id = name
        self.store = store
        self.scheduler = scheduler
        self.limits = limits
        self.fault_plan = fault_plan or FaultPlan()
        self.compute_time_fn = compute_time_fn
        self.rng = random.Random(seed)
        self.poll_s = poll_s  # legacy knob; only scales injected slowdowns now
        self.lease_batch_size = max(1, lease_batch_size)
        self.stats = WorkerStats()
        self._stop_evt = threading.Event()
        self._killed = False  # hard kill / injected death: leases dangle
        self._warm = False  # container temperature
        # Warm-container code cache (paper §4): func blobs are content-
        # addressed and immutable, so a reused container skips re-fetching
        # and re-deserializing the function.  User/task state is NOT cached
        # — statelessness applies to data, not immutable code.
        self._code_cache: Dict[str, Callable] = {}

    # -- lifecycle ---------------------------------------------------------
    @property
    def stop_requested(self) -> bool:
        return self._stop_evt.is_set()

    def stop(self) -> None:
        """Graceful stop: finish the current task, release unstarted leases."""
        self._stop_evt.set()
        self.scheduler.wake_workers()

    def kill(self) -> None:
        """Hard kill: stop without completing the current lease (scale-down /
        spot preemption).  The scheduler's reaper picks up the pieces."""
        self._killed = True
        self._stop_evt.set()
        self.scheduler.wake_workers()

    # -- the container loop ---------------------------------------------------
    def run(self) -> None:  # noqa: D102
        tasks_done = 0
        while not self._stop_evt.is_set():
            batch = self.scheduler.lease_batch(
                self.worker_id,
                max_n=self.lease_batch_size,
                timeout_s=_LEASE_WAIT_S,
                should_stop=self._stop_evt.is_set,
            )
            # Prefetch the whole batch's inputs in one amortized multi-get
            # (the PR-2 read-batching lesson applied to the worker): N leased
            # tasks cost one request latency, not N.  The cache holds
            # serialized BYTES, not objects — inputs are content-addressed,
            # so two tasks with equal inputs share one key, and handing both
            # the same deserialized object would let one task's mutation
            # corrupt the other's input.  Each task deserializes its own
            # copy (exactly what its own fetch would have produced).  A key
            # that vanished (job GC'd mid-flight) is simply absent and the
            # task falls back to its own fetch.
            inputs = {}
            if len(batch) > 1:
                inputs = self.store.get_many_bytes(
                    [t.input_key for t in batch], worker=self.worker_id
                )
            for i, task in enumerate(batch):
                if self._stop_evt.is_set():
                    self._drop_leases(batch[i:])
                    return
                # heartbeat covers the whole held remainder of the batch, so
                # queued-behind-current leases don't falsely expire
                self._execute(task, held=batch[i:], inputs=inputs)
                tasks_done += 1
                cap = self.fault_plan.max_tasks_per_worker
                if cap is not None and tasks_done >= cap:
                    self._drop_leases(batch[i + 1:])
                    return

    def _drop_leases(self, unstarted: List[TaskSpec]) -> None:
        """Hand unstarted leases back — unless this container is 'dead', in
        which case they dangle until lease expiry, like a real lost instance."""
        if self._killed:
            return
        for task in unstarted:
            self.scheduler.release(task, self.worker_id)

    def _execute(
        self,
        task: TaskSpec,
        held: Optional[List[TaskSpec]] = None,
        inputs: Optional[Dict[str, object]] = None,
    ) -> None:
        # cold-start accounting (virtual)
        if self._warm:
            setup_vtime = WARM_START_S
        else:
            setup_vtime = max(
                0.5,
                self.rng.gauss(COLD_START_MEAN_S, 2.0)
                + self.rng.gauss(COLD_SETUP_MEAN_S, 2.0),
            )
            self.stats.cold_starts += 1
            self._warm = True

        # heartbeat while running — covers the current task plus any
        # leased-but-unstarted batch remainder this worker still holds
        hb_stop = threading.Event()
        hb_tasks = held if held else [task]

        def _heartbeat() -> None:
            # The lease was granted with a full timeout moments ago, so the
            # first extension is only due after one interval — beating
            # immediately would add one KV transaction per task for nothing.
            while not hb_stop.wait(self.scheduler.config.heartbeat_interval_s):
                if self._killed:
                    return  # dead containers don't heartbeat; a *graceful*
                    # stop keeps the current task's lease alive to the end
                for t in hb_tasks:
                    self.scheduler.heartbeat(t, self.worker_id)

        hb = threading.Thread(target=_heartbeat, daemon=True)
        hb.start()
        t0 = time.monotonic()
        died = False
        try:
            # fault injection: die mid-task, before publishing (once per task,
            # globally — the retried attempt on another container succeeds)
            if self.fault_plan.should_die(task.task_id):
                # fetch input (burn some ledger ops) then vanish: the lease
                # must be left dangling so only expiry can recover the task
                try:
                    self.store.get_bytes(task.func_key, worker=self.worker_id)
                except KeyError:
                    pass
                died = True
                self._killed = True
                self._stop_evt.set()
                return

            slow = self.fault_plan.slowdown.get(self.worker_id, 1.0)
            if slow > 1.0:
                time.sleep(self.poll_s * slow)

            ct = self.compute_time_fn
            if slow > 1.0 and ct is not None:
                base_ct = ct
                ct = lambda s: base_ct(s) * slow  # noqa: E731

            result = run_task(
                self.store,
                task,
                worker=self.worker_id,
                setup_vtime=setup_vtime,
                compute_time_fn=ct,
                # Fence: publish only while this attempt's epoch still owns
                # the lease (zombie publishes are suppressed; scheduler.py
                # documents the protocol).
                fence=lambda: self.scheduler.owns_lease(task),
                code_cache=self._code_cache,
                input_cache=inputs,
            )
            vtotal = sum(result.phases.values())
            try:
                self.limits.check_runtime(vtotal)
            except TimeoutError:
                # Over-limit tasks fail permanently (the Lambda contract);
                # record but keep the published result (it is still correct —
                # the limit models billing, not correctness).
                result.phases["over_limit"] = vtotal
            if not result.success:
                self.stats.tasks_failed += 1
            elif result.fenced:
                self.stats.tasks_superseded += 1
            else:
                self.stats.tasks_ok += 1
            self.stats.vtime_busy_s += vtotal
        finally:
            hb_stop.set()
            if not died:
                self.scheduler.complete(task, self.worker_id, time.monotonic() - t0)


class WorkerPool:
    """Elastic pool: scale_to() adds/removes containers at any time.

    Liveness is tracked by a *not-stopped* predicate (``runnable_workers``),
    not thread aliveness alone: a killed worker may take a moment to exit,
    and a freshly constructed one may not have started yet — both were
    previously miscounted, so repeated scale up/down drifted away from the
    requested count."""

    def __init__(
        self,
        store: ObjectStore,
        scheduler: Scheduler,
        num_workers: int,
        limits: ResourceLimits = LAMBDA_2017,
        fault_plan: Optional[FaultPlan] = None,
        compute_time_fn: Optional[Callable[[float], float]] = None,
        seed: int = 0,
        lease_batch_size: int = 4,
    ) -> None:
        self.store = store
        self.scheduler = scheduler
        self.limits = limits
        self.fault_plan = fault_plan or FaultPlan()
        self.compute_time_fn = compute_time_fn
        self.seed = seed
        self.lease_batch_size = lease_batch_size
        self.workers: List[Worker] = []
        self._next_id = 0
        self._lock = threading.Lock()
        self.scale_to(num_workers)

    def runnable_workers(self) -> List[Worker]:
        """Workers that can still take tasks: not stop-requested, and either
        running or not yet started (a just-constructed thread is runnable)."""
        return [
            w
            for w in self.workers
            if not w.stop_requested and (w.ident is None or w.is_alive())
        ]

    def scale_to(self, n: int) -> None:
        """Elasticity: spin containers up or down; safe mid-job because state
        is storage-resident and tasks are idempotent.  Converges to exactly
        ``n`` runnable containers even across repeated up/down calls.

        Scale-down is a *graceful* stop, not a kill: a worker that leased a
        batch between the ``runnable_workers()`` snapshot and its stop flag
        hands every unstarted lease straight back (``Scheduler.release``,
        which burns the released epoch), so scale-down returns queue depth
        immediately instead of stranding leases until expiry — the reaper
        is for *lost* instances (``kill_worker``/fault injection), not for
        deliberate elasticity."""
        with self._lock:
            runnable = self.runnable_workers()
            while len(runnable) < n:
                w = Worker(
                    name=f"w{self._next_id:04d}",
                    store=self.store,
                    scheduler=self.scheduler,
                    limits=self.limits,
                    fault_plan=self.fault_plan,
                    compute_time_fn=self.compute_time_fn,
                    seed=self.seed + self._next_id,
                    lease_batch_size=self.lease_batch_size,
                )
                self._next_id += 1
                self.workers.append(w)
                runnable.append(w)
                w.start()
            # scale down: stop newest runnable first (graceful — releases)
            for w in reversed(runnable[n:]):
                w.stop()

    def kill_worker(self, idx: int) -> None:
        """Kill the idx-th *runnable* worker (indexing over already-dead
        workers would silently no-op the kill)."""
        with self._lock:
            runnable = self.runnable_workers()
            target = runnable[idx] if idx < len(runnable) else self.workers[idx]
        target.kill()

    def stop_all(self) -> None:
        for w in self.workers:
            w.stop()
        for w in self.workers:
            w.join(timeout=2.0)

    def stats(self) -> Dict[str, WorkerStats]:
        return {w.worker_id: w.stats for w in self.workers}

    def alive_count(self) -> int:
        return sum(1 for w in self.workers if w.is_alive())
