"""Public API: the PyWren surface.

    wex = WrenExecutor(num_workers=32)
    futures = wex.map(my_function, my_list)
    results = wren.get_all(futures)

``map`` launches one stateless function per element ("Calling map launches
as many stateless functions as there are elements in the list") and mirrors
Python's native map API.  The executor owns a control loop that reaps dead
workers' leases and speculates on stragglers until the job drains.

Multi-driver: the ``Scheduler`` is a stateless handle over the KV, so any
number of executors sharing a ``store``/``kv`` pair — across processes with
``FileBackend``/``FileKVStore`` — cooperate on one queue: every driver's
workers lease from it, every driver's control loop reaps and speculates it,
and epoch fencing (see ``core/scheduler.py``) keeps the concurrent
reap/speculate/complete transitions exactly-once.  ``examples/
multi_driver.py`` and ``tests/test_multidriver.py`` exercise exactly this.

The control loop is wakeup-driven: it blocks on the scheduler's activity
event (set by ``submit*``/``complete``/requeues) and otherwise sleeps until
``Scheduler.next_wakeup_s()`` — a deadline-based fallback tick sized to the
heartbeat interval while leases are outstanding (so lease expiry and
straggler detection are still noticed without any event) and a long idle
tick when nothing is in flight.  ``shutdown()`` signals the same event so
the loop exits without waiting out a tick.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, Iterable, List, Optional

from repro_torch.storage import KVStore, ObjectStore

from . import jobs
from .executor import FaultPlan, WorkerPool
from .functions import FunctionSpec, TaskSpec, stage_inputs
from .futures import ResultFuture, get_all
from .resources import LAMBDA_2017, ResourceLimits
from .scheduler import Scheduler, SchedulerConfig


class WrenExecutor:
    def __init__(
        self,
        store: Optional[ObjectStore] = None,
        kv: Optional[KVStore] = None,
        num_workers: int = 8,
        limits: ResourceLimits = LAMBDA_2017,
        scheduler_config: Optional[SchedulerConfig] = None,
        fault_plan: Optional[FaultPlan] = None,
        compute_time_fn: Optional[Callable[[float], float]] = None,
        seed: int = 0,
    ) -> None:
        self.store = store or ObjectStore()
        self.kv = kv or KVStore(num_shards=2)
        self.scheduler = Scheduler(self.kv, self.store, scheduler_config)
        self.pool = WorkerPool(
            self.store,
            self.scheduler,
            num_workers,
            limits=limits,
            fault_plan=fault_plan,
            compute_time_fn=compute_time_fn,
            seed=seed,
        )
        # Driver identity for job-manifest leases (core/jobs.py): unique per
        # executor so a restarted process adopts its predecessor's jobs via
        # the fencing takeover path rather than silently re-owning them.
        self.driver_id = f"drv-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self._driver_mu = threading.Lock()
        self._driver_jobs: Dict[str, int] = {}  # job_id -> held term
        self._driver_hb_at = time.monotonic()
        self._control_stop = threading.Event()
        self._control = threading.Thread(target=self._control_loop, daemon=True)
        self._control.start()

    # ---- control loop: reap + speculate + driver heartbeats -------------
    def _control_loop(self) -> None:
        while not self._control_stop.is_set():
            # Clear *before* reaping: activity that lands mid-pass re-arms
            # the event and the next wait returns immediately.
            self.scheduler.clear_activity()
            try:
                self.scheduler.reap()
                self.scheduler.speculate()
                self._heartbeat_driver_leases()
            except Exception:  # noqa: BLE001 — control loop must survive
                pass
            wait_s = self.scheduler.next_wakeup_s()
            hb_due = self._driver_heartbeat_due_s()
            if hb_due is not None:
                wait_s = min(wait_s, hb_due)
            if self.scheduler.wait_activity(wait_s):
                # Coalesce activity bursts (e.g. many completions) so the
                # O(tasks) reap scan runs at a bounded rate, not per event.
                self._control_stop.wait(0.02)

    # ---- driver leases: job-manifest ownership (core/jobs.py) ------------
    def register_driver(self, job_id: str) -> Optional[int]:
        """Claim the job's driver lease for this executor.  Returns the held
        term (the fencing token adoption compares against), or ``None`` if a
        live foreign driver owns the job.  The control loop heartbeats every
        registered job until ``release_driver``/``finish_job``."""
        rec = jobs.acquire_driver(
            self.kv,
            job_id,
            self.driver_id,
            self.scheduler.config.driver_lease_timeout_s,
            worker="driver",
        )
        if rec is None or rec.get("owner") != self.driver_id:
            return None
        term = int(rec["term"])
        with self._driver_mu:
            self._driver_jobs[job_id] = term
        self.scheduler.signal_activity()  # re-time the loop's next wakeup
        return term

    def release_driver(self, job_id: str) -> bool:
        """Give up a held driver lease (the record stays, expired, so a
        later adopter still draws a higher term).  No-op for jobs this
        executor doesn't hold — safe to call on error paths."""
        with self._driver_mu:
            term = self._driver_jobs.pop(job_id, None)
        if term is None:
            return False
        return jobs.release_driver(
            self.kv, job_id, self.driver_id, term, worker="driver"
        )

    def _heartbeat_driver_leases(self) -> None:
        """Extend every held driver lease in one batched eval — rate-gated
        to a quarter of the lease timeout so the control loop's activity
        bursts don't turn heartbeats into per-event round-trips.  Jobs whose
        lease was fenced (adopted at a higher term) or GC'd are dropped from
        the registry — this driver must stop claiming them."""
        timeout_s = self.scheduler.config.driver_lease_timeout_s
        with self._driver_mu:
            owned = dict(self._driver_jobs)
            if not owned:
                return
            if time.monotonic() - self._driver_hb_at < timeout_s / 4.0:
                return
            self._driver_hb_at = time.monotonic()
        lost = jobs.heartbeat_drivers(
            self.kv, owned, self.driver_id, timeout_s, worker="driver"
        )
        if lost:
            with self._driver_mu:
                for job_id in lost:
                    # Drop only if unchanged: a re-register that raced the
                    # heartbeat holds a newer term and must stay registered.
                    if self._driver_jobs.get(job_id) == owned.get(job_id):
                        self._driver_jobs.pop(job_id, None)

    def _driver_heartbeat_due_s(self) -> Optional[float]:
        with self._driver_mu:
            if not self._driver_jobs:
                return None
            interval = self.scheduler.config.driver_lease_timeout_s / 4.0
            return max(0.0, self._driver_hb_at + interval - time.monotonic())

    # ---- the paper's API -------------------------------------------------
    def map(
        self,
        fn: Callable[[Any], Any],
        items: Iterable[Any],
        *,
        job_id: Optional[str] = None,
    ) -> List[ResultFuture]:
        """One stateless function invocation per item.

        Submission is fully batched: all inputs are staged in a single
        ``put_many`` round-trip (``stage_inputs``) and all task records hit
        the scheduler queue in one pipelined push (``submit_many``) — the
        driver pays O(1) modeled requests to launch an N-task map, not
        O(N)."""
        job = job_id or f"job-{uuid.uuid4().hex[:8]}"
        func = FunctionSpec.register(self.store, fn, worker="driver")
        input_keys = stage_inputs(self.store, job, list(items), worker="driver")
        tasks = [
            TaskSpec.make(job, func, input_key, i)
            for i, input_key in enumerate(input_keys)
        ]
        self.scheduler.submit_many(tasks)
        return [ResultFuture(self.store, t) for t in tasks]

    def call_async(self, fn: Callable[[Any], Any], arg: Any) -> ResultFuture:
        return self.map(fn, [arg])[0]

    def map_get(
        self,
        fn: Callable[[Any], Any],
        items: Iterable[Any],
        timeout_s: float = 120.0,
        *,
        gc: bool = False,
    ) -> List[Any]:
        """map + resolve all results (one batched multi-get).  With
        ``gc=True`` the job's scheduler bookkeeping and result/input objects
        are freed after resolution — the right default for fire-and-forget
        supersteps where nothing re-reads the result keys."""
        job = f"job-{uuid.uuid4().hex[:8]}"
        out = get_all(self.map(fn, items, job_id=job), timeout_s=timeout_s)
        if gc:
            self.finish_job(job)
        return out

    # ---- elasticity -----------------------------------------------------
    def scale_to(self, n: int) -> None:
        self.pool.scale_to(n)

    # ---- per-job GC -----------------------------------------------------
    def finish_job(self, job_id: str) -> int:
        """Free a completed job's scheduler state and storage keys (see
        ``Scheduler.finish_job``).  Futures of the job become unresolvable —
        call only after their results have been retrieved.  Any driver lease
        this executor holds on the job is dropped from the heartbeat registry
        first — the GC deletes the lease record, and re-heartbeating it
        would resurrect a key the tombstone just retired."""
        with self._driver_mu:
            self._driver_jobs.pop(job_id, None)
        return self.scheduler.finish_job(job_id)

    # ---- lifecycle ------------------------------------------------------
    def shutdown(self) -> None:
        self._control_stop.set()
        self.scheduler.signal_activity()  # wake the control loop to exit
        self.pool.stop_all()
        self._control.join(timeout=2.0)
        # Release still-held driver leases so successors adopt immediately
        # instead of waiting out the lease timeout.  After the join: the
        # control loop must not re-extend a lease we just expired.
        with self._driver_mu:
            held = list(self._driver_jobs.keys())
        for job_id in held:
            self.release_driver(job_id)

    def __enter__(self) -> "WrenExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
