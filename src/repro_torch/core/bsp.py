"""BSP / MapReduce on stateless functions + storage shuffle (paper §3.3),
now driver-crash-tolerant: every job is a *re-entrant replay* of a
KV-resident manifest (``core/jobs.py``).

'More complex abstractions like dataflow or BSP can be implemented on top' —
this module is that layer: synchronized stages of stateless tasks with a
storage-backed shuffle between them.  No worker talks to another worker,
ever; the only channel is the store, exactly as in the paper.

Provides:
  * ``run_stage``   — one BSP superstep (map over items, barrier on results);
  * ``mapreduce``   — map → (hash shuffle) → reduce, used by word count;
  * ``terasort``    — sample → range-partition → merge, the Daytona-sort
                      two-stage algorithm of §3.3 with selectable
                      intermediate store (ObjectStore=S3 or KVStore=Redis);
  * ``adopt_job``   — the failover entry point: wait for a job's driver
                      lease to lapse, fence it at ``term + 1``, and replay
                      the manifest to completion from the last barrier;
  * phase accounting per task so benchmarks reproduce Fig 6's breakdown.

Re-entrancy contract: before a job runs anything, its
manifest and stage plans land in the KV under ``sched/job/{job}/`` via
:func:`jobs.commit_records` — one first-writer-wins ``eval_many``, so two
drivers planning the same stage converge on one plan.  Each completed stage
writes its barrier record (the outputs, in task order) *before* its
scheduler state is GC'd, so a driver killed at any instant leaves a
resumable prefix: the replay skips recorded barriers, rebuilds the exact
``TaskSpec`` set from a stored plan (task ids are deterministic hashes of
job/function/input), resubmits only tasks whose result keys don't exist,
and lets the task plane's epoch fencing converge any duplicates the dead
driver left queued or leased.

Port of `repro.core.bsp`.  The runtime ships callables with the standard
``pickle`` (`functions`), so the JAX package's nested task closures are
``functools.partial`` objects over module-level functions here (``_map_task``,
``_reduce_task``, ``_wc_map``/``_wc_reduce``, ``_sample_task``,
``_partition_task``, ``_merge_task``); a partial holds no uuid, time or
process-local id of its own, and its stores pickle through their
``__reduce__`` (an endpoint, not the data).  A user's ``map_fn`` and
``reduce_fn`` must pickle by reference too: module-level functions, or
partials of them.  Job manifests, plans, barriers and shuffle
intermediates have the JAX package's layout, but a job is adopted only by
the package that submitted it: the registered functions are pickled
references into that package.

Lifecycle: each stage's scheduler state is freed at its barrier, both
``mapreduce`` and ``terasort`` retire their ``shuffle/{job}`` intermediates
via ``shuffle.delete_intermediates`` once the consuming stage has merged
(the manifest's GC plan — re-derived from ``meta`` on replay), and the
final ``finish_job`` drops the manifest keyspace itself behind the job's
tombstone — storage holds only live data between stages, not the
pipeline's history.
"""

from __future__ import annotations

import uuid
from collections import defaultdict
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.storage import KVStore, ObjectStore
from repro_torch.storage import shuffle as shf

from . import jobs
from .functions import FunctionSpec, TaskSpec, stage_inputs
from .futures import ResultFuture, get_all
from .wren import WrenExecutor


# ---------------------------------------------------------------------------
# the replay framework: plan → run → barrier, all records KV-resident
# ---------------------------------------------------------------------------

def _register(wex: WrenExecutor, job: str) -> int:
    term = wex.register_driver(job)
    if term is None:
        raise RuntimeError(
            f"job {job!r} already has a live driver — a second submitter "
            "must wait for its lease to lapse (bsp.adopt_job) instead of "
            "racing it"
        )
    return term


def _build_plan(
    wex: WrenExecutor,
    job: str,
    idx: int,
    fn: Callable[[Any], Any],
    items: Sequence[Any],
    *,
    term: int,
    stage_job: Optional[str] = None,
) -> dict:
    """Materialize a stage plan: register the stage function (content-
    addressed) and stage all inputs (one batched put), then return the
    record that makes the stage rebuildable by any driver — function key,
    input keys in task-index order, and the stage's scheduler job id.
    ``TaskSpec.make`` is a deterministic hash of exactly these, so every
    driver holding this record derives the identical task set."""
    func = FunctionSpec.register(wex.store, fn, worker="driver")
    sj = stage_job if stage_job is not None else f"{job}/s{idx}"
    input_keys = stage_inputs(wex.store, sj, list(items), worker="driver")
    return {
        "func_key": func.key,
        "func_name": func.name,
        "input_keys": input_keys,
        "stage_job": sj,
        "term": term,
    }


def _run_planned(wex: WrenExecutor, plan: dict, *, timeout_s: float) -> List[Any]:
    """Run (or resume) a planned stage: rebuild the deterministic task set,
    probe which results already exist (one batched existence check), submit
    only the missing tasks, and barrier on all of them.  A task the dead
    driver left queued or leased may briefly run twice — the task plane's
    epoch fencing and first-writer-wins result publish make the duplicate
    converge, exactly as a speculative copy does."""
    func = FunctionSpec(key=plan["func_key"], name=plan["func_name"])
    tasks = [
        TaskSpec.make(plan["stage_job"], func, key, i)
        for i, key in enumerate(plan["input_keys"])
    ]
    present = wex.store.exists_many([t.result_key for t in tasks], worker="driver")
    missing = [t for t in tasks if t.result_key not in present]
    if missing:
        wex.scheduler.submit_many(missing)
    return get_all([ResultFuture(wex.store, t) for t in tasks], timeout_s=timeout_s)


def _stage_barrier(
    wex: WrenExecutor,
    job: str,
    idx: int,
    plan: dict,
    outputs: List[Any],
    *,
    term: int,
    gc_stage: bool = True,
) -> List[Any]:
    """Commit the barrier record, THEN free the stage's scheduler state.
    The order is the crash-safety invariant: a driver dying between the two
    leaves the barrier durable (the adopter skips the stage), and dying
    before the commit leaves the results in the store for the adopter's
    resubmission probe.  First-writer-wins: a zombie and its adopter both
    proceed with the stored outputs."""
    key = jobs.barrier_key(job, idx)
    stored = jobs.commit_records(
        wex.kv, {key: {"outputs": outputs, "term": term}}
    )
    if gc_stage:
        wex.finish_job(plan["stage_job"])
    return stored[key]["outputs"]


def _replay_stage(
    wex: WrenExecutor,
    job: str,
    idx: int,
    planner: Callable[[], Tuple[Callable[[Any], Any], Sequence[Any]]],
    *,
    term: int,
    timeout_s: float,
) -> List[Any]:
    """One stage of a manifest replay: recorded barrier → return instantly;
    recorded plan → resume it; neither → plan it now (``planner`` re-derives
    the stage function and items from earlier barriers / manifest meta) and
    commit first-writer-wins before running."""
    done = jobs.read_barrier(wex.kv, job, idx, worker="driver")
    if done is not None:
        return done["outputs"]
    plan = jobs.read_stage(wex.kv, job, idx, worker="driver")
    if plan is None:
        fn, items = planner()
        built = _build_plan(wex, job, idx, fn, items, term=term)
        plan = jobs.commit_records(wex.kv, {jobs.stage_key(job, idx): built})[
            jobs.stage_key(job, idx)
        ]
    outputs = _run_planned(wex, plan, timeout_s=timeout_s)
    return _stage_barrier(wex, job, idx, plan, outputs, term=term)


def _intermediate_meta(wex: WrenExecutor, store: Union[ObjectStore, KVStore]) -> Any:
    """How the manifest records which store holds the shuffle intermediates:
    the driver's own store (portable by construction), a file-backed
    handle's reconnect spec (its directory root is the endpoint), or None
    for an opaque in-memory handle — adoptable only with an explicit
    ``intermediate=`` from the adopter."""
    if store is wex.store:
        return "driver-store"
    return store._endpoint_spec()


def _resolve_intermediate(
    wex: WrenExecutor, spec: Any
) -> Union[ObjectStore, KVStore]:
    if spec == "driver-store":
        return wex.store
    if spec is None:
        raise RuntimeError(
            "this job's shuffle intermediate store is in-memory (the "
            "manifest carries no reconnect spec); pass intermediate= to "
            "adopt_job, or use a FileBackend/FileKVStore-backed handle"
        )
    from repro_torch.storage.object_store import _reconnect

    return _reconnect(spec)


# ---------------------------------------------------------------------------
# run_stage: one superstep, manifest-backed
# ---------------------------------------------------------------------------

def run_stage(
    wex: WrenExecutor,
    fn: Callable[[Any], Any],
    items: Sequence[Any],
    *,
    timeout_s: float = 300.0,
    job_id: Optional[str] = None,
    gc: bool = False,
) -> List[Any]:
    """One BSP superstep: map + barrier, as a single-stage manifest job.
    The manifest and the stage plan land in ONE first-writer-wins commit,
    so an adopter never observes a manifest whose stage it cannot rebuild.
    Re-entrant: calling again with the same ``job_id`` (same process or
    not) resumes rather than resubmits — a recorded barrier returns the
    stored outputs with no task traffic at all.  ``gc=True`` frees the
    superstep's scheduler/storage state (manifest included) once its
    results are in hand."""
    job = job_id or f"stage-{uuid.uuid4().hex[:8]}"
    term = _register(wex, job)
    try:
        manifest = jobs.read_manifest(wex.kv, job, worker="driver")
        if manifest is None:
            plan = _build_plan(wex, job, 0, fn, items, term=term, stage_job=job)
            stored = jobs.commit_records(
                wex.kv,
                {
                    jobs.manifest_key(job): {
                        "job": job,
                        "kind": "stage",
                        "meta": {"n_items": len(plan["input_keys"]), "gc": bool(gc)},
                        "term": term,
                    },
                    jobs.stage_key(job, 0): plan,
                },
            )
            manifest = stored[jobs.manifest_key(job)]
        # The caller's gc flag governs THIS call (a re-entrant caller may
        # keep the job around on one call and retire it on the next); the
        # manifest's recorded flag is the adopter's default.
        return _replay_stage_job(
            wex, job, manifest["meta"], term, timeout_s=timeout_s, gc=bool(gc)
        )
    except BaseException:
        wex.release_driver(job)  # errored out: let an adopter take over now
        raise


def _replay_stage_job(
    wex: WrenExecutor,
    job: str,
    meta: dict,
    term: int,
    *,
    timeout_s: float,
    gc: Optional[bool] = None,
) -> List[Any]:
    done = jobs.read_barrier(wex.kv, job, 0, worker="driver")
    if done is not None:
        out = done["outputs"]
    else:
        plan = jobs.read_stage(wex.kv, job, 0, worker="driver")
        if plan is None:
            raise RuntimeError(
                f"job {job!r}: manifest present but stage 0 unplanned — "
                "run_stage commits both atomically, so this manifest is "
                "corrupt"
            )
        out = _run_planned(wex, plan, timeout_s=timeout_s)
        out = _stage_barrier(wex, job, 0, plan, out, term=term, gc_stage=False)
    if meta.get("gc") if gc is None else gc:
        wex.finish_job(job)  # stage job == job: one GC drops manifest + state
    else:
        wex.release_driver(job)
    return out


# ---------------------------------------------------------------------------
# MapReduce (hash shuffle)
# ---------------------------------------------------------------------------

def _map_task(
    map_fn: Callable[[Any], List[Tuple[Any, Any]]],
    store: Union[ObjectStore, KVStore],
    job: str,
    num_reducers: int,
    arg: Tuple[int, Any],
) -> Dict[str, float]:
    map_id, part = arg
    pairs = map_fn(part)
    buckets = shf.hash_partition(pairs, num_reducers)
    shf.write_partitions(store, job, map_id, buckets, worker=f"map{map_id}")
    return {"emitted": float(len(pairs))}


def _mr_map_task(
    map_fn: Callable[[Any], List[Tuple[Any, Any]]],
    store: Union[ObjectStore, KVStore],
    job: str,
    num_reducers: int,
) -> Callable[[Tuple[int, Any]], Dict[str, float]]:
    return partial(_map_task, map_fn, store, job, num_reducers)


def _reduce_task(
    reduce_fn: Callable[[Any, List[Any]], Any],
    store: Union[ObjectStore, KVStore],
    job: str,
    n_maps: int,
    part_id: int,
) -> Dict[Any, Any]:
    pairs = shf.read_partition_column(
        store, job, n_maps, part_id, worker=f"red{part_id}"
    )
    grouped: Dict[Any, List[Any]] = defaultdict(list)
    for k, v in pairs:
        grouped[k].append(v)
    return {k: reduce_fn(k, vs) for k, vs in grouped.items()}


def _mr_reduce_task(
    reduce_fn: Callable[[Any, List[Any]], Any],
    store: Union[ObjectStore, KVStore],
    job: str,
    n_maps: int,
) -> Callable[[int], Dict[Any, Any]]:
    return partial(_reduce_task, reduce_fn, store, job, n_maps)


def mapreduce(
    wex: WrenExecutor,
    map_fn: Callable[[Any], List[Tuple[Any, Any]]],
    reduce_fn: Callable[[Any, List[Any]], Any],
    partitions: Sequence[Any],
    num_reducers: int,
    intermediate: Union[ObjectStore, KVStore, None] = None,
    *,
    timeout_s: float = 300.0,
    job_id: Optional[str] = None,
) -> Dict[Any, Any]:
    """Classic MR: map_fn emits (k, v) pairs; reduce_fn folds values per key.
    Both must pickle by reference (module-level functions or partials of
    them): the runtime ships them with the standard ``pickle``.

    Manifest-backed and re-entrant: the manifest (with the reduce function
    registered content-addressed and the shuffle/GC plan in ``meta``) and
    the map-stage plan commit in one first-writer-wins batch before any
    task is submitted.  A driver killed mid-shuffle is resumed by
    ``adopt_job`` from the last recorded barrier; the submitting process
    itself can also re-call with the same ``job_id`` to resume."""
    store = intermediate if intermediate is not None else wex.store
    job = job_id or f"mr-{uuid.uuid4().hex[:8]}"
    term = _register(wex, job)
    try:
        manifest = jobs.read_manifest(wex.kv, job, worker="driver")
        if manifest is None:
            reduce_func = FunctionSpec.register(wex.store, reduce_fn, worker="driver")
            plan0 = _build_plan(
                wex,
                job,
                0,
                _mr_map_task(map_fn, store, job, num_reducers),
                list(enumerate(partitions)),
                term=term,
            )
            meta = {
                "n_maps": len(partitions),
                "num_reducers": int(num_reducers),
                "reduce_fn_key": reduce_func.key,
                "reduce_fn_name": reduce_func.name,
                "intermediate": _intermediate_meta(wex, store),
            }
            stored = jobs.commit_records(
                wex.kv,
                {
                    jobs.manifest_key(job): {
                        "job": job,
                        "kind": "mapreduce",
                        "meta": meta,
                        "term": term,
                    },
                    jobs.stage_key(job, 0): plan0,
                },
            )
            manifest = stored[jobs.manifest_key(job)]
        return _replay_mapreduce(
            wex,
            job,
            manifest["meta"],
            term,
            store=store,
            reduce_fn=reduce_fn,
            timeout_s=timeout_s,
        )
    except BaseException:
        wex.release_driver(job)
        raise


def _replay_mapreduce(
    wex: WrenExecutor,
    job: str,
    meta: dict,
    term: int,
    *,
    store: Union[ObjectStore, KVStore, None] = None,
    reduce_fn: Optional[Callable[[Any, List[Any]], Any]] = None,
    timeout_s: float = 300.0,
) -> Dict[Any, Any]:
    """Replay a mapreduce manifest to completion (detect/fence already done
    by the caller).  An adopter reconstructs the reduce closure from the
    manifest's registered function key; the submitting driver passes its
    live ``reduce_fn`` and skips the load.  Either way the committed stage
    plan — not the locally built closure — is what names the tasks, so
    racing drivers converge on one task set."""
    if store is None:
        store = _resolve_intermediate(wex, meta.get("intermediate"))
    n_maps = int(meta["n_maps"])
    num_reducers = int(meta["num_reducers"])

    def _plan_map() -> Tuple[Callable[[Any], Any], Sequence[Any]]:
        raise RuntimeError(
            f"job {job!r}: map stage unplanned — mapreduce commits the map "
            "plan with the manifest, so this manifest is corrupt"
        )

    def _plan_reduce() -> Tuple[Callable[[Any], Any], Sequence[Any]]:
        rf = reduce_fn
        if rf is None:
            rf = FunctionSpec(
                key=meta["reduce_fn_key"], name=meta["reduce_fn_name"]
            ).load(wex.store, worker="driver")
        return _mr_reduce_task(rf, store, job, n_maps), list(range(num_reducers))

    _replay_stage(wex, job, 0, _plan_map, term=term, timeout_s=timeout_s)
    red_out = _replay_stage(wex, job, 1, _plan_reduce, term=term, timeout_s=timeout_s)
    # Shuffle-intermediate GC (the manifest's GC plan, re-derived from
    # meta): the reduce barrier has consumed every shuffle/{job} object, so
    # retire the whole column space in one batched delete — intermediates
    # must not outlive the job.
    shf.delete_intermediates(store, job, n_maps, num_reducers, worker="driver")
    merged: Dict[Any, Any] = {}
    for d in red_out:
        merged.update(d)
    # Terminal GC: tombstone the job and drop its manifest keyspace (the
    # per-stage scheduler state went at each barrier; finish_job on the
    # stage jobs is idempotent and covers a crash between barrier and GC).
    wex.finish_job(f"{job}/s0")
    wex.finish_job(f"{job}/s1")
    wex.finish_job(job)
    return merged


def _wc_map(doc: Sequence[str]) -> List[Tuple[str, int]]:
    counts: Dict[str, int] = defaultdict(int)
    for line in doc:
        for w in line.split():
            counts[w] += 1
    return list(counts.items())


def _wc_reduce(_k: str, vs: List[int]) -> int:
    return int(sum(vs))


def word_count(
    wex: WrenExecutor,
    documents: Sequence[Sequence[str]],
    num_reducers: int,
    intermediate: Union[ObjectStore, KVStore, None] = None,
) -> Dict[str, int]:
    """The paper's word-count job (83.68M reviews / 333 partitions there)."""
    return mapreduce(wex, _wc_map, _wc_reduce, documents, num_reducers, intermediate)


# ---------------------------------------------------------------------------
# Terasort (range shuffle) — paper §3.3 Daytona sort
# ---------------------------------------------------------------------------

@dataclass
class SortReport:
    n_records: int = 0
    n_intermediate_objects: int = 0
    splitters: int = 0
    phase_vtime: Dict[str, float] = field(default_factory=dict)
    hottest_shard_vtime: float = 0.0


def _sample_task(store: ObjectStore, sample_per_task: int, key: str) -> List[bytes]:
    recs: np.ndarray = store.get(key, worker="sampler")
    idx = np.linspace(0, len(recs) - 1, min(sample_per_task, len(recs))).astype(int)
    return [shf.record_sort_key(recs[i]) for i in idx]


def _sort_sample_task(
    store: ObjectStore, sample_per_task: int
) -> Callable[[str], List[bytes]]:
    return partial(_sample_task, store, sample_per_task)


def _partition_task(
    store: ObjectStore,
    intermediate: Union[ObjectStore, KVStore],
    job: str,
    splitters: List[bytes],
    arg: Tuple[int, str],
) -> Dict[str, Any]:
    map_id, key = arg
    recs: np.ndarray = store.get(key, worker=f"part{map_id}")
    parts = shf.range_partition(list(recs), splitters, key=shf.record_sort_key)
    n_objs = shf.write_partitions(
        intermediate, job, map_id, parts, worker=f"part{map_id}"
    )
    return {"records": len(recs), "objects": n_objs}


def _sort_partition_task(
    store: ObjectStore,
    intermediate: Union[ObjectStore, KVStore],
    job: str,
    splitters: List[bytes],
) -> Callable[[Tuple[int, str]], Dict[str, Any]]:
    return partial(_partition_task, store, intermediate, job, splitters)


def _merge_task(
    store: ObjectStore,
    intermediate: Union[ObjectStore, KVStore],
    job: str,
    n_maps: int,
    output_prefix: str,
    part_id: int,
) -> int:
    chunk = shf.read_partition_column(
        intermediate, job, n_maps, part_id, worker=f"merge{part_id}"
    )
    chunk.sort(key=shf.record_sort_key)
    out = np.stack(chunk) if chunk else np.zeros((0, 100), np.uint8)
    store.put(f"{output_prefix}/part{part_id:06d}", out, worker=f"merge{part_id}")
    return len(chunk)


def _sort_merge_task(
    store: ObjectStore,
    intermediate: Union[ObjectStore, KVStore],
    job: str,
    n_maps: int,
    output_prefix: str,
) -> Callable[[int], int]:
    return partial(_merge_task, store, intermediate, job, n_maps, output_prefix)


def terasort(
    wex: WrenExecutor,
    input_keys: List[str],
    output_prefix: str,
    num_partitions: int,
    intermediate: Union[ObjectStore, KVStore],
    *,
    sample_per_task: int = 64,
    timeout_s: float = 600.0,
    job_id: Optional[str] = None,
) -> SortReport:
    """Two-stage sort: partition (range-partition + write intermediates) then
    merge (read column, merge-sort, write output).  Input/output live in the
    main object store (S3); intermediates in ``intermediate`` — the paper
    moved these to Redis because S3's request throughput collapsed under
    n_tasks² objects.

    Manifest-backed: every stage is re-derivable from ``meta`` alone (the
    splitters come out of the recorded sample barrier), so an adopter needs
    no state from the dead driver — not even a registered user function."""
    job = job_id or f"sort-{uuid.uuid4().hex[:8]}"
    term = _register(wex, job)
    try:
        manifest = jobs.read_manifest(wex.kv, job, worker="driver")
        if manifest is None:
            meta = {
                "input_keys": list(input_keys),
                "output_prefix": output_prefix,
                "num_partitions": int(num_partitions),
                "sample_per_task": int(sample_per_task),
                "intermediate": _intermediate_meta(wex, intermediate),
            }
            stored = jobs.commit_records(
                wex.kv,
                {
                    jobs.manifest_key(job): {
                        "job": job,
                        "kind": "terasort",
                        "meta": meta,
                        "term": term,
                    }
                },
            )
            manifest = stored[jobs.manifest_key(job)]
        return _replay_terasort(
            wex,
            job,
            manifest["meta"],
            term,
            intermediate=intermediate,
            timeout_s=timeout_s,
        )
    except BaseException:
        wex.release_driver(job)
        raise


def _replay_terasort(
    wex: WrenExecutor,
    job: str,
    meta: dict,
    term: int,
    *,
    intermediate: Union[ObjectStore, KVStore, None] = None,
    timeout_s: float = 600.0,
) -> SortReport:
    store = wex.store
    if intermediate is None:
        intermediate = _resolve_intermediate(wex, meta.get("intermediate"))
    input_keys = list(meta["input_keys"])
    output_prefix = meta["output_prefix"]
    num_partitions = int(meta["num_partitions"])
    sample_per_task = int(meta["sample_per_task"])
    n_maps = len(input_keys)
    report = SortReport()

    # --- stage 0: sample for splitters (TeraSort sampler) -----------------
    def _plan_sample() -> Tuple[Callable[[Any], Any], Sequence[Any]]:
        return _sort_sample_task(store, sample_per_task), list(input_keys)

    samples = _replay_stage(wex, job, 0, _plan_sample, term=term, timeout_s=timeout_s)
    flat = [s for chunk in samples for s in chunk]
    # Deterministic given the recorded sample barrier: every driver derives
    # the same splitters, hence the same partition-stage plan.
    splitters = shf.sample_splitters(flat, num_partitions)
    report.splitters = len(splitters)

    # --- stage 1: partition -------------------------------------------------
    def _plan_partition() -> Tuple[Callable[[Any], Any], Sequence[Any]]:
        return (
            _sort_partition_task(store, intermediate, job, splitters),
            list(enumerate(input_keys)),
        )

    part_out = _replay_stage(wex, job, 1, _plan_partition, term=term, timeout_s=timeout_s)
    report.n_records = int(sum(o["records"] for o in part_out))
    report.n_intermediate_objects = int(sum(o["objects"] for o in part_out))

    # --- stage 2: merge ------------------------------------------------------
    def _plan_merge() -> Tuple[Callable[[Any], Any], Sequence[Any]]:
        return (
            _sort_merge_task(store, intermediate, job, n_maps, output_prefix),
            list(range(num_partitions)),
        )

    merged_counts = _replay_stage(wex, job, 2, _plan_merge, term=term, timeout_s=timeout_s)
    assert sum(merged_counts) == report.n_records, "sort lost records"
    # Shuffle-intermediate GC (the manifest's GC plan): merge consumed every
    # intermediate column; drop shuffle/{job} in one batched delete.
    shf.delete_intermediates(
        intermediate, job, n_maps, num_partitions, worker="driver"
    )

    # --- phase accounting (Fig 6) -------------------------------------------
    per_worker = store.ledger.per_worker()
    phases: Dict[str, float] = defaultdict(float)
    for w, ops in per_worker.items():
        for op, (nbytes, vt) in ops.items():
            if w.startswith("part"):
                phases[f"partition_{op}"] += vt
            elif w.startswith("merge"):
                phases[f"merge_{op}"] += vt
    if isinstance(intermediate, KVStore):
        report.hottest_shard_vtime = intermediate.hottest_shard_vtime()
        for i, st in enumerate(intermediate.shard_stats()):
            phases[f"kv_shard{i}"] += st.vtime_s
    report.phase_vtime = dict(phases)
    for idx in range(3):
        wex.finish_job(f"{job}/s{idx}")
    wex.finish_job(job)
    return report


# ---------------------------------------------------------------------------
# adoption: the driver-failover entry point
# ---------------------------------------------------------------------------

def adopt_job(
    wex: WrenExecutor,
    job_id: str,
    *,
    wait_timeout_s: Optional[float] = None,
    timeout_s: float = 600.0,
    intermediate: Union[ObjectStore, KVStore, None] = None,
) -> Any:
    """Adopt and finish another driver's job (the protocol of
    ``core/jobs.py``): **detect** — block on the driver lease's shard watch
    until it is absent, released, or past its expiry; **fence** — take the
    lease at ``term + 1``, so the dead driver's in-flight heartbeats fail;
    **replay** — re-run the manifest, skipping recorded barriers and
    resubmitting only tasks without results; **barrier** — each finished
    stage commits its record before its state is GC'd.

    Returns exactly what the original submitting call would have returned
    (``mapreduce``'s merged dict, ``terasort``'s ``SortReport``,
    ``run_stage``'s output list), or ``None`` if the job already finished
    and was GC'd.  Raises ``TimeoutError`` if ``wait_timeout_s`` elapses
    with the original driver still heartbeating.  ``intermediate`` is only
    needed when the job's shuffle store was an in-memory handle the
    manifest cannot describe."""
    if not jobs.wait_for_driver_expiry(wex.kv, job_id, wait_timeout_s, worker="driver"):
        raise TimeoutError(
            f"driver of job {job_id!r} still heartbeating after {wait_timeout_s}s"
        )
    if jobs.job_finished(wex.kv, job_id, worker="driver"):
        return None  # finished and GC'd: nothing left to adopt
    term = _register(wex, job_id)
    try:
        manifest = jobs.read_manifest(wex.kv, job_id, worker="driver")
        if manifest is None:
            # finish_job raced us between the tombstone probe and the
            # takeover; re-finish to scrub the driver record the takeover
            # re-created (idempotent behind the existing tombstone).
            wex.finish_job(job_id)
            return None
        kind, meta = manifest["kind"], manifest["meta"]
        if kind == "mapreduce":
            return _replay_mapreduce(
                wex, job_id, meta, term, store=intermediate, timeout_s=timeout_s
            )
        if kind == "terasort":
            return _replay_terasort(
                wex, job_id, meta, term, intermediate=intermediate, timeout_s=timeout_s
            )
        if kind == "stage":
            return _replay_stage_job(wex, job_id, meta, term, timeout_s=timeout_s)
        raise ValueError(f"unknown manifest kind {kind!r} for job {job_id!r}")
    except BaseException:
        wex.release_driver(job_id)
        raise


def verify_sorted(store: ObjectStore, output_prefix: str) -> bool:
    """Global order check across output partitions."""
    prev_last: Optional[bytes] = None
    part_keys = store.list(output_prefix)
    parts = store.get_many(part_keys, missing="error")
    for key in part_keys:
        recs: np.ndarray = parts[key]
        if len(recs) == 0:
            continue
        sort_keys = [shf.record_sort_key(r) for r in recs]
        if sort_keys != sorted(sort_keys):
            return False
        if prev_last is not None and sort_keys[0] < prev_last:
            return False
        prev_last = sort_keys[-1]
    return True
