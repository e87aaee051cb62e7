"""Continuous batching: a persistent slot-based decode batch (port of
`repro.serve.continuous`).

The engine owns ONE cache of `max_batch` slots for its whole life.  Every
iteration runs a single one-token decode step over all slots -- live or
not -- with a per-slot `cache_len` vector (the decode kernel masks each
row at its own length).  Finished rows are evicted immediately; freed
slots are refilled at chunk boundaries by an interleaved prefill
microbatch: new prompts, right-padded to a bucket (grouped by exact
length for the recurrent hybrid and xLSTM families; the MoE family keeps
the buckets, whose pad tokens take expert capacity exactly as in the JAX
engine), prefill into a fresh
small cache whose rows replace the slots' rows of the persistent one
(`cache_update.insert_rows`: a new occupant never reads its predecessor's
KV).  The running batch never drains.

`ContinuousEngine.run` plugs the slots into the lease-driven request plane
(`serve.request_plane`): lease -> admit -> decode chunk -> stream ->
publish, with heartbeats and expired-lease reaping on the chunk cadence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import cache_batch_axes, decode_step, init_cache, prefill
from repro_torch.models.cache_update import insert_rows
from repro_torch.util import tree_flatten

from . import request_plane as rp
from .engine import CACHE_DTYPES, ServeConfig, sample_tokens


@dataclass
class Slot:
    req_id: str
    prompt_len: int
    max_new: int
    out: List[int] = field(default_factory=list)  # sampled tokens so far
    streamed: int = 0  # tokens already pushed to serve/stream/{req}
    done: bool = False
    t_admit: float = 0.0
    t_first: float = 0.0  # wall time of the first sampled token (TTFT)


class ContinuousEngine:
    """Slot-based continuous-batching engine over one persistent cache."""

    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig, *, device=None) -> None:
        if cfg.family == "encdec":
            raise NotImplementedError("encdec serving needs encoder inputs per request")
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = resolve_device(device)
        self._dtype = CACHE_DTYPES[scfg.cache_dtype]
        self._axes = tree_flatten(cache_batch_axes(cfg))[0]
        # recurrent-state families carry prompt state, not a masked KV
        # buffer: right-pad tokens would corrupt the state, so prefill
        # microbatches group by *exact* prompt length instead of buckets
        self._exact_len = cfg.family in ("ssm", "hybrid")

        B = scfg.max_batch
        self.cache = init_cache(cfg, B, scfg.max_len, self._dtype, self.device)
        self.cache_lens = np.zeros((B,), np.int32)
        self.tokens = np.zeros((B,), np.int64)  # next token fed per slot
        self.steps = np.zeros((B,), np.int64)  # per-request sample index
        self.seeds = np.zeros((B,), np.int64)  # per-request sampling seeds
        self.slots: List[Optional[Slot]] = [None] * B
        self.stats: Dict[str, int] = {
            "served": 0,
            "tokens_out": 0,
            "admissions": 0,
            "mid_batch_admissions": 0,
            "prefill_groups": 0,
            "decode_steps": 0,
        }
        # called with each prefill group's request ids, in row order: a
        # bf16 prefill's bits depend on the group's size (the GEMMs' M), so
        # a caller comparing two runs' tokens needs each request's group
        self.on_prefill: Optional[Callable[[List[str]], None]] = None

    # ---- slot bookkeeping ------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def n_live(self) -> int:
        return sum(s is not None for s in self.slots)

    def live_req_ids(self) -> List[str]:
        return [s.req_id for s in self.slots if s is not None]

    def _evict(self, i: int) -> None:
        self.slots[i] = None
        self.cache_lens[i] = 0
        self.tokens[i] = 0
        self.steps[i] = 0
        self.seeds[i] = 0

    def _seeds(self, seeds) -> Optional[Sequence[int]]:
        return seeds if self.scfg.temperature > 0 else None

    # ---- admission: interleaved prefill microbatch -----------------------

    def _pad_len(self, plen: int) -> int:
        if self._exact_len:
            return plen
        b = max(1, self.scfg.prefill_bucket)
        return min(-(-plen // b) * b, self.scfg.max_len - 1)

    @torch.no_grad()
    def admit(self, requests: Sequence[Tuple[str, Sequence[int], int]]) -> int:
        """Admit requests into free slots: [(req_id, prompt, max_new), ...].

        Runs at chunk boundaries while other slots hold live decodes; their
        rows of the persistent cache are not written.  Each admitted slot
        samples its first token from the prefill logits at its own last
        prompt position (right-padding is invisible under causal
        attention).  Returns the number admitted."""
        free = self.free_slots()
        if len(requests) > len(free):
            raise ValueError(f"admit {len(requests)} > {len(free)} free slots")
        if not requests:
            return 0
        was_live = self.n_live() > 0
        scfg = self.scfg
        groups: Dict[int, List[Tuple[str, List[int], int]]] = {}
        for req_id, prompt, max_new in requests:
            prompt = list(prompt)[: scfg.max_len - 1]  # leave room to decode
            groups.setdefault(self._pad_len(len(prompt)), []).append((req_id, prompt, max_new))
        for Lpad, group in groups.items():
            n = len(group)
            toks = np.zeros((n, Lpad), np.int64)
            lens = np.zeros((n,), np.int64)
            for j, (_, prompt, _) in enumerate(group):
                toks[j, : len(prompt)] = prompt
                lens[j] = len(prompt)
            small = init_cache(self.cfg, n, scfg.max_len, self._dtype, self.device)
            logits_all, small, _ = prefill(
                self.params, self.cfg,
                {"tokens": torch.from_numpy(toks).to(self.device)}, small, all_logits=True,
            )
            # each row's logits at its own last true token
            last = logits_all[
                torch.arange(n, device=self.device), torch.from_numpy(lens - 1).to(self.device)
            ]
            slot_ids = [free.pop(0) for _ in group]
            slots_t = torch.tensor(slot_ids, device=self.device)
            big_leaves = tree_flatten(self.cache)[0]
            for big, sm, ax in zip(big_leaves, tree_flatten(small)[0], self._axes):
                insert_rows(big, sm, slots_t, ax)
            gseeds = [rp.request_seed(r) for r, _, _ in group]
            tok0 = sample_tokens(last, self._seeds(gseeds), 0, scfg.temperature).cpu().numpy()
            now = time.time()
            for j, (req_id, prompt, max_new) in enumerate(group):
                i = slot_ids[j]
                s = Slot(req_id, len(prompt), max_new, t_admit=now, t_first=now)
                s.out.append(int(tok0[j]))
                if len(s.out) >= max_new or (scfg.eos_id >= 0 and s.out[-1] == scfg.eos_id):
                    s.done = True
                self.slots[i] = s
                self.cache_lens[i] = lens[j]
                self.tokens[i] = tok0[j]
                self.steps[i] = 1
                self.seeds[i] = gseeds[j]
            self.stats["prefill_groups"] += 1
            if self.on_prefill is not None:
                self.on_prefill([req_id for req_id, _, _ in group])
        self.stats["admissions"] += len(requests)
        if was_live:
            self.stats["mid_batch_admissions"] += len(requests)
        return len(requests)

    # ---- the decode chunk ------------------------------------------------

    @torch.no_grad()
    def step_chunk(
        self, n_steps: Optional[int] = None
    ) -> Tuple[Dict[str, Slot], Dict[str, Tuple[int, List[int]]]]:
        """Run up to `n_steps` decode iterations over all slots.

        Returns (finished, chunks): finished maps req_id -> its Slot
        (evicted, `out` complete); chunks maps req_id -> (offset, new
        tokens since the last stream push) for every slot that progressed."""
        scfg = self.scfg
        n_steps = scfg.decode_chunk if n_steps is None else n_steps
        finished: Dict[str, Slot] = {}
        touched: List[Slot] = []

        def _finish(i: int, s: Slot) -> None:
            finished[s.req_id] = s
            self.stats["served"] += 1
            self.stats["tokens_out"] += len(s.out)
            self._evict(i)

        # slots completed at admission (max_new==1 / instant eos)
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                touched.append(s)
                _finish(i, s)

        for _ in range(n_steps):
            live = [i for i, s in enumerate(self.slots) if s is not None]
            if not live:
                break
            logits, self.cache = decode_step(
                self.params, self.cfg,
                torch.from_numpy(self.tokens[:, None]).to(self.device),
                self.cache,
                torch.from_numpy(self.cache_lens).to(self.device),
            )
            self.stats["decode_steps"] += 1
            toks = sample_tokens(
                logits[:, 0], self._seeds(self.seeds), self.steps, scfg.temperature
            ).cpu().numpy()
            for i in live:
                s = self.slots[i]
                self.cache_lens[i] += 1  # the fed token now resides in the cache
                t = int(toks[i])
                s.out.append(t)
                self.steps[i] += 1
                self.tokens[i] = t
                if s not in touched:
                    touched.append(s)
                if (
                    len(s.out) >= s.max_new
                    or (scfg.eos_id >= 0 and t == scfg.eos_id)
                    or self.cache_lens[i] >= scfg.max_len - 1
                ):
                    _finish(i, s)

        chunks: Dict[str, Tuple[int, List[int]]] = {}
        for s in touched:
            new = s.out[s.streamed:]
            if new:
                chunks[s.req_id] = (s.streamed, new)
                s.streamed = len(s.out)
        return finished, chunks

    # ---- request-plane loop ----------------------------------------------

    def run(
        self,
        store,
        kv,
        *,
        engine_id: str = "engine-0",
        idle_timeout_s: float = 2.0,
        max_requests: Optional[int] = None,
        reap: bool = True,
    ) -> Dict[str, int]:
        """Serve until the queue stays empty for `idle_timeout_s` (or
        `max_requests` have been served).  An idle engine parks in `blpop`
        on its home queue shard and is pushed awake by a submit."""
        scfg = self.scfg
        last_beat = 0.0
        last_reap = 0.0
        idle_deadline = time.monotonic() + idle_timeout_s
        while True:
            if max_requests is not None and self.stats["served"] >= max_requests:
                break
            now = time.time()
            if reap and now - last_reap >= scfg.lease_timeout_s:
                rp.reap_expired(store, kv, n_queues=scfg.n_queues, worker=engine_id)
                last_reap = now
            free = self.free_slots()
            if free:
                wait_s = 0.0
                if self.n_live() == 0:
                    wait_s = max(0.0, min(0.5, idle_deadline - time.monotonic()))
                leased = rp.lease_requests(
                    store, kv, engine_id, len(free),
                    lease_timeout_s=scfg.lease_timeout_s,
                    wait_s=wait_s,
                    n_queues=scfg.n_queues,
                )
                if leased:
                    self.admit([
                        (r, body["prompt"], int(body.get("max_new", scfg.max_new_tokens)))
                        for r, body in leased
                    ])
            if self.n_live() == 0:
                if time.monotonic() >= idle_deadline:
                    break
                continue  # the blpop above is the idle wait
            idle_deadline = time.monotonic() + idle_timeout_s

            finished, chunks = self.step_chunk()
            rp.stream_chunks(kv, chunks, worker=engine_id)
            if finished:
                t_done = time.time()
                rp.publish_results(
                    store, kv, engine_id,
                    {
                        r: {"tokens": s.out, "t_first": s.t_first, "t_done": t_done}
                        for r, s in finished.items()
                    },
                )
            now = time.time()
            if now - last_beat >= scfg.heartbeat_interval_s:
                rp.heartbeat_leases(
                    kv, engine_id, self.live_req_ids(), lease_timeout_s=scfg.lease_timeout_s
                )
                last_beat = now
        return dict(self.stats)
