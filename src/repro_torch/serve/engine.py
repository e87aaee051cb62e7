"""Batched serving engine: prefill + decode with KV-cache management (port
of `repro.serve.engine`).

Requests flow through the object store (PyWren style): clients submit
prompts as objects; the engine serves a batch and publishes results
atomically, so a restart re-serves idempotently.

Sampling: greedy is argmax.  At temperature > 0 row i draws from a
`torch.Generator` seeded from (seeds[i], steps[i]): deterministic per
request, independent across requests and invariant to batch composition,
as in the JAX package -- but not threefry's numbers, so cross-framework
token parity holds for greedy decoding only.
"""

from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.storage import ObjectStore

CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 256
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    cache_dtype: str = "float32"
    eos_id: int = -1  # -1 = never stop early
    # ---- continuous batching / request plane (serve.continuous) ----
    decode_chunk: int = 8  # decode steps between admission boundaries
    prefill_bucket: int = 16  # right-pad prompts up to a multiple of this
    n_queues: int = 1  # request-queue shards (serve/q/{i})
    lease_timeout_s: float = 2.0
    heartbeat_interval_s: float = 0.5


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    seeds: Optional[Sequence[int]],  # per-request integer seeds
    steps: Union[int, Sequence[int]],  # scalar or (B,) per-request step index
    temperature: float,
) -> torch.Tensor:
    """(B,) int64 tokens; row i at temperature > 0 draws from a generator
    seeded from (seeds[i], steps[i]).  A row holding NaN gives its first
    NaN's index (0 for an all-NaN row), as ``jax.random.categorical``'s
    Gumbel argmax does; greedy ``argmax`` gives the same."""
    if temperature <= 0 or seeds is None:
        return torch.argmax(logits, dim=-1)
    B = logits.shape[0]
    steps = np.broadcast_to(np.asarray(steps, np.int64), (B,))
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    out = torch.empty((B,), dtype=torch.int64, device=logits.device)
    nan_rows = torch.isnan(logits).any(dim=-1).tolist()
    for i in range(B):
        if nan_rows[i]:
            out[i] = torch.argmax(logits[i])
            continue
        g = torch.Generator(device=logits.device)
        # the CPU generator keeps only 32 bits of its seed: hash both into them
        g.manual_seed(zlib.crc32(struct.pack("<qq", int(seeds[i]), int(steps[i]))))
        out[i] = torch.multinomial(probs[i], 1, generator=g)[0]
    return out


class Engine:
    def __init__(self, cfg: ModelConfig, params: Any, scfg: ServeConfig, *, device=None) -> None:
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = resolve_device(device)

    @torch.no_grad()
    def generate(
        self,
        prompts,
        extras: Optional[Dict[str, Any]] = None,
        *,
        seeds: Optional[List[int]] = None,
    ) -> np.ndarray:
        """prompts: (B, S) ints -> (B, max_new_tokens) int32.  ``extras``
        joins the batch (``audio_frames`` for whisper, ``prefix_embed`` for
        the vlm; numpy arrays or tensors, moved to the engine's device).
        ``seeds`` (one per row, e.g. `request_plane.request_seed(req_id)`)
        key sampling per request; default ``range(B)``."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
        B = prompts.shape[0]
        scfg = self.scfg
        batch = {"tokens": prompts}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)
        cache = init_cache(self.cfg, B, scfg.max_len, CACHE_DTYPES[scfg.cache_dtype], self.device)
        logits, cache, clen = prefill(self.params, self.cfg, batch, cache)
        seeds = list(range(B)) if seeds is None else seeds
        if scfg.temperature <= 0:
            seeds = None
        out = np.zeros((B, scfg.max_new_tokens), np.int32)
        done = np.zeros((B,), bool)
        tok = sample_tokens(logits[:, -1], seeds, 0, scfg.temperature)
        for t in range(scfg.max_new_tokens):
            tok_np = tok.cpu().numpy()
            out[:, t] = np.where(done, 0, tok_np)
            if scfg.eos_id >= 0:
                done |= tok_np == scfg.eos_id
                if done.all():
                    break
            logits, cache = decode_step(self.params, self.cfg, tok[:, None], cache, clen)
            clen += 1
            tok = sample_tokens(logits[:, 0], seeds, t + 1, scfg.temperature)
        return out


# ---------------------------------------------------------------------------
# storage-mediated request plane (the PyWren pattern)
# ---------------------------------------------------------------------------

def submit_request(store: ObjectStore, req_id: str, prompt: List[int]) -> str:
    key = f"serve/req/{req_id}"
    store.put(key, {"prompt": prompt, "ts": time.time()})
    return key


def serve_pending(
    store: ObjectStore, engine: Engine, *, batch_size: int = 8, worker: str = "engine"
) -> int:
    """Serve up to ``batch_size`` unserved requests (left-padded to one
    length) and publish the results first-writer-wins; one list, one
    ``exists_many``, one ``get_many`` and one ``put_many`` per batch.
    Returns the number served."""
    def _done_key(k: str) -> str:
        return k.replace("serve/req/", "serve/done/")

    all_reqs = store.list("serve/req/", worker=worker)
    served = store.exists_many([_done_key(k) for k in all_reqs], worker=worker)
    req_keys = [k for k in all_reqs if _done_key(k) not in served][:batch_size]
    if not req_keys:
        return 0
    got = store.get_many(req_keys, worker=worker, missing="error")
    reqs = [got[k] for k in req_keys]
    maxlen = max(len(r["prompt"]) for r in reqs)
    prompts = np.zeros((len(reqs), maxlen), np.int32)
    for i, r in enumerate(reqs):
        prompts[i, maxlen - len(r["prompt"]):] = r["prompt"]  # left-pad
    out = engine.generate(prompts)
    store.put_many(
        {_done_key(k): {"tokens": out[i].tolist()} for i, k in enumerate(req_keys)},
        worker=worker,
        if_absent=True,
    )
    return len(reqs)
