"""Deterministic data pipeline (port of `repro.data.pipeline`).

Training batches must be a pure function of the step index for the
stateless training contract to hold (idempotent re-execution).  The JAX
package draws from threefry keys, which torch cannot reproduce; this draws
from numpy's counter-based ``Philox`` generator keyed by ``(seed, step)``,
with the same structure (so the batches differ from JAX's; parity tests
feed the JAX batch).

Also provides the text-corpus utilities of the benchmarks and examples,
copied as they are: `make_documents`, `shard_corpus`, `tokenize_line`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.storage import ObjectStore


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2  # skew of the synthetic token distribution


def synthetic_batch(dcfg: DataConfig, step: int,
                    cfg: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """Pure function of (config, step): (tokens, labels) + modality stubs,
    CPU tensors.

    Tokens follow a noisy affine Markov chain -- next = (31*cur + 17) mod V
    with probability 0.85, else a zipf-skewed draw ``u**zipf_a * V`` with u
    in [1e-6, 1) -- so there is learnable sequence structure at any vocab
    size.  Labels are the tokens shifted by one.  ``prefix_embed`` (vlm)
    and ``audio_frames`` (encdec) are normal draws x 0.02."""
    rng = np.random.Generator(np.random.Philox(key=[dcfg.seed, step]))
    B, S, V = dcfg.global_batch, dcfg.seq_len, dcfg.vocab_size
    u = rng.uniform(1e-6, 1.0, size=(B, S + 1))
    rand_toks = np.minimum((u**dcfg.zipf_a * V).astype(np.int64), V - 1)
    keep = rng.uniform(size=(B, S + 1)) < 0.85
    x = rng.integers(0, V, size=(B,))
    seq = np.empty((B, S + 1), dtype=np.int64)
    for t in range(S + 1):
        x = np.where(keep[:, t], (31 * x + 17) % V, rand_toks[:, t])
        seq[:, t] = x
    tokens_all = torch.from_numpy(seq.astype(np.int32))
    batch: Dict[str, torch.Tensor] = {
        "tokens": tokens_all[:, :S],
        "labels": tokens_all[:, 1:],
    }
    if cfg is not None and cfg.frontend == "vision_stub":
        pe = rng.standard_normal((B, cfg.num_prefix_tokens, cfg.d_model), dtype=np.float32)
        batch["prefix_embed"] = torch.from_numpy(pe * np.float32(0.02))
    if cfg is not None and cfg.family == "encdec":
        af = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        batch["audio_frames"] = torch.from_numpy(af * np.float32(0.02))
    return batch


# ---------------------------------------------------------------------------
# text corpus utilities (benchmarks / examples)
# ---------------------------------------------------------------------------

_WORDS = (
    "the quick brown fox jumps over lazy dog cloud lambda function stateless "
    "storage elastic server data process compute worker map reduce shuffle "
    "model train serve batch token layer attention expert state scan kernel"
).split()


def make_documents(n_docs: int, lines_per_doc: int, seed: int = 0) -> List[List[str]]:
    """The JAX package's documents for the same seed: ``rng.choice`` over
    the word list draws ``rng.integers(0, len(words), n)``, which is taken
    here directly (the same draws, without converting the list to an array
    at every line)."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        lines = []
        for _ in range(lines_per_doc):
            n = rng.integers(4, 12)
            lines.append(" ".join([_WORDS[i] for i in rng.integers(0, len(_WORDS), size=n)]))
        docs.append(lines)
    return docs


def shard_corpus(
    store: ObjectStore, prefix: str, docs: Sequence[List[str]]
) -> List[str]:
    # One batched write for the whole corpus: N document objects land in
    # one amortized round-trip instead of one modeled request each.
    items = {f"{prefix}/doc{i:06d}": list(doc) for i, doc in enumerate(docs)}
    store.put_many(items)
    return list(items.keys())


def tokenize_line(line: str, vocab_size: int) -> List[int]:
    """Stable hash tokenizer (featurization stand-in)."""
    return [
        int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little") % vocab_size
        for w in line.split()
    ]
