"""Deterministic data pipeline (stateless-training contract), port of
`repro.data`."""

from .pipeline import DataConfig, make_documents, shard_corpus, synthetic_batch, tokenize_line

__all__ = ["DataConfig", "synthetic_batch", "make_documents", "shard_corpus", "tokenize_line"]
