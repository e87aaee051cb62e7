"""Serving substrate, PyTorch port: batched engine, continuous batching,
request plane."""

from . import request_plane
from .continuous import ContinuousEngine, Slot
from .engine import Engine, ServeConfig, sample_tokens, serve_pending, submit_request

__all__ = [
    "ContinuousEngine",
    "Engine",
    "ServeConfig",
    "Slot",
    "request_plane",
    "sample_tokens",
    "serve_pending",
    "submit_request",
]
