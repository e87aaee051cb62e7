"""Serving substrate, PyTorch port: batched engine, continuous batching,
request plane.  The engines (and torch) load on first use of their names:
the request plane imports neither, so a ``repro-kvd`` daemon running its
lease functions does not load torch."""

import importlib

from . import request_plane

_ENGINES = {
    "ContinuousEngine": "continuous", "Slot": "continuous", "Engine": "engine",
    "ServeConfig": "engine", "sample_tokens": "engine", "serve_pending": "engine",
    "submit_request": "engine",
}


def __getattr__(name):
    if name not in _ENGINES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_ENGINES[name]}", __name__), name)
    globals()[name] = value
    return value

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
