"""PyTorch/CUDA port of the `repro` compute layer, for one NVIDIA H100.

Mirrors the JAX package's module layout (`configs/`, `kernels/`, `models/`,
`storage/`, `serve/`, `launch/`) so each module's counterpart is easy to
find.  It imports `torch`, numpy and the standard library only — never
`jax`, never `repro` — and keeps its own copies of the framework-free
modules it needs.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a GPU raises (see :func:`resolve_device`).

Importing the package sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless the
environment already names one: the elastic trainer's chunks run under
``torch.use_deterministic_algorithms(True)``, which on CUDA needs that
workspace configuration, and PyTorch reads it once, before the process's
first cuBLAS call.  It does not import torch itself: the storage plane,
the runtime (`core/`) and the request plane load without it, so a
``repro-kvd`` daemon or a BSP worker process starts in a fraction of a
second.
"""

from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """The device an entry point runs on: ``cuda`` by default.

    Raises instead of quietly falling back to the CPU when CUDA is asked
    for and no GPU is present."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the plain versions"
        )
    return dev


__all__ = ["resolve_device"]
