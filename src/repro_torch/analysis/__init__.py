"""Analysis tooling: roofline modeling, the ``reprolint`` invariant
checker, and the runtime sanitizer (twins of the JAX package's
``repro.analysis``), with the sanitizer's pytest plugin.

``lint`` and ``sanitizer`` are imported lazily (via ``__getattr__``), as in
the JAX package, so importing :mod:`repro_torch.analysis` for roofline work
never pays for them, and vice versa.
"""

from . import roofline

__all__ = ["roofline", "lint", "sanitizer"]


def __getattr__(name: str):
    if name in ("lint", "sanitizer"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
