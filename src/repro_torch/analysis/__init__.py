"""Analysis tooling: the ``reprolint`` invariant checker and the runtime
sanitizer (copies of the JAX package's ``repro.analysis.lint`` and
``repro.analysis.sanitizer``), with the sanitizer's pytest plugin.

``lint`` and ``sanitizer`` are imported lazily (via ``__getattr__``), as in
the JAX package.  The JAX package's ``analysis`` also holds the roofline
model and the report, which it imports eagerly; the port has no twin of
them yet, so this package leaves them out.
"""

__all__ = ["lint", "sanitizer"]


def __getattr__(name: str):
    if name in ("lint", "sanitizer"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
